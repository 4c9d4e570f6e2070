"""Multi-chip sharded renderer tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu.data import Compressions, make_random_scene, pack_gaussians
from wgpu_3dgs_viewer_app_tpu.ops import (
    TileConfig,
    build_sorted_entries,
    composite_tiles_jnp_v2,
    over_background,
    preprocess,
)
from wgpu_3dgs_viewer_app_tpu.parallel import make_mesh, render_sharded, shard_pod


def setup(n=768, w=64, h=64):
    comp = Compressions()
    scene = make_random_scene(n, seed=0, extent=1.0, scale_range=(0.02, 0.08))
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view = jnp.asarray(cam.view())
    proj = jnp.asarray(cam.projection(w / h))
    return comp, pod, view, proj, TileConfig(w, h, tile=16, max_dup=8)


def single_device_reference(comp, pod, view, proj, cfg):
    pre = preprocess(pod, comp, view, proj, jnp.eye(4), cfg.width, cfg.height, sh_degree=3)
    entries = build_sorted_entries(pre, cfg)
    img = composite_tiles_jnp_v2(entries, cfg)
    return over_background(img, jnp.zeros(3))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device(n_dev):
    assert len(jax.devices()) >= n_dev, "conftest should provide 8 cpu devices"
    comp, pod, view, proj, cfg = setup()
    ref = np.asarray(single_device_reference(comp, pod, view, proj, cfg))
    mesh = make_mesh(jax.devices()[:n_dev])
    pod_sharded = shard_pod(pod, mesh)
    img = np.asarray(
        render_sharded(pod_sharded, mesh, comp, cfg, view, proj, sh_degree=3)
    )
    assert img.shape == ref.shape
    # Sharded pipeline pads the splat axis (alpha-0 splats) and slices tiles
    # per device; unstable sort ties of equal quantized-depth keys may
    # reorder, so allow small local differences.
    assert np.abs(img - ref).mean() < 1e-3
    assert np.abs(img - ref).max() < 0.05


def test_sharded_nondivisible_height():
    comp, pod, view, proj, _ = setup(w=64, h=48)
    cfg = TileConfig(64, 48, tile=16, max_dup=8)  # 3 tile rows over 8 devices
    mesh = make_mesh(jax.devices())
    pod_sharded = shard_pod(pod, mesh)
    ref = np.asarray(single_device_reference(comp, pod, view, proj, cfg))
    img = np.asarray(
        render_sharded(pod_sharded, mesh, comp, cfg, view, proj, sh_degree=3)
    )
    assert np.abs(img - ref).mean() < 1e-3


def test_graft_entry_contract():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[-1] == 4
    ge.dryrun_multichip(8)


@pytest.mark.parametrize("n_dev", [4])
def test_sharded_bench_shaped_geometry(n_dev):
    """Bench-shaped sharded frame: 512x512, 100k splats."""
    comp, pod, view, proj, cfg = setup(n=100_000, w=512, h=512)
    ref = np.asarray(single_device_reference(comp, pod, view, proj, cfg))
    mesh = make_mesh(jax.devices()[:n_dev])
    pod_sharded = shard_pod(pod, mesh)
    img = np.asarray(
        render_sharded(pod_sharded, mesh, comp, cfg, view, proj, sh_degree=3)
    )
    assert img.shape == ref.shape
    assert np.abs(img - ref).mean() < 1e-3
    assert np.abs(img - ref).max() < 0.05


def test_sharded_capacity_overflow_degrades_not_crashes():
    """A deliberately undersized receive buffer drops entries
    deterministically instead of corrupting memory or crashing."""
    comp, pod, view, proj, cfg = setup(n=768)
    mesh = make_mesh(jax.devices()[:2])
    pod_sharded = shard_pod(pod, mesh)
    img, stats = render_sharded(pod_sharded, mesh, comp, cfg, view, proj,
                                sh_degree=0,
                                capacity_factor=0.05, return_stats=True)
    img = np.asarray(img)
    assert img.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(img).all()
    # The whole point of the undersized buffer: the clamp's losses are
    # OBSERVABLE, not silent.
    assert stats["overflow"] > 0


def test_sharded_overflow_counter_zero_at_default_capacity():
    comp, pod, view, proj, cfg = setup(n=768)
    mesh = make_mesh(jax.devices()[:4])
    pod_sharded = shard_pod(pod, mesh)
    img, stats = render_sharded(pod_sharded, mesh, comp, cfg, view, proj,
                                sh_degree=0,
                                return_stats=True)
    assert stats["overflow"] == 0
    # The same counter is observable in the UI: last_stats() feeds the app
    # server's /state "parallel" section.
    from wgpu_3dgs_viewer_app_tpu.parallel.render_sharded import last_stats

    assert last_stats() == {"overflow": 0, "n_devices": 4}
    from wgpu_3dgs_viewer_app_tpu.app.server import _sharded_stats

    assert _sharded_stats() == {"overflow": 0, "n_devices": 4}


def test_sharded_multi_model_matches_single_device_merged():
    """Merged multi-model sharded frame == single-device merged render
    (model rank in the key, one sort; viewer._render_merged semantics)."""
    import dataclasses as dc

    from wgpu_3dgs_viewer_app_tpu.ops import preprocess as pp
    from wgpu_3dgs_viewer_app_tpu.ops.binning import enumerate_entries_from_pre
    from wgpu_3dgs_viewer_app_tpu.ops.binning import sort_and_range_entries
    from wgpu_3dgs_viewer_app_tpu.parallel import render_frame_sharded_multi

    comp, pod_a, view, proj, cfg = setup(n=640)
    scene_b = make_random_scene(512, seed=5, extent=1.0, scale_range=(0.02, 0.08))
    pod_b = {k: jnp.asarray(v) for k, v in pack_gaussians(scene_b, comp).items()}
    models = jnp.stack([jnp.eye(4), jnp.eye(4).at[2, 3].set(0.4)])
    ranks = jnp.asarray([1, 0], jnp.uint32)  # model 1 nearer the camera

    # Single-device merged reference.
    cfg_m = dc.replace(cfg, model_bits=1)
    parts = []
    for i, pod in enumerate((pod_a, pod_b)):
        pre = pp(pod, comp, view, proj, models[i], cfg.width, cfg.height, sh_degree=3)
        parts.append(enumerate_entries_from_pre(pre, cfg_m, model_rank=ranks[i]))
    keys, p1, p2, p3 = (jnp.concatenate([p[j] for p in parts]) for j in range(4))
    entries = sort_and_range_entries(keys, p1, p2, p3, cfg_m)
    ref = np.asarray(over_background(
        composite_tiles_jnp_v2(entries, cfg_m), jnp.zeros(3)
    ))

    mesh = make_mesh(jax.devices()[:4])
    pods = (shard_pod(pod_a, mesh), shard_pod(pod_b, mesh))
    img, overflow = render_frame_sharded_multi(
        pods, mesh, "splats", comp, cfg, view, proj, models, ranks,
        jnp.zeros(3, jnp.float32), sh_degree=3,
        ragged=False,
    )
    img = np.asarray(img)[: cfg.height]
    assert int(np.asarray(overflow).max()) == 0
    assert np.abs(img - ref).mean() < 1e-3
    assert np.abs(img - ref).max() < 0.05
