"""Image tests on the card — the compiled Triton compositor and the whole
GPU frame against the portable jnp path, on the trained-statistics
fidelity scene (`data/synthetic.make_inria_like_scene`).

Fidelity chain: the brute-force oracle (`ops/rasterize_ref.py`) implements
the reference math; the CPU suite pins the tiled pipeline and the kernel
(in interpret mode) to it; these tests pin the compiled kernel on the GPU.
Run them on the card with
  GS_GPU_TESTS=1 python -m pytest tests/ -m gpu -p no:xdist -o addopts=""
Elsewhere the `gpu` fixture skips them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu.data import (
    Compressions,
    make_inria_like_scene,
    pack_gaussians,
)
from wgpu_3dgs_viewer_app_tpu.ops import (
    TileConfig,
    build_sorted_entries,
    composite_tiles_gpu,
    composite_tiles_jnp_v2,
    preprocess,
)

pytestmark = pytest.mark.gpu


def _scene(n=200_000, w=512, h=512):
    comp = Compressions()
    g = make_inria_like_scene(n, seed=0, scene_scale=4.0)
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(g, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 2.0, -9.0))
    view = jnp.asarray(cam.view())
    proj = jnp.asarray(cam.projection(w / h))
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    return comp, pod, view, proj, cfg


def _entries(comp, pod, view, proj, cfg, sh_degree=3):
    pre = preprocess(pod, comp, view, proj, jnp.eye(4), cfg.width, cfg.height,
                     sh_degree=sh_degree)
    return build_sorted_entries(pre, cfg)


def _host(tree):
    cpu = jax.devices("cpu")[0]
    return jax.tree.map(lambda a: jax.device_put(np.asarray(a), cpu), tree)


@pytest.mark.parametrize("flat", [False, True], ids=["splat", "flat"])
def test_gpu_compositor_matches_jnp_on_chip(gpu, flat):
    """Compiled Triton compositor == jnp compositor on the same sorted
    entries, on the card (f32 elementwise math on both; only exp2 and
    summation order differ) and against the host CPU."""
    comp, pod, view, proj, cfg = _scene(n=80_000, w=256, h=256)
    entries = _entries(comp, pod, view, proj, cfg)
    img_k = np.asarray(composite_tiles_gpu(entries, cfg, flat_mode=flat))
    img_j = np.asarray(composite_tiles_jnp_v2(entries, cfg, flat_mode=flat))
    np.testing.assert_allclose(img_k, img_j, atol=1e-4)
    with jax.default_device(jax.devices("cpu")[0]):
        img_c = np.asarray(composite_tiles_jnp_v2(_host(entries), cfg, flat_mode=flat))
    np.testing.assert_allclose(img_k, img_c, atol=1e-3)


def test_end_to_end_gpu_matches_cpu_pipeline(gpu):
    """The whole GPU frame == the portable pipeline on the host CPU.

    The two backends round the projection chain differently, so the few
    splats whose extent lands within that wobble of a tile boundary can
    emit different cell sets under max_dup truncation (isolated tile-sized
    patches); bound the mean and the divergent fraction, not the max."""
    comp, pod, view, proj, cfg = _scene(n=80_000, w=256, h=256)
    img_gpu = np.asarray(composite_tiles_gpu(_entries(comp, pod, view, proj, cfg), cfg))
    with jax.default_device(jax.devices("cpu")[0]):
        a = _entries(comp, _host(pod), _host(view), _host(proj), cfg)
        img_cpu = np.asarray(composite_tiles_jnp_v2(a, cfg))
    d = np.abs(img_gpu - img_cpu)
    frac = float((d > 2e-3).mean())
    print(f"gpu-vs-cpu: mean |d| = {d.mean():.2e}, frac>2e-3 = {frac:.2%}, "
          f"max = {d.max():.3f}")
    assert d.mean() < 2.5e-3
    assert frac < 0.05
    assert d.max() < 0.6


def test_max_dup_truncation_bound_at_bench_scale(gpu):
    """max_dup truncation against max_dup=16 (effectively exact) at bench
    scale on the trained-statistics scene — the quality statement behind
    the dup knob. Splats whose rect exceeds max_dup dim from the far cells
    inward (center-out enumeration, `ops/binning._enum_cell`); trained-like
    scenes have a heavy big-splat tail, so dup=4 measurably dims them."""
    comp, pod, view, proj, _ = _scene(n=2_000_000, w=1920, h=1088)

    def render(dup):
        cfg = TileConfig(1920, 1088, tile=32, max_dup=dup)
        return np.asarray(composite_tiles_gpu(
            _entries(comp, pod, view, proj, cfg, sh_degree=1), cfg))

    img16 = render(16)
    stats = {}
    for dup in (4, 8):
        d = np.abs(render(dup) - img16)
        stats[dup] = (float(d.mean()), float(np.quantile(d, 0.999)))
        print(f"max_dup={dup} vs 16 at 2M@1080p: mean |err| = "
              f"{stats[dup][0]:.2e}, p99.9 = {stats[dup][1]:.3f}")
    assert stats[4][0] < 0.08 and stats[4][1] < 0.7     # product default
    assert stats[8][0] < 0.035 and stats[8][1] < 0.55   # quality preset
    assert stats[8][0] < 0.65 * stats[4][0]             # monotone improvement


def test_ragged_all_to_all_routing_on_chip(gpu):
    """`lax.ragged_all_to_all` — the GPU transport of the sharded renderer
    — compiles and runs on the card. A 1-device mesh exercises the whole
    routing metadata path; the image must match the unsharded frame and
    the overflow counter must be 0."""
    from wgpu_3dgs_viewer_app_tpu.ops import over_background
    from wgpu_3dgs_viewer_app_tpu.parallel import make_mesh, render_frame_sharded, shard_pod

    comp, pod, view, proj, cfg = _scene(n=80_000, w=256, h=256)
    mesh = make_mesh(jax.devices()[:1])
    img, overflow = render_frame_sharded(
        shard_pod(pod, mesh), mesh, "splats", comp, cfg, view, proj, jnp.eye(4),
        jnp.zeros(3, jnp.float32), sh_degree=3, impl="gpu", ragged=True,
    )
    img = np.asarray(img)[: cfg.height]
    assert int(np.asarray(overflow).max()) == 0
    assert np.isfinite(img).all()
    ref = np.asarray(over_background(
        composite_tiles_gpu(_entries(comp, pod, view, proj, cfg), cfg), jnp.zeros(3)))
    d = np.abs(img - ref)
    frac = float((d > 2e-3).mean())
    print(f"ragged-vs-unsharded: mean |d| = {d.mean():.2e}, "
          f"frac>2e-3 = {frac:.2%}, max = {d.max():.3f}")
    assert d.mean() < 1.5e-3
    assert frac < 0.04
