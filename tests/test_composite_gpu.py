"""The Triton tile compositor (`ops/composite.composite_tiles_gpu`) in
Pallas interpret mode on the CPU, against `composite_tiles_jnp_v2` on the
same sorted entries and against the brute-force oracle, plus the wrapper's
shape checks and the implementation choice.

Scenarios pin the kernel's control flow: tiles with no entries, tiles that
saturate and stop early, runs that cross 128-entry rows of the flat entry
order, and the multi-model key (model rank above depth).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu.data import (
    Compressions,
    Cov3dCompression,
    ShCompression,
    make_random_scene,
    pack_gaussians,
)
from wgpu_3dgs_viewer_app_tpu.ops import (
    TileConfig,
    composite_tiles_gpu,
    composite_tiles_jnp_v2,
    composite_tiles_v2,
    enumerate_entries_from_pre,
    preprocess,
    rasterize_reference,
    sort_and_range_entries,
)
from wgpu_3dgs_viewer_app_tpu.ops.binning import ROW, PreprocessOut

FULL = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)
W, H = 64, 64
MODES = {"splat": 0, "ellipse": 1, "point": 2}
# scenario -> (splats, scale range, extent, xy offset, pre-sigmoid opacity
# floor, model z offsets)
SCENARIOS = {
    "empty": (12, (0.02, 0.05), 0.3, 1.0, None, (0.0,)),
    "saturated": (2000, (0.1, 0.3), 2.0, 0.0, 3.0, (0.0,)),
    "rows": (1200, (0.02, 0.08), 0.8, 0.0, None, (0.0,)),
    "multimodel": (500, (0.02, 0.08), 0.8, 0.0, None, (0.0, -1.5)),
}


def _pre(n, scales, extent, offset, opacity_floor, z, mode, seed):
    scene = make_random_scene(n, seed=seed, extent=extent, scale_range=scales)
    if opacity_floor is not None:
        scene.opacity[:] = np.maximum(scene.opacity, opacity_floor)
    scene.pos[:, :2] += offset
    scene.pos[:, 2] += z
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, FULL).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    return preprocess(pod, FULL, jnp.asarray(cam.view()),
                      jnp.asarray(cam.projection(W / H)), jnp.eye(4), W, H,
                      sh_degree=1, display_mode=mode)


def _case(scenario, mode, tile):
    """(entries, cfg, oracle pre) for one scenario. Models sit at distinct
    depths, nearest at rank 0, so the rank order is the depth order and
    the global-depth oracle applies to the multi-model frame too."""
    n, scales, extent, offset, floor, zs = SCENARIOS[scenario]
    pres = [_pre(n, scales, extent, offset, floor, z, mode, seed=7 + i)
            for i, z in enumerate(zs)]
    mbits = 1 if len(pres) > 1 else 0
    cfg = TileConfig(W, H, tile=tile, max_dup=16, model_bits=mbits)
    nearest_first = np.argsort(zs)  # the camera looks down +z from z = -4
    rank = {int(m): r for r, m in enumerate(nearest_first)}
    parts = [enumerate_entries_from_pre(p, cfg, model_rank=jnp.uint32(rank[i]))
             for i, p in enumerate(pres)]
    planes = (jnp.concatenate([p[j] for p in parts]) for j in range(4))
    entries = sort_and_range_entries(*planes, cfg)
    oracle_pre = PreprocessOut(*(jnp.concatenate(f) for f in zip(
        *(p.tree_flatten()[0] for p in pres))))
    return entries, cfg, oracle_pre


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_matches_jnp_and_oracle(scenario, tile, mode):
    entries, cfg, oracle_pre = _case(scenario, MODES[mode], tile)
    flat = MODES[mode] != 0
    got = np.asarray(composite_tiles_gpu(entries, cfg, flat_mode=flat, interpret=True))
    ref = np.asarray(composite_tiles_jnp_v2(entries, cfg, flat_mode=flat))
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)

    counts = np.asarray(entries.tile_counts)
    starts = np.asarray(entries.tile_starts)
    if scenario == "empty":
        assert (counts == 0).any() and (counts > 0).any()
        per_tile = got.reshape(cfg.tiles_y, tile, cfg.tiles_x, tile, 4)
        per_tile = per_tile.transpose(0, 2, 1, 3, 4).reshape(cfg.n_tiles, -1)
        assert (per_tile[counts == 0] == 0).all()
    if scenario == "saturated" and mode != "point":
        # Every pixel of some tile saturates while its run goes on for
        # more rows: the tile stops early. (Point mode draws small discs.)
        per_tile = got.reshape(cfg.tiles_y, tile, cfg.tiles_x, tile, 4)
        per_tile = per_tile.transpose(0, 2, 1, 3, 4).reshape(cfg.n_tiles, -1, 4)
        opaque = (per_tile[..., 3] > 1 - 1.0 / 255).all(axis=1)
        assert (opaque & (counts > 2 * ROW)).any()
    if scenario == "rows":
        crossing = (counts > 0) & (starts // ROW != (starts + counts - 1) // ROW)
        assert crossing.sum() >= 4

    oracle = np.asarray(rasterize_reference(oracle_pre, W, H, flat_mode=flat))
    d = np.abs(got - oracle)
    # The tiled path quantizes means/conics to f16, colour to u8 and depth
    # to the key's bits, and stops a saturated tile at T < 1/255.
    assert d.mean() < 4e-3, d.mean()
    if not flat:
        assert d.max() < 0.08, d.max()


def test_kernel_refuses_non_power_of_two_tiles():
    entries, cfg, _ = _case("empty", 0, 16)
    with pytest.raises(ValueError, match="power-of-two"):
        composite_tiles_gpu(entries, dataclasses.replace(cfg, tile=24), interpret=True)


def test_v2_dispatch_cpu_is_jnp():
    entries, cfg, _ = _case("rows", 0, 16)
    np.testing.assert_array_equal(
        np.asarray(composite_tiles_v2(entries, cfg, False, "cpu")),
        np.asarray(composite_tiles_jnp_v2(entries, cfg)))


def test_v2_dispatch_rejects_unknown_impl():
    entries, cfg, _ = _case("empty", 0, 16)
    with pytest.raises(ValueError, match="unknown render implementation"):
        composite_tiles_v2(entries, cfg, False, "metal")
