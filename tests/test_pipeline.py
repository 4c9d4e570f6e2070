"""Render pipeline tests: the tiled pipeline against the brute-force oracle,
display modes, compression configs, and kernel equivalences (SURVEY §4)."""

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
    build_entry_planes,
    build_tile_lists,
    composite_tiles_jnp,
    preprocess,
    rasterize_reference,
)

FULL = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)


def setup_scene(n=512, w=128, h=128, seed=0, comp=FULL, **pp_kw):
    scene = make_random_scene(n, seed=seed, extent=1.0, scale_range=(0.02, 0.1))
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view = jnp.asarray(cam.view())
    proj = jnp.asarray(cam.projection(w / h))
    pre = preprocess(pod, comp, view, proj, jnp.eye(4), w, h, **pp_kw)
    return scene, pod, pre, view, proj


def test_tiled_matches_bruteforce_oracle():
    _, _, pre, _, _ = setup_scene(sh_degree=3)
    cfg = TileConfig(128, 128, tile=16, max_dup=16)
    lists = build_tile_lists(pre, cfg)
    planes = build_entry_planes(pre, lists, cfg)
    img = np.asarray(composite_tiles_jnp(planes, cfg))
    ref = np.asarray(rasterize_reference(pre, 128, 128))
    # Small differences allowed: depth keys are quantized to ~20 bits in the
    # tiled path, so near-equal-depth overlaps may swap order.
    assert np.abs(img - ref).mean() < 2e-3
    assert np.abs(img - ref).max() < 0.05


def test_nonsquare_viewport_and_edge_tiles():
    _, _, pre, _, _ = setup_scene(n=300, w=100, h=76, sh_degree=0)
    cfg = TileConfig(100, 76, tile=16, max_dup=16)  # non-multiple-of-16 edges
    lists = build_tile_lists(pre, cfg)
    planes = build_entry_planes(pre, lists, cfg)
    img = np.asarray(composite_tiles_jnp(planes, cfg))
    assert img.shape == (76, 100, 4)
    ref = np.asarray(rasterize_reference(pre, 100, 76))
    assert np.abs(img - ref).mean() < 2e-3


def test_display_modes():
    cfg = TileConfig(96, 96, tile=16, max_dup=16)
    imgs = {}
    for mode in (0, 1, 2):
        _, _, pre, _, _ = setup_scene(n=300, w=96, h=96, sh_degree=0, display_mode=mode)
        lists = build_tile_lists(pre, cfg)
        planes = build_entry_planes(pre, lists, cfg)
        img = composite_tiles_jnp(planes, cfg, flat_mode=mode != 0)
        ref = rasterize_reference(pre, 96, 96, flat_mode=mode != 0)
        assert np.abs(np.asarray(img) - np.asarray(ref)).mean() < 2e-3, f"mode {mode}"
        imgs[mode] = np.asarray(img)
    # Modes produce visibly different coverage.
    assert np.abs(imgs[0] - imgs[1]).max() > 0.05
    assert np.abs(imgs[0] - imgs[2]).max() > 0.05


def test_empty_scene_renders_blank():
    comp = FULL
    scene = make_random_scene(64, seed=0, extent=1.0)
    scene.pos[:] += 1000.0  # everything far outside the frustum
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    pre = preprocess(
        pod, comp, jnp.asarray(cam.view()), jnp.asarray(cam.projection(1.0)),
        jnp.eye(4), 64, 64,
    )
    assert int(pre.valid.sum()) == 0
    cfg = TileConfig(64, 64, tile=16)
    lists = build_tile_lists(pre, cfg)
    planes = build_entry_planes(pre, lists, cfg)
    img = np.asarray(composite_tiles_jnp(planes, cfg))
    np.testing.assert_array_equal(img, 0.0)


def test_mask_bits_gate_splats():
    comp = FULL
    scene = make_random_scene(128, seed=2, extent=1.0, scale_range=(0.05, 0.1))
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = jnp.asarray(cam.view()), jnp.asarray(cam.projection(1.0))
    mask = jnp.zeros(128, jnp.uint8)
    pre = preprocess(pod, comp, view, proj, jnp.eye(4), 64, 64, mask_bits=mask)
    assert int(pre.valid.sum()) == 0
    pre2 = preprocess(pod, comp, view, proj, jnp.eye(4), 64, 64)
    assert int(pre2.valid.sum()) > 0


def test_selection_edit_changes_selected_only():
    from wgpu_3dgs_viewer_app_tpu.core import EDIT_FLAG_ENABLED, EDIT_FLAG_HIDDEN

    comp = FULL
    scene = make_random_scene(100, seed=3, extent=1.0)
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = jnp.asarray(cam.view()), jnp.asarray(cam.projection(1.0))
    # Per-splat sidecar arrays share the pod's lane-padded capacity.
    sel = jnp.zeros(128, jnp.uint8).at[:50].set(1)
    sel_edit = (
        jnp.uint32(EDIT_FLAG_ENABLED | EDIT_FLAG_HIDDEN),
        jnp.asarray([0.0, 1.0, 1.0]),
        jnp.asarray([0.0, 0.0, 1.0, 1.0]),
    )
    pre = preprocess(
        pod, comp, view, proj, jnp.eye(4), 64, 64,
        selection_bits=sel, selection_edit=sel_edit,
    )
    base = preprocess(pod, comp, view, proj, jnp.eye(4), 64, 64)
    # selected splats hidden, unselected unchanged
    assert not np.asarray(pre.valid[:50]).any()
    np.testing.assert_array_equal(np.asarray(pre.valid[50:]), np.asarray(base.valid[50:]))


def test_highlight_tints_selected():
    comp = FULL
    scene = make_random_scene(50, seed=4, extent=1.0)
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = jnp.asarray(cam.view()), jnp.asarray(cam.projection(1.0))
    sel = jnp.zeros(128, jnp.uint8).at[0].set(1)
    hl = jnp.asarray([1.0, 0.0, 1.0, 0.5])
    pre = preprocess(
        pod, comp, view, proj, jnp.eye(4), 64, 64,
        selection_bits=sel, highlight_rgba=hl,
    )
    base = preprocess(pod, comp, view, proj, jnp.eye(4), 64, 64)
    expect = np.asarray(base.rgb[0]) * 0.5 + np.array([1, 0, 1]) * 0.5
    np.testing.assert_allclose(np.asarray(pre.rgb[0]), expect, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pre.rgb[1:]), np.asarray(base.rgb[1:]))


@pytest.mark.parametrize("sh", list(ShCompression), ids=lambda s: s.value)
def test_compressed_render_close_to_full(sh):
    comp = Compressions(sh, Cov3dCompression.HALF)
    cfg = TileConfig(64, 64, tile=16, max_dup=16)
    _, _, pre_full, _, _ = setup_scene(n=200, w=64, h=64, sh_degree=3)
    _, _, pre_c, _, _ = setup_scene(n=200, w=64, h=64, comp=comp, sh_degree=3)
    lists_f = build_tile_lists(pre_full, cfg)
    img_f = composite_tiles_jnp(build_entry_planes(pre_full, lists_f, cfg), cfg)
    lists_c = build_tile_lists(pre_c, cfg)
    img_c = composite_tiles_jnp(build_entry_planes(pre_c, lists_c, cfg), cfg)
    diff = np.abs(np.asarray(img_f) - np.asarray(img_c)).mean()
    if sh == ShCompression.REMOVE:
        assert diff < 0.1  # SH removed: base color only, still plausible
    else:
        assert diff < 0.02


def test_model_transform_moves_image():
    comp = FULL
    scene = make_random_scene(200, seed=5, extent=0.5, scale_range=(0.05, 0.1))
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(scene, comp).items()}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = jnp.asarray(cam.view()), jnp.asarray(cam.projection(1.0))
    cfg = TileConfig(64, 64, tile=16, max_dup=16)

    def render(model):
        pre = preprocess(pod, comp, view, proj, model, 64, 64)
        lists = build_tile_lists(pre, cfg)
        return np.asarray(composite_tiles_jnp(build_entry_planes(pre, lists, cfg), cfg))

    a = render(jnp.eye(4))
    shift = jnp.eye(4).at[0, 3].set(0.5)
    b = render(shift)
    assert np.abs(a - b).max() > 0.05
    # alpha mass conserved approximately (same splats, shifted)
    assert abs(a[..., 3].sum() - b[..., 3].sum()) / max(a[..., 3].sum(), 1) < 0.2


def test_v2_payload_carry_matches_oracle():
    from wgpu_3dgs_viewer_app_tpu.ops import build_sorted_entries, composite_tiles_jnp_v2

    _, _, pre, _, _ = setup_scene(sh_degree=3)
    cfg = TileConfig(128, 128, tile=16, max_dup=16)
    entries = build_sorted_entries(pre, cfg)
    img = np.asarray(composite_tiles_jnp_v2(entries, cfg))
    ref = np.asarray(rasterize_reference(pre, 128, 128))
    # v2 quantizes mean/conic/alpha to f16 and rgb to u8 on top of the
    # depth-key quantization; tolerances reflect that.
    assert np.abs(img - ref).mean() < 4e-3
    assert np.abs(img - ref).max() < 0.08


def test_f16_bit_roundtrip():
    from wgpu_3dgs_viewer_app_tpu.ops.binning import _pack2xf16, unpack2xf16

    x = np.random.default_rng(0).uniform(-500, 500, 4096).astype(np.float32)
    y = np.random.default_rng(1).uniform(0, 1, 4096).astype(np.float32)
    w = _pack2xf16(jnp.asarray(x), jnp.asarray(y))
    a, b = unpack2xf16(w)
    # Within 1 ulp of numpy's f16 round-trip (we round half-up, numpy RNE).
    ref_a = x.astype(np.float16).astype(np.float32)
    ref_b = y.astype(np.float16).astype(np.float32)
    assert np.abs(np.asarray(a) - ref_a).max() <= np.spacing(np.float16(500)).astype(np.float32)
    assert np.abs(np.asarray(b) - ref_b).max() <= 1e-3
    # zeros stay exactly zero
    z, _ = unpack2xf16(_pack2xf16(jnp.zeros(8), jnp.zeros(8)))
    np.testing.assert_array_equal(np.asarray(z), 0.0)


def test_model_rank_in_keys():
    """The multi-model pass keys every entry with its model rank, above
    the depth field; the rank must not change tile ranges or pixels."""
    from wgpu_3dgs_viewer_app_tpu.ops import (
        build_sorted_entries,
        composite_tiles_jnp_v2,
        enumerate_entries_from_pre,
    )
    from wgpu_3dgs_viewer_app_tpu.ops.binning import SENTINEL_KEY

    _, _, pre, _, _ = setup_scene(n=400, w=128, h=128, sh_degree=1)
    cfg = TileConfig(128, 128, tile=16, max_dup=8, model_bits=2)
    rank = 2
    keys, _, _, _ = enumerate_entries_from_pre(pre, cfg, model_rank=rank)
    k = np.asarray(keys)
    live = k != SENTINEL_KEY
    assert live.any()
    shift = cfg.v2_depth_bits + cfg.ALPHA_BITS
    got_ranks = (k[live] >> shift) & ((1 << cfg.model_bits) - 1)
    assert (got_ranks == rank).all(), "model rank bits missing from keys"

    a = build_sorted_entries(pre, cfg, model_rank=rank)
    b = build_sorted_entries(pre, cfg, model_rank=0)
    np.testing.assert_array_equal(np.asarray(a.tile_counts), np.asarray(b.tile_counts))
    np.testing.assert_allclose(np.asarray(composite_tiles_jnp_v2(a, cfg)),
                               np.asarray(composite_tiles_jnp_v2(b, cfg)), atol=1e-6)


def test_tile_config_depth_bits_guard():
    cfg = TileConfig(1920, 1080, tile=16, max_dup=8, model_bits=2)
    assert cfg.v2_depth_bits >= TileConfig.MIN_DEPTH_BITS
    bad = TileConfig(1920, 1080, tile=16, max_dup=8, model_bits=12)
    with pytest.raises(ValueError):
        _ = bad.v2_depth_bits
