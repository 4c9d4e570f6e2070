"""Compacted dup-slot enumeration (TileConfig.dup_scan, which removes the
sentinel slack): slot d = the d-th candidate PASSING the exact
ellipse-tile test among the first K center-out candidates, instead of
candidate d unconditionally.

Semantics pinned here:
  1. No-truncation equivalence: if max_dup can hold every passing cell,
     compacted enumeration emits exactly the same LIVE (key, p1) multiset
     as the uncompacted enumeration scanning the same K candidates.
  2. Truncation order: with a smaller max_dup, each splat keeps the FIRST
     max_dup passing candidates in center-out order (farthest cells drop).
  3. Compaction invariant: within a splat's slots, live entries pack into
     the low slots (no live slot after a sentinel slot).
"""

import jax.numpy as jnp
import numpy as np

from wgpu_3dgs_viewer_app_tpu.core.f16 import f32_to_f16_bits, pack2xf16
from wgpu_3dgs_viewer_app_tpu.ops.binning import (
    SENTINEL_KEY,
    TileConfig,
    _enumerate_entries_jnp,
)


def _scene(n=512, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 512, n).astype(np.float32)
    y = rng.uniform(0, 512, n).astype(np.float32)
    s1 = rng.uniform(4.0, 24.0, n)
    s2 = s1 * rng.uniform(1.0, 3.0, n)
    th = rng.uniform(0, np.pi, n)
    ct, st = np.cos(th), np.sin(th)
    ia, ib = 1.0 / s1**2, 1.0 / s2**2
    a = (ct * ct * ia + st * st * ib).astype(np.float32)
    c = (st * st * ia + ct * ct * ib).astype(np.float32)
    b = (ct * st * (ia - ib)).astype(np.float32)
    r = (np.maximum(s1, s2) * 2.0).astype(np.float32)
    p2 = np.asarray(pack2xf16(jnp.asarray(a), jnp.asarray(b)))
    p3 = np.asarray(f32_to_f16_bits(jnp.asarray(c)))
    key_lo = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    p1_base = rng.integers(0, 1 << 8, n, dtype=np.uint32) << np.uint32(24)
    return tuple(
        jnp.asarray(v) for v in (x, y, r, key_lo, p1_base, p2, p3)
    )


def _enum(cfg, args):
    out = _enumerate_entries_jnp(*args, cfg)
    # (D, N)-major; regroup per splat.
    n = args[0].shape[0]
    return tuple(np.asarray(o).reshape(cfg.max_dup, n).T for o in out)


def _live_sets(keys, p1):
    """Per-splat list of live (key, p1) pairs in slot order."""
    out = []
    for i in range(keys.shape[0]):
        out.append([
            (int(keys[i, d]), int(p1[i, d]))
            for d in range(keys.shape[1])
            if keys[i, d] != SENTINEL_KEY
        ])
    return out


def test_compacted_matches_uncompacted_when_capacity_suffices():
    args = _scene()
    k = 9
    ref = TileConfig(512, 512, tile=32, max_dup=k, dup_scan=0)
    cmp_ = TileConfig(512, 512, tile=32, max_dup=k, dup_scan=k + 3)
    rk, rp1, *_ = _enum(ref, args)
    ck, cp1, *_ = _enum(cmp_, args)
    ref_live = _live_sets(rk, rp1)
    cmp_live = _live_sets(ck, cp1)
    # dup_scan = k+3 scans MORE candidates than the k-slot reference; limit
    # the reference comparison to splats whose rect fits in k candidates
    # (n_touched <= k) — there compaction must reproduce the live set
    # exactly, in the same center-out order.
    from wgpu_3dgs_viewer_app_tpu.ops.binning import (
        _splat_rect,
        _tight_cull_params,
    )

    x, y, r, _, _, p2, p3 = args
    cull, rx, ry = _tight_cull_params(r, p2, p3)
    n_touched = np.asarray(_splat_rect(x, y, rx, ry, ref)[4])
    checked = 0
    for i in range(len(ref_live)):
        if n_touched[i] <= k:
            assert cmp_live[i] == ref_live[i], i
            checked += 1
    assert checked > 100  # the scene must actually exercise the claim


def test_truncation_keeps_first_passing_in_center_out_order():
    args = _scene(seed=7)
    k = 12
    wide = TileConfig(512, 512, tile=32, max_dup=k, dup_scan=k)
    slim = TileConfig(512, 512, tile=32, max_dup=3, dup_scan=k)
    wk, wp1, *_ = _enum(wide, args)
    sk, sp1, *_ = _enum(slim, args)
    wide_live = _live_sets(wk, wp1)
    slim_live = _live_sets(sk, sp1)
    for i in range(len(wide_live)):
        assert slim_live[i] == wide_live[i][:3], i


def test_live_slots_are_packed_low():
    args = _scene(seed=9)
    cfg = TileConfig(512, 512, tile=32, max_dup=4, dup_scan=12)
    ck, *_ = _enum(cfg, args)
    live = ck != SENTINEL_KEY
    # No live slot may follow a sentinel slot.
    for d in range(1, cfg.max_dup):
        assert not np.any(live[:, d] & ~live[:, d - 1])
