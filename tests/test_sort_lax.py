"""The entry sort (`ops/binning.sort_entries`, one `lax.sort` carrying three
payload planes) and the per-tile ranges cut from it
(`sort_and_range_entries`), against a numpy oracle.

Contract: keys come out in exact ascending order; every payload triple
travels with its key (unstable within a run of equal keys, so payloads are
compared as multisets per run); the ranges of tile t cover exactly the
entries whose key's tile field is t; sentinel entries sort past every tile.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from wgpu_3dgs_viewer_app_tpu.ops import TileConfig, sort_and_range_entries, sort_entries
from wgpu_3dgs_viewer_app_tpu.ops.binning import ROW, SENTINEL_KEY

CFG = TileConfig(256, 192, tile=32, max_dup=4)  # 48 tiles


def _mk(e, frac_sentinel, n_keys, seed=0, tile_of=None):
    """Random keys over `n_keys` distinct low parts spread over the tiles,
    a `frac_sentinel` share of sentinel slots, and unique-id payloads."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, CFG.n_tiles, e) if tile_of is None else tile_of(rng, e)
    lo = rng.integers(0, n_keys, e).astype(np.uint64)
    k = ((tiles.astype(np.uint64) << np.uint64(CFG._tile_shift)) | lo).astype(np.uint32)
    k[rng.random(e) < frac_sentinel] = SENTINEL_KEY
    p1 = np.arange(e, dtype=np.uint32)
    p2 = rng.integers(0, 2**32, e, dtype=np.uint32)
    p3 = rng.integers(0, 2**32, e, dtype=np.uint32)
    return k, p1, p2, p3


def _runs(keys, *payloads):
    """{key: sorted list of payload tuples} — order-free within a key run."""
    out = {}
    for i, k in enumerate(keys.tolist()):
        out.setdefault(k, []).append(tuple(int(p[i]) for p in payloads))
    return {k: sorted(v) for k, v in out.items()}


def _check(k, p1, p2, p3):
    ks, s1, s2, s3 = (np.asarray(a) for a in sort_entries(
        *(jnp.asarray(a) for a in (k, p1, p2, p3))))
    np.testing.assert_array_equal(ks, np.sort(k))
    assert _runs(ks, s1, s2, s3) == _runs(k, p1, p2, p3)

    ent = sort_and_range_entries(*(jnp.asarray(a) for a in (k, p1, p2, p3)), CFG)
    planes = np.asarray(ent.planes)  # (R, 4, 128)
    assert planes.shape == (-(-k.shape[0] // ROW), 4, ROW)
    flat = planes.transpose(1, 0, 2).reshape(4, -1)[:, : k.shape[0]]
    np.testing.assert_array_equal(flat[0], ks)
    np.testing.assert_array_equal(flat[1:], np.stack([s1, s2, s3]))
    tile = (k >> np.uint32(CFG._tile_shift)).astype(np.int64)
    tile[k == SENTINEL_KEY] = -1
    counts = np.bincount(tile[tile >= 0], minlength=CFG.n_tiles)
    np.testing.assert_array_equal(np.asarray(ent.tile_counts), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    np.testing.assert_array_equal(np.asarray(ent.tile_starts), starts)
    assert int(ent.n_valid) == int((k != SENTINEL_KEY).sum())


@pytest.mark.parametrize("frac", [0.0, 0.44, 0.9])
def test_sentinel_fraction(frac):
    _check(*_mk(20_000, frac, 1 << 12, seed=1))


@pytest.mark.parametrize("n_keys", [1 << 4, 1 << CFG._tile_shift], ids=["narrow", "full"])
def test_key_span(n_keys):
    _check(*_mk(12_345, 0.3, n_keys, seed=2))  # not a ROW multiple: padded rows


@pytest.mark.parametrize("n_keys", [1, 2])
def test_massive_key_ties(n_keys):
    _check(*_mk(9_000, 0.1, n_keys, seed=3, tile_of=lambda rng, e: np.zeros(e, np.int64)))


def test_extreme_live_skew():
    """Almost every live entry in one tile; the rest spread thinly."""
    def tile_of(rng, e):
        t = np.full(e, 17)
        t[rng.random(e) < 0.02] = 3
        return t
    _check(*_mk(16_384, 0.5, 1 << 10, seed=4, tile_of=tile_of))


def test_live_tail_only():
    """Live entries only at the end of the input, sentinels before them."""
    k, p1, p2, p3 = _mk(10_000, 0.0, 1 << 10, seed=5)
    k[:9_000] = SENTINEL_KEY
    _check(k, p1, p2, p3)


def test_all_sentinel():
    k, p1, p2, p3 = _mk(4_096, 1.0, 1 << 10, seed=6)
    _check(k, p1, p2, p3)
