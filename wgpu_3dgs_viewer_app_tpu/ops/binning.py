"""Tile binning + depth sort: the JAX equivalent of the crate's `RadixSorter`
(driven at reference `src/tab/scene.rs:865-869`) fused with tile-list
construction for the compositor.

The reference sorts (depth, splat) pairs and lets hardware blending handle
pixel order. JAX reaches no rasterizer or ROPs, so we take the tile-binned
design of the 3DGS CUDA rasterizer (Kerbl et al. 2023): each
surviving splat is duplicated into every screen tile its 3-sigma rect touches
(static duplication factor D — XLA static shapes; SURVEY §7 hard-part (3)),
keyed by

    key(u32) = tile_id << DEPTH_BITS | monotonic_f32_bits(depth) >> (32 - DEPTH_BITS)

One ascending `lax.sort` then yields, per tile, a front-to-back splat run;
`searchsorted` recovers the per-tile [start, count) ranges (the analog of
the crate's dispatch-indirect args buffer, `src/tab/scene.rs:867-868`).

IEEE-754 trick: positive f32 bit patterns are monotonic in value, so the top
DEPTH_BITS of the raw bits order by depth without a normalize pass.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .preprocess import PreprocessOut

# Peak splat opacity (ref 3DGS rasterizer convention). The enumeration key
# clamps its alpha byte to ALPHA_U8_MAX so the compositor needs no per-pixel
# clamp — composite.py imports BOTH constants from here so they can't desync.
ALPHA_MAX = 0.99
ALPHA_U8_MAX = int(ALPHA_MAX * 255)  # 252

# Culled/empty dup slots carry this key (sorts after every real tile;
# ops/sort.py's SENTINEL is the same value by contract).
SENTINEL_KEY = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static screen/tiling geometry (part of the jit specialization key)."""

    width: int
    height: int
    tile: int = 16  # tile side in pixels
    # Max duplicated tile entries per splat (D). Splats whose culled tile
    # rect exceeds D get their trailing cells dropped (visible as tile-grid
    # seams), so choose D >= (ceil(2*r_max/tile)+1)^2 for the expected max
    # splat radius: D=16 is safe for r <= 1.5 tiles; D=4 is exact only for
    # r <= tile/2. Sort cost scales with N*D.
    max_dup: int = 8
    # Compacted slot assignment (removes sentinel slack):
    # with dup_scan = K > max_dup, slot d holds the d-th candidate cell that
    # PASSES the exact ellipse-tile test among the K center-out candidates —
    # instead of the d-th candidate unconditionally. Slots then hold ~0
    # sentinels for unculled splats, so the same coverage needs a smaller D
    # (E = N*D is the sort's scale axis): D=3/K=12 covers every splat the
    # uncompacted D=4 covers EXCEPT those with >= 4 passing cells, while
    # reaching passing cells anywhere in the first 12 candidates (the
    # uncompacted path never looks past candidate 3). 0 = off (slot d =
    # candidate d, the uncompacted layout). Costs K-D extra ellipse tests
    # per splat in the enumeration (~25 elementwise ops each).
    dup_scan: int = 0

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_bits(self) -> int:
        # +1 so the sentinel bucket (all-ones tile) sorts after every real tile.
        return max(1, (self.n_tiles + 1 - 1).bit_length())

    @property
    def depth_bits(self) -> int:
        return 32 - self.tile_bits

    # v2 key layout: tile | model_rank | depth | alpha8. Stashing the
    # per-entry opacity in the key's low byte removes one u32 sort payload,
    # and the sorted keys flow to the compositor anyway. Sorting by alpha
    # within equal (tile, depth) buckets is harmless: those entries are
    # depth ties whose blend order is unspecified after quantization. model_bits > 0 enables the fused
    # multi-model pass: per tile, entries group by model (nearest rank
    # first — the compositor is front-to-back, mirroring the reference's
    # back-to-front per-model draws, `src/tab/scene.rs:2299-2315`), sorted
    # by depth within each model.
    ALPHA_BITS = 8
    model_bits: int = 0

    # Minimum acceptable depth-key resolution: below this the log-depth
    # quantization gets coarse enough to visibly misorder splats. model_bits
    # eats depth precision directly (1080p/13 tile bits leaves 11; 3 model
    # bits drop it to 8) — callers picking mbits (viewer._render_merged)
    # must keep within this floor or the constructor refuses the layout.
    MIN_DEPTH_BITS = 6

    @property
    def v2_depth_bits(self) -> int:
        bits = 32 - self.tile_bits - self.ALPHA_BITS - self.model_bits
        if bits < self.MIN_DEPTH_BITS:
            raise ValueError(
                f"key layout leaves {bits} depth bits "
                f"(tile_bits={self.tile_bits}, model_bits={self.model_bits}); "
                f"need >= {self.MIN_DEPTH_BITS} — reduce model count or tile count"
            )
        return bits

    @property
    def _tile_shift(self) -> int:
        return self.v2_depth_bits + self.ALPHA_BITS + self.model_bits


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TileLists:
    """Sorted duplicated entries + per-tile ranges."""

    sorted_idx: jnp.ndarray    # (N*D,) i32 splat index per entry (depth-major per tile)
    sorted_keys: jnp.ndarray   # (N*D,) u32
    tile_starts: jnp.ndarray   # (n_tiles,) i32 start offset of each tile's run
    tile_counts: jnp.ndarray   # (n_tiles,) i32 entries per tile
    n_valid: jnp.ndarray       # () i32 total live entries

    def tree_flatten(self):
        return (
            (self.sorted_idx, self.sorted_keys, self.tile_starts, self.tile_counts, self.n_valid),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# Fixed log-depth quantization range: [0.05, 2e4] covers any sane scene and
# keeps the key mapping frame-independent (a per-frame dmin/dmax fit would
# requantize — and so reorder ties — every time the camera moves). At 13
# depth bits that is ~635 key steps per e-fold of depth.
DEPTH_LN_MIN = -3.0  # ln(0.05)
DEPTH_LN_MAX = 9.905  # ln(2e4)


def depth_alpha_key_lo(depth, alpha, cfg: "TileConfig", model_rank=None) -> jnp.ndarray:
    """Low key bits: [model_rank |] log-depth quantized over the fixed
    range | alpha u8. `model_rank` (traced u32 scalar, nearest model = 0)
    only when cfg.model_bits > 0."""
    db = cfg.v2_depth_bits
    ld = jnp.log(jnp.maximum(depth, 1e-6))
    scale = float(2**db - 1) / (DEPTH_LN_MAX - DEPTH_LN_MIN)
    dkey = (
        jnp.clip((ld - DEPTH_LN_MIN) * scale, 0.0, float(2**db - 1))
        .astype(jnp.int32)
        .astype(jnp.uint32)
    )
    # Clamp to ALPHA_U8_MAX = floor(ALPHA_MAX * 255) here so the compositor
    # needs no per-pixel clamp (ops/composite._alpha_from_power).
    alpha_u8 = (
        jnp.clip(alpha * 255.0 + 0.5, 0.0, float(ALPHA_U8_MAX))
        .astype(jnp.int32).astype(jnp.uint32)
    )
    lo = (dkey << jnp.uint32(cfg.ALPHA_BITS)) | alpha_u8
    if cfg.model_bits:
        lo = lo | (jnp.uint32(model_rank) << jnp.uint32(db + cfg.ALPHA_BITS))
    return lo


def depth_key_bits(depth: jnp.ndarray, depth_bits: int) -> jnp.ndarray:
    """Positive-f32 depth -> monotonic top `depth_bits` integer key (u32)."""
    bits = jax.lax.bitcast_convert_type(jnp.maximum(depth, 0.0), jnp.uint32)
    return bits >> jnp.uint32(32 - depth_bits)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_tile_lists(pre: PreprocessOut, cfg: TileConfig) -> TileLists:
    """Duplicate splats into touched tiles, sort, and slice per-tile runs."""
    n = pre.mean_x.shape[0]
    tile = float(cfg.tile)
    ntx, nty = cfg.tiles_x, cfg.tiles_y

    # Tile rect touched by each splat's radius (inclusive bounds, clamped).
    x, y, r = pre.mean_x, pre.mean_y, pre.radius
    tx0 = jnp.clip(jnp.floor((x - r) / tile), 0, ntx - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor((x + r) / tile), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor((y - r) / tile), 0, nty - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor((y + r) / tile), 0, nty - 1).astype(jnp.int32)
    rw = tx1 - tx0 + 1
    rh = ty1 - ty0 + 1
    n_touched = rw * rh  # splats touching > max_dup tiles get truncated (see cfg)

    dkey = depth_key_bits(pre.depth, cfg.depth_bits)
    valid = pre.valid

    # Enumerate up to D duplicates per splat: j -> (j % rw, j // rw) offset.
    j = jnp.arange(cfg.max_dup, dtype=jnp.int32)[None, :]  # (1, D)
    dx = j % rw[:, None]
    dy = j // rw[:, None]
    tile_id = (ty0[:, None] + dy) * ntx + (tx0[:, None] + dx)  # (N, D)
    live = valid[:, None] & (j < n_touched[:, None]) & (dy < rh[:, None])

    sentinel = jnp.uint32(0xFFFFFFFF)
    keys = jnp.where(
        live,
        (tile_id.astype(jnp.uint32) << jnp.uint32(cfg.depth_bits)) | dkey[:, None],
        sentinel,
    ).reshape(-1)
    payload = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, cfg.max_dup)
    ).reshape(-1)

    sorted_keys, sorted_idx = jax.lax.sort((keys, payload), num_keys=1, is_stable=True)

    boundaries = (
        jnp.arange(cfg.n_tiles + 1, dtype=jnp.uint32) << jnp.uint32(cfg.depth_bits)
    )
    edges = jnp.searchsorted(sorted_keys, boundaries, side="left").astype(jnp.int32)
    tile_starts = edges[:-1]
    tile_counts = edges[1:] - edges[:-1]
    n_valid = jnp.sum(live.astype(jnp.int32))
    return TileLists(
        sorted_idx=sorted_idx,
        sorted_keys=sorted_keys,
        tile_starts=tile_starts,
        tile_counts=tile_counts,
        n_valid=n_valid,
    )


# Entries per packed row of the entry planes.
ROW = 128

# Field-plane order in the packed entry tensor.
PLANE_FIELDS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "alpha", "r", "g", "b")
N_PLANES = len(PLANE_FIELDS)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EntryPlanes:
    """v1 sorted entry storage (the test reference layout).

    Entries are packed 128 per row with each splat field on its own plane:

        ent (9, R, 128) f32 — planes mx, my, A, B, C, alpha, r, g, b

    and every tile's run starts on a row boundary (runs padded to a multiple
    of 128 with zero-alpha entries).
    """

    ent: jnp.ndarray          # (9, R, 128) f32
    row_starts: jnp.ndarray   # (n_tiles,) i32 — first packed row of each tile
    tile_counts: jnp.ndarray  # (n_tiles,) i32 — live entries per tile

    def tree_flatten(self):
        return ((self.ent, self.row_starts, self.tile_counts), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_entry_planes(pre: PreprocessOut, lists: TileLists, cfg: TileConfig) -> EntryPlanes:
    """Gather sorted splat data into the 128-aligned field-plane layout."""
    e = lists.sorted_idx.shape[0]
    n_tiles = cfg.n_tiles
    counts = lists.tile_counts
    aligned_counts = ((counts + ROW - 1) // ROW) * ROW
    aligned_starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(aligned_counts)]
    ).astype(jnp.int32)  # (n_tiles + 1,)

    # Static capacity: every tile may need up to ROW-1 padding entries.
    e_al = ((e + ROW - 1) // ROW) * ROW + ROW * n_tiles
    n_rows = e_al // ROW

    # Tile ownership is resolved per *row* (every tile's run is row-aligned),
    # keeping the expensive per-slot work to two large gathers.
    row_ids = jnp.arange(n_rows, dtype=jnp.int32)
    row_t = jnp.clip(
        jnp.searchsorted(aligned_starts // ROW, row_ids, side="right").astype(jnp.int32) - 1,
        0,
        n_tiles - 1,
    )
    # Per-row offsets into the unaligned sorted-entry array.
    row_delta = (lists.tile_starts - aligned_starts[:-1])[row_t]  # (n_rows,)
    row_end = (lists.tile_starts + counts)[row_t]

    j = row_ids[:, None] * ROW + jnp.arange(ROW, dtype=jnp.int32)[None, :]
    src_slot = j + row_delta[:, None]
    live = (src_slot < row_end[:, None]).reshape(-1)
    src_slot = jnp.clip(src_slot.reshape(-1), 0, e - 1)
    src = jnp.where(live, lists.sorted_idx[src_slot], 0)

    alpha_g = jnp.where(live, pre.alpha[src], 0.0)  # dead slots: exact no-ops
    planes = [
        pre.mean_x[src],
        pre.mean_y[src],
        pre.conic_a[src],
        pre.conic_b[src],
        pre.conic_c[src],
        alpha_g,
        pre.col_r[src],
        pre.col_g[src],
        pre.col_b[src],
    ]
    ent = jnp.stack(planes, axis=0).reshape(N_PLANES, e_al // ROW, ROW)
    return EntryPlanes(
        ent=ent,
        row_starts=aligned_starts[:-1] // ROW,
        tile_counts=counts,
    )


# ---------------------------------------------------------------------------
# v2: payload-carry binning — no post-sort gathers, no alignment pass.
#
# v2 packs the per-entry fields into the key low byte (alpha) plus THREE
# u32 payloads carried through the sort (no post-sort gather), sorts once,
# and hands the sorted planes (key included — it rides the sort for free)
# straight to the compositor, which reads each tile's unaligned run in place
# instead of re-aligning storage.
#
# Plane layout (planes[:, i, :]):
#   0: sort key        = tile | depth_q | alpha_u8  (depth_q: log-depth
#      normalized to the frame's occupied [dmin, dmax] — uniform resolution
#      over the scene instead of raw f32-exponent slicing)
#   1: mean_rel_x u12 . mean_rel_y u12 . b u8  (fixed-point 1/16 px, biased
#      +128: tile-relative means stay within ±128 px under center-out
#      max_dup truncation)
#   2: conic_a f16 | conic_b f16
#   3: conic_c f16 | r u8 . g u8
# ---------------------------------------------------------------------------

N_PACKED_PLANES = 4
MEAN_FIX_SCALE = 16.0   # 1/16-px fixed point for tile-relative means
MEAN_FIX_BIAS = 128.0




@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SortedEntries:
    """Sorted packed entries + per-tile ranges (v2 layout).

    planes (R, 4, 128) u32 — per entry (row-interleaved: an entry's four
    words lie in one 2 KB row); plane 0 is the sort key
    itself (tile | depth_q | alpha_u8), planes 1-3 the payloads — see the
    layout comment above. Runs are NOT row-aligned: tile t occupies entries
    [starts[t], starts[t]+counts[t]) of the flat sorted order; the compositor
    masks entries outside the run inside its first/last rows.
    """

    planes: jnp.ndarray       # (R, 4, 128) u32
    tile_starts: jnp.ndarray  # (n_tiles,) i32
    tile_counts: jnp.ndarray  # (n_tiles,) i32
    n_valid: jnp.ndarray      # () i32

    def tree_flatten(self):
        return ((self.planes, self.tile_starts, self.tile_counts, self.n_valid), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# f16 codec shared with the pod compression layer (core/f16.py); legacy
# aliases kept for the compositors and tests.
from ..core.f16 import (  # noqa: E402
    f16_bits_to_f32 as _f16_bits_to_f32,
    f32_to_f16_bits as _f32_to_f16_bits,
    pack2xf16 as _pack2xf16,
    unpack2xf16,
)


def _enum_cell(d: int, tx0, rw, ty0, rh):
    """Center-out cell d of a splat's tile rect: alternating offsets around
    the mean's cell in both axes, so truncation at max_dup drops the far
    corners (graceful dimming) instead of whole trailing rows (grid seams)."""
    m = jnp.remainder(jnp.int32(d), rw)   # within-row step
    k = jnp.floor_divide(jnp.int32(d), rw)  # row step
    off_x = ((m + 1) >> 1) * jnp.where((m & 1) == 1, 1, -1)
    off_y = ((k + 1) >> 1) * jnp.where((k & 1) == 1, 1, -1)
    etx = tx0 + (rw - 1) // 2 + off_x
    ety = ty0 + (rh - 1) // 2 + off_y
    return etx, ety


def _tight_cull_params(r_signed, p2s, p3s):
    """Per-splat tight-culling precursors, derived from the signed live
    radius (negative/zero = invalid) and the PACKED conic planes, so every
    enumeration culls with the same f16-rounded
    conic the compositor evaluates (culling is then exact w.r.t. the
    rendered contribution threshold, not the pre-quantization one).

    radius = sigma_max * cut and lambda_min(conic) = 1/sigma_max^2, so the
    live-boundary level of the quadratic form q(d) = a dx^2 + 2b dx dy +
    c dy^2 is cut2 = radius^2 * lambda_min. This reproduces
    2*ln(alpha/ALPHA_EPS) in splat mode and the flat power cutoff 4 in
    ellipse/point modes without any mode plumbing (preprocess already baked
    the mode into radius). The cut ellipse {q <= cut2} has the AABB
    half-extents sqrt(cov_xx * cut2) = radius * sqrt(c * lam_min / det)
    with cov = conic^{-1} — always <= radius, strictly smaller for
    anisotropic splats, so the tile rect shrinks by ~the aspect ratio.

    Returns ((cut2, a, b, c, 1/a, 1/c), rx, ry)."""
    a, b = unpack2xf16(p2s)
    c = _f16_bits_to_f32(p3s & jnp.uint32(0xFFFF))
    det = jnp.maximum(a * c - b * b, 1e-20)
    half = 0.5 * (a + c)
    lam_min = jnp.maximum(
        half - jnp.sqrt(jnp.maximum(half * half - det, 0.0)), 1e-12
    )
    r = jnp.maximum(r_signed, 0.0)
    cut2 = jnp.where(r_signed > 0, r * r * lam_min, -1.0)
    scale = jnp.sqrt(jnp.maximum(cut2, 0.0) / det)
    # min() guards f16 degenerate conics: mathematically the AABB is inside
    # the circle (c * lam_min / det = c / lam_max <= 1).
    # NB: for the few splats whose mean/extent lands within cross-backend
    # float wobble of a tile boundary, the rect (and with it the center-out
    # max_dup slot order) can differ between backends — quantizing rx/x
    # cannot reduce that flip probability (it is wobble/boundary-spacing
    # for any grid); the GPU image tests bound the effect statistically
    # instead (tests/test_image_gpu.py).
    rx = jnp.minimum(jnp.sqrt(jnp.maximum(c, 0.0)) * scale, r)
    ry = jnp.minimum(jnp.sqrt(jnp.maximum(a, 0.0)) * scale, r)
    inv_a = 1.0 / jnp.maximum(a, 1e-12)
    inv_c = 1.0 / jnp.maximum(c, 1e-12)
    return (cut2, a, b, c, inv_a, inv_c), rx, ry


def _cell_live(d: int, x, y, cull, tx0, rw, ty0, rh, n_touched, cfg: TileConfig):
    """Exact tile-cull test of center-out candidate cell d: returns
    (live, etx, ety). Keep the cell iff the Gaussian's contribution
    anywhere in the tile rect can reach the compositor's ALPHA_EPS floor,
    i.e. min over the rect of q(dx, dy) <= cut2. The min of a PD quadratic
    over a rect is 0 if the center is inside, else it lies on one of the
    four edges, where the 1D minimizer has a closed form (clamped to the
    edge segment). Rect corners and even whole edge bands of the
    circular-radius rect often miss the cut ellipse — this typically trims
    25-50% of candidate entries before the sort (anisotropy-dependent)."""
    cut2, ca, cb, cc, inv_a, inv_c = cull
    tile = float(cfg.tile)
    etx, ety = _enum_cell(d, tx0, rw, ty0, rh)
    ox = etx.astype(jnp.float32) * tile
    oy = ety.astype(jnp.float32) * tile
    dx0 = ox - x
    dx1 = dx0 + tile
    dy0 = oy - y
    dy1 = dy0 + tile
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)

    def q(dx, dy):
        return (ca * dx + 2.0 * cb * dy) * dx + cc * dy * dy

    yv0 = jnp.clip(-cb * dx0 * inv_c, dy0, dy1)  # vertical edge x = dx0
    yv1 = jnp.clip(-cb * dx1 * inv_c, dy0, dy1)
    xh0 = jnp.clip(-cb * dy0 * inv_a, dx0, dx1)  # horizontal edge y = dy0
    xh1 = jnp.clip(-cb * dy1 * inv_a, dx0, dx1)
    qmin = jnp.minimum(
        jnp.minimum(q(dx0, yv0), q(dx1, yv1)),
        jnp.minimum(q(xh0, dy0), q(xh1, dy1)),
    )
    qmin = jnp.where(inside, 0.0, qmin)
    # NaN-safe for invalid splats (garbage conics): NaN comparisons are
    # False and cut2 is -1 there, so live is False either way.
    live = (d < n_touched) & (qmin <= cut2)
    return live, etx, ety


def _cell_entry(live, etx, ety, x, y, key_lo, p1_base, cfg: TileConfig):
    """(live, tile coords) of one slot -> its packed (key, p1) planes."""
    tile = float(cfg.tile)
    ox = etx.astype(jnp.float32) * tile
    oy = ety.astype(jnp.float32) * tile
    tile_id = (ety * cfg.tiles_x + etx).astype(jnp.uint32)
    key = jnp.where(
        live,
        (tile_id << jnp.uint32(cfg._tile_shift)) | key_lo,
        jnp.uint32(0xFFFFFFFF),
    )
    # Mean relative to the entry's own tile origin, 1/16-px fixed point —
    # uniform precision, unlike f16 whose ulp grows away from the origin.
    mxq = (
        jnp.clip((x - ox + MEAN_FIX_BIAS) * MEAN_FIX_SCALE + 0.5, 0.0, 4095.0)
        .astype(jnp.int32)
        .astype(jnp.uint32)
    )
    myq = (
        jnp.clip((y - oy + MEAN_FIX_BIAS) * MEAN_FIX_SCALE + 0.5, 0.0, 4095.0)
        .astype(jnp.int32)
        .astype(jnp.uint32)
    )
    p1 = mxq | (myq << jnp.uint32(12)) | p1_base
    return key, p1


def _entry_planes_for_cell(
    d: int, x, y, cull, key_lo, p1_base, tx0, rw, ty0, rh, n_touched, cfg: TileConfig
):
    """One duplicate plane: (key, p1) for center-out cell d of every splat."""
    live, etx, ety = _cell_live(d, x, y, cull, tx0, rw, ty0, rh, n_touched, cfg)
    return _cell_entry(live, etx, ety, x, y, key_lo, p1_base, cfg)


def _entry_planes_all(
    x, y, cull, key_lo, p1_base, tx0, rw, ty0, rh, n_touched, cfg: TileConfig
):
    """All max_dup duplicate planes: list of (key, p1) per slot.

    With cfg.dup_scan = K > max_dup, slots are COMPACTED: slot d holds the
    d-th candidate among the K center-out candidates that passes the exact
    ellipse-tile test (instead of candidate d unconditionally), so live
    entries pack into the low slots and the sentinel slack that would ride
    the whole sort pipeline is never emitted. Candidate order is preserved
    (center-out), so truncation at max_dup still drops the farthest cells.
    """
    dmax = cfg.max_dup
    if not cfg.dup_scan or cfg.dup_scan <= dmax:
        return [
            _entry_planes_for_cell(
                d, x, y, cull, key_lo, p1_base, tx0, rw, ty0, rh, n_touched, cfg
            )
            for d in range(dmax)
        ]
    zero = jnp.zeros_like(tx0)
    cnt = zero
    sel_etx = [zero] * dmax
    sel_ety = [zero] * dmax
    for k in range(cfg.dup_scan):
        live_k, etx, ety = _cell_live(
            k, x, y, cull, tx0, rw, ty0, rh, n_touched, cfg
        )
        for d in range(dmax):
            take = live_k & (cnt == d)
            sel_etx[d] = jnp.where(take, etx, sel_etx[d])
            sel_ety[d] = jnp.where(take, ety, sel_ety[d])
        cnt = cnt + live_k.astype(jnp.int32)
    return [
        _cell_entry(cnt > d, sel_etx[d], sel_ety[d], x, y, key_lo, p1_base, cfg)
        for d in range(dmax)
    ]


def _splat_rect(x, y, rx, ry, cfg: TileConfig):
    """Tile rect of the per-axis half-extents (the cut ellipse's AABB)."""
    tile = float(cfg.tile)
    tx0 = jnp.clip(jnp.floor((x - rx) / tile), 0, cfg.tiles_x - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor((x + rx) / tile), 0, cfg.tiles_x - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor((y - ry) / tile), 0, cfg.tiles_y - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor((y + ry) / tile), 0, cfg.tiles_y - 1).astype(jnp.int32)
    rw = tx1 - tx0 + 1
    rh = ty1 - ty0 + 1
    return tx0, rw, ty0, rh, rw * rh


def _enumerate_entries_jnp(x, y, r_signed, key_lo, p1_base, p2s, p3s, cfg: TileConfig):
    """(D, N)-oriented enumeration (portable reference; the minor dim stays
    the large N so intermediates keep compact layouts)."""
    n = x.shape[0]
    dmax = cfg.max_dup
    cull, rx, ry = _tight_cull_params(r_signed, p2s, p3s)
    tx0, rw, ty0, rh, n_touched = _splat_rect(x, y, rx, ry, cfg)
    planes = _entry_planes_all(
        x, y, cull, key_lo, p1_base, tx0, rw, ty0, rh, n_touched, cfg
    )
    keys = [k for k, _ in planes]
    p1s = [p for _, p in planes]
    keys2d = jnp.stack(keys, axis=0)
    p1_2d = jnp.stack(p1s, axis=0)
    p2_2d = jnp.broadcast_to(p2s[None, :], (dmax, n))
    p3_2d = jnp.broadcast_to(p3s[None, :], (dmax, n))
    # Materialize exactly these four (D, N) arrays, then flatten each once.
    keys2d, p1_2d, p2_2d, p3_2d = jax.lax.optimization_barrier(
        (keys2d, p1_2d, p2_2d, p3_2d)
    )
    return (
        keys2d.reshape(-1),
        p1_2d.reshape(-1),
        p2_2d.reshape(-1),
        p3_2d.reshape(-1),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def enumerate_entries_from_pre(pre: PreprocessOut, cfg: TileConfig, model_rank=0):
    """Duplicate + pack: unsorted flat (keys, p1, p2, p3) entry planes.

    `model_rank` keys the fused multi-model pass (cfg.model_bits > 0,
    nearest model = 0).
    """
    x, y = pre.mean_x, pre.mean_y

    # --- per-splat precursors (N,) — fuse with whatever produced `pre` ---
    key_lo = depth_alpha_key_lo(pre.depth, pre.alpha, cfg, model_rank)
    r8 = jnp.clip(pre.col_r * 255.0 + 0.5, 0, 255).astype(jnp.uint32)
    g8 = jnp.clip(pre.col_g * 255.0 + 0.5, 0, 255).astype(jnp.uint32)
    b8 = jnp.clip(pre.col_b * 255.0 + 0.5, 0, 255).astype(jnp.uint32)
    p1_base = b8 << jnp.uint32(24)
    p2s = _pack2xf16(pre.conic_a, pre.conic_b)
    p3s = (
        _f32_to_f16_bits(pre.conic_c)
        | (r8 << jnp.uint32(16))
        | (g8 << jnp.uint32(24))
    )
    # Validity folded into the signed live radius: r_signed <= 0 maps to
    # cut2 = -1 inside _tight_cull_params, so invalid splats have no live
    # cells (qmin >= 0 > -1 always fails).
    r_signed = jnp.where(pre.valid, pre.radius, -1.0)

    # --- per-entry enumeration + packing (N*D,) ---
    return _enumerate_entries_jnp(x, y, r_signed, key_lo, p1_base, p2s, p3s, cfg)


def sort_entries(keys, p1, p2, p3):
    """One ascending key sort carrying the three payload planes."""
    return jax.lax.sort((keys, p1, p2, p3), num_keys=1, is_stable=False)


def sort_and_range_entries(keys, p1, p2, p3, cfg: TileConfig) -> SortedEntries:
    """Sort flat entry planes and slice the per-tile ranges."""
    return _sorted_entries_from_sorted(*sort_entries(keys, p1, p2, p3), cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_sorted_entries(
    pre: PreprocessOut, cfg: TileConfig, model_rank=0
) -> SortedEntries:
    """Duplicate -> pack -> sort-with-payloads -> per-tile ranges."""
    keys, p1, p2, p3 = enumerate_entries_from_pre(pre, cfg, model_rank)
    return sort_and_range_entries(keys, p1, p2, p3, cfg)


def _tile_edges(sk, cfg: TileConfig):
    boundaries = (
        jnp.arange(cfg.n_tiles + 1, dtype=jnp.uint32)
        << jnp.uint32(cfg._tile_shift)
    )
    return jnp.searchsorted(sk, boundaries, side="left").astype(jnp.int32)


def _sorted_entries_from_sorted(sk, s1, s2, s3, cfg: TileConfig) -> SortedEntries:
    """Shared tail: per-tile ranges + interleaved plane packing."""
    edges = _tile_edges(sk, cfg)
    tile_starts = edges[:-1]
    tile_counts = edges[1:] - edges[:-1]

    e = sk.shape[0]
    pad = (-e) % ROW

    def rows(pl):
        if pad:
            # Padding entries sit past every tile range; content irrelevant.
            pl = jnp.concatenate([pl, jnp.zeros(pad, jnp.uint32)])
        return pl.reshape(-1, ROW)

    # (R, 4, 128): an entry's four words lie in one row; plane 0 is the
    # sorted key (alpha in its low byte).
    planes = jnp.stack([rows(sk), rows(s1), rows(s2), rows(s3)], axis=1)
    # Live entries all key below the first out-of-range tile boundary and
    # sentinels above it, so the last searchsorted edge IS the live count —
    # no 24M reduction needed.
    n_valid = edges[cfg.n_tiles]
    return SortedEntries(
        planes=planes, tile_starts=tile_starts, tile_counts=tile_counts, n_valid=n_valid
    )
