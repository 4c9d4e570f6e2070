"""Tile-local front-to-back alpha compositing — the replacement for the
crate's `Renderer` draw-indirect rasterization + hardware blending
(reference `src/tab/scene.rs:2306-2313`, 12-buffer contract at
`src/tab/scene.rs:1854-1867`).

The screen is cut into `tile x tile` pixel tiles; binning (ops/binning.py)
hands each tile a depth-sorted run of entries. Every pixel blends its
tile's run front to back, and a tile stops once every one of its pixels is
saturated (transmittance < T_EPS) — fragment-level early termination.

Implementations with identical math:
  composite_tiles_jnp    — v1 field-plane layout, jnp; a test reference.
  composite_tiles_jnp_v2 — v2 packed layout (`SortedEntries`), jnp; the CPU
                           path and the reference for the GPU kernel.
  composite_tiles_gpu    — v2 layout, Pallas kernel through Triton: one
                           program per tile, as in the 3DGS CUDA rasterizer
                           (Kerbl et al. 2023).
`composite_tiles_v2` picks between the last two by implementation name
(ops/backend.render_impl).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .binning import (
    ALPHA_MAX,
    MEAN_FIX_BIAS,
    MEAN_FIX_SCALE,
    N_PACKED_PLANES,
    ROW,
    EntryPlanes,
    SortedEntries,
    TileConfig,
    _f16_bits_to_f32,
    unpack2xf16,
)

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1.0 / 255.0
# ALPHA_MAX is imported from binning (single source of truth with the
# enumeration key's u8 alpha clamp).
FLAT_POWER_CUTOFF = -2.0  # ellipse/point: flat fill inside 2-sigma boundary


def _chunk_alpha(chunk, px, py, flat_mode: bool):
    """chunk (9, 1, C) field rows + pixel columns (P, 1) -> (P, C) alpha.

    Returns (alpha, r, g, b) with the color rows broadcastable (1, C).
    """
    mx, my = chunk[0], chunk[1]      # (1, C)
    ca, cb, cc = chunk[2], chunk[3], chunk[4]
    op = chunk[5]
    r, g, b = chunk[6], chunk[7], chunk[8]
    dx = px - mx                      # (P, C)
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    if flat_mode:
        a = jnp.where(power >= FLAT_POWER_CUTOFF, op, 0.0)
        a = jnp.broadcast_to(a, power.shape)
    else:
        a = op * jnp.exp(jnp.minimum(power, 0.0))  # see _alpha_from_power
    a = jnp.minimum(a, ALPHA_MAX)
    a = jnp.where(a < ALPHA_EPS, 0.0, a)
    return a, r, g, b


def _excl_cumprod(om: jnp.ndarray):
    """Inclusive and exclusive cumulative product along the last axis."""
    incl = jnp.cumprod(om, axis=-1)
    excl = jnp.concatenate([jnp.ones_like(om[..., :1]), incl[..., :-1]], axis=-1)
    return incl, excl


def _tiles_to_image(tiles: jnp.ndarray, cfg: TileConfig) -> jnp.ndarray:
    """(n_tiles, P, 4) per-tile pixels -> (H, W, 4) image."""
    tile = cfg.tile
    ntx, nty = cfg.tiles_x, cfg.tiles_y
    img = tiles.reshape(nty, ntx, tile, tile, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile, ntx * tile, 4)
    return img[: cfg.height, : cfg.width]


# ---------------------------------------------------------------------------
# v1 layout, jnp
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "flat_mode"))
def composite_tiles_jnp(
    planes: EntryPlanes,
    cfg: TileConfig,
    flat_mode: bool = False,
) -> jnp.ndarray:
    """Returns (H, W, 4) f32: premultiplied rgb + coverage alpha."""
    tile = cfg.tile
    p = tile * tile
    ntx = cfg.tiles_x
    ent = planes.ent  # (9, R, 128)

    tile_ids = jnp.arange(cfg.n_tiles, dtype=jnp.int32)
    origin_x = (tile_ids % ntx) * tile
    origin_y = (tile_ids // ntx) * tile
    lane = jnp.arange(p, dtype=jnp.int32)

    def one_tile(row_start, count, ox, oy):
        px = ((ox + lane % tile).astype(jnp.float32) + 0.5)[:, None]  # (P, 1)
        py = ((oy + lane // tile).astype(jnp.float32) + 0.5)[:, None]
        n_chunks = (count + ROW - 1) // ROW

        def cond(state):
            c, t, _ = state
            return (c < n_chunks) & (jnp.max(t) > T_EPS)

        def body(state):
            c, t, rgb = state
            chunk = jax.lax.dynamic_slice(ent, (0, row_start + c, 0), (9, 1, ROW))
            a, r, g, b = _chunk_alpha(chunk, px, py, flat_mode)
            incl, excl = _excl_cumprod(1.0 - a)
            w = t * excl * a  # (P, C)
            rgb = rgb + jnp.stack(
                [jnp.sum(w * r, -1), jnp.sum(w * g, -1), jnp.sum(w * b, -1)], -1
            )
            t = t * incl[:, -1:]
            return c + 1, t, rgb

        c0 = jnp.int32(0)
        t0 = jnp.ones((p, 1), jnp.float32)
        rgb0 = jnp.zeros((p, 3), jnp.float32)
        _, t, rgb = jax.lax.while_loop(cond, body, (c0, t0, rgb0))
        return jnp.concatenate([rgb, 1.0 - t], axis=1)  # (P, 4)

    tiles = jax.vmap(one_tile)(planes.row_starts, planes.tile_counts, origin_x, origin_y)
    return _tiles_to_image(tiles, cfg)


def over_background(img: jnp.ndarray, background: jnp.ndarray) -> jnp.ndarray:
    """Composite premultiplied (H, W, 4) over an opaque background color."""
    bg = jnp.asarray(background, jnp.float32)
    rgb = img[..., :3] + (1.0 - img[..., 3:4]) * bg
    return rgb


# ---------------------------------------------------------------------------
# v2 layout: payload-carry `SortedEntries` (see the binning v2 note) —
# packed u32 planes, unaligned runs, means tile-relative.
# ---------------------------------------------------------------------------


def _u8_unit(w, shift):
    """Bits [shift, shift+8) of u32 -> f32 in [0, 1]."""
    return ((w >> jnp.uint32(shift)) & jnp.uint32(0xFF)).astype(jnp.int32).astype(
        jnp.float32
    ) * jnp.float32(1.0 / 255.0)


LOG2E = 1.4426950408889634  # the alpha pipeline works in log2 units


def _chunk_alpha_packed(key, p1, p2, p3, px, py, live, flat_mode: bool):
    """Packed u32 entry words + tile-local pixel coords -> alpha per
    (pixel, entry), broadcasting entries against pixels.

    Plane layout per ops/binning.py: key carries alpha in its low byte
    (pre-clamped to ALPHA_MAX at enumeration); p1 = mean u12.u12 + b u8;
    p2 = conic_ab f16s; p3 = conic_c f16 + r.g u8.

    Everything per entry is folded before the per-pixel work: the -0.5
    factor, the exp->exp2 base change and the sign all pre-scale the conic,
    so the quadratic costs few per-pixel ops.
    """
    op = _u8_unit(key, 0)
    inv = jnp.float32(1.0 / MEAN_FIX_SCALE)
    mx = (p1 & jnp.uint32(0xFFF)).astype(jnp.int32).astype(jnp.float32) * inv - MEAN_FIX_BIAS
    my = ((p1 >> jnp.uint32(12)) & jnp.uint32(0xFFF)).astype(jnp.int32).astype(
        jnp.float32
    ) * inv - MEAN_FIX_BIAS
    b = _u8_unit(p1, 24)
    ca, cb = unpack2xf16(p2)
    cc = _f16_bits_to_f32(p3 & jnp.uint32(0xFFFF))
    r = _u8_unit(p3, 16)
    g = _u8_unit(p3, 24)
    return _gaussian_alpha(op, mx, my, ca, cb, cc, px, py, live, flat_mode) + (r, g, b)


def _gaussian_alpha(op, mx, my, ca, cb, cc, px, py, live, flat_mode):
    # Per-entry prep: -0.5 * log2(e) folded into the conic.
    s = jnp.float32(-0.5 * LOG2E)
    a2 = ca * s
    b2 = cb * jnp.float32(-LOG2E)
    c2 = cc * s
    dx = px - mx
    dy = py - my
    # power2 = log2-units exponent: (a2*dx + b2*dy)*dx + (c2*dy)*dy
    power2 = (a2 * dx + b2 * dy) * dx + (c2 * dy) * dy
    return (_alpha_from_power(power2, op, live, flat_mode),)


def _alpha_from_power(power2, op, live, flat_mode):
    """power2 is the Gaussian exponent in LOG2 units (pre-scaled conic)."""
    # Dead entries zero out through the per-entry opacity.
    op = jnp.where(live, op, 0.0)
    if flat_mode:
        a = jnp.where(power2 >= jnp.float32(FLAT_POWER_CUTOFF * LOG2E), op, 0.0)
        a = jnp.broadcast_to(a, power2.shape)
    else:
        # Clamp power to <= 0 instead of hard-masking power > 0: the quadratic
        # form is only positive through f16/rearrangement wobble, and a hard
        # cut sits exactly on the splat center (power == 0) where any +/-eps
        # flips the center pixel between full alpha and a hole.
        # ALPHA_MAX is pre-applied to the key's alpha byte at enumeration,
        # so no per-pixel clamp is needed here.
        a = op * jnp.exp2(jnp.minimum(power2, 0.0))
    return jnp.where(a < ALPHA_EPS, 0.0, a)


@functools.partial(jax.jit, static_argnames=("cfg", "flat_mode"))
def composite_tiles_jnp_v2(
    entries: SortedEntries,
    cfg: TileConfig,
    flat_mode: bool = False,
) -> jnp.ndarray:
    """Portable v2 compositor. Returns (H, W, 4) premultiplied rgba."""
    tile = cfg.tile
    p = tile * tile
    planes = entries.planes  # (R, 4, 128)

    lane = jnp.arange(p, dtype=jnp.int32)
    px_local = (lane % tile).astype(jnp.float32)[:, None] + 0.5  # (P, 1)
    py_local = (lane // tile).astype(jnp.float32)[:, None] + 0.5
    col = jnp.arange(ROW, dtype=jnp.int32)[None, :]  # (1, C)

    def one_tile(start, count):
        row0 = start // ROW
        n_chunks = jnp.where(count > 0, (start + count + ROW - 1) // ROW - row0, 0)

        def cond(state):
            c, t, _ = state
            return (c < n_chunks) & (jnp.max(t) > T_EPS)

        def body(state):
            c, t, rgb = state
            chunk = jax.lax.dynamic_slice(
                planes, (row0 + c, 0, 0), (1, N_PACKED_PLANES, ROW)
            )[0]
            gidx = (row0 + c) * ROW + col  # global entry index (1, C)
            live = (gidx >= start) & (gidx < start + count)
            a, r, g, b = _chunk_alpha_packed(
                chunk[0:1], chunk[1:2], chunk[2:3], chunk[3:4], px_local, py_local, live, flat_mode
            )
            incl, excl = _excl_cumprod(1.0 - a)
            # t is constant within the chunk: fold it AFTER the lane
            # reduction ((P, 3) narrow mult) instead of into the (P, C) w.
            w = excl * a
            rgb = rgb + t * jnp.stack(
                [jnp.sum(w * r, -1), jnp.sum(w * g, -1), jnp.sum(w * b, -1)], -1
            )
            t = t * incl[:, -1:]
            return c + 1, t, rgb

        c0 = jnp.int32(0)
        t0 = jnp.ones((p, 1), jnp.float32)
        rgb0 = jnp.zeros((p, 3), jnp.float32)
        _, t, rgb = jax.lax.while_loop(cond, body, (c0, t0, rgb0))
        return jnp.concatenate([rgb, 1.0 - t], axis=1)

    tiles = jax.vmap(one_tile)(entries.tile_starts, entries.tile_counts)
    return _tiles_to_image(tiles, cfg)


# ---------------------------------------------------------------------------
# v2 layout, GPU: Pallas through Triton
# ---------------------------------------------------------------------------

# Pixels each thread owns: tile 16 -> 2 warps, tile 32 -> 8 warps.
_PIXELS_PER_THREAD = 4


def _entry_words(planes_ref, e):
    """The four packed u32 words of flat entry `e` (scalar loads)."""
    row, lane = e // ROW, e % ROW
    return tuple(planes_ref[row, k, lane] for k in range(N_PACKED_PLANES))


def _composite_kernel_gpu(starts_ref, counts_ref, planes_ref, out_ref, *,
                          tile: int, flat_mode: bool):
    """One program per tile; every pixel of the tile is one lane of a (P,)
    vector held in registers.

    Entries are walked one at a time in depth order (the next entry's words
    are loaded while the current one is blended). The early-exit test runs
    at every 128-entry row boundary of the flat entry order, exactly where
    `composite_tiles_jnp_v2` tests it, so both stop after the same entries.
    """
    t = pl.program_id(0)
    start = starts_ref[t]
    end = start + counts_ref[t]
    row0 = start // ROW
    n_rows = jnp.where(end > start, (end + ROW - 1) // ROW - row0, 0)
    pix = jax.lax.broadcasted_iota(jnp.int32, (tile * tile,), 0)
    px = (pix % tile).astype(jnp.float32) + 0.5
    py = (pix // tile).astype(jnp.float32) + 0.5

    def row_body(state):
        c, acc = state
        base = (row0 + c) * ROW
        lo = jnp.maximum(base, start)
        hi = jnp.minimum(base + ROW, end)

        def entry(e, carry):
            words, tr, cr, cg, cb = carry
            nxt = _entry_words(planes_ref, jnp.minimum(e + 1, hi - 1))
            a, r, g, b = _chunk_alpha_packed(*words, px, py, True, flat_mode)
            w = tr * a
            return nxt, tr * (1.0 - a), cr + w * r, cg + w * g, cb + w * b

        carry = jax.lax.fori_loop(lo, hi, entry, (_entry_words(planes_ref, lo), *acc))
        return c + 1, carry[1:]

    def row_cond(state):
        c, (tr, *_) = state
        return (c < n_rows) & (jnp.max(tr) > T_EPS)

    one = jnp.ones((tile * tile,), jnp.float32)
    zero = jnp.zeros((tile * tile,), jnp.float32)
    _, (tr, cr, cg, cb) = jax.lax.while_loop(
        row_cond, row_body, (jnp.int32(0), (one, zero, zero, zero))
    )
    out_ref[0, :] = cr
    out_ref[1, :] = cg
    out_ref[2, :] = cb
    out_ref[3, :] = 1.0 - tr


@functools.partial(jax.jit, static_argnames=("cfg", "flat_mode", "interpret"))
def composite_tiles_gpu(
    entries: SortedEntries,
    cfg: TileConfig,
    flat_mode: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """GPU v2 compositor (Pallas, Triton route). Returns (H, W, 4)
    premultiplied rgba. `interpret` runs the kernel through the Pallas
    interpreter; only tests set it."""
    tile = cfg.tile
    p = tile * tile
    if p & (p - 1):
        raise ValueError(f"tile {tile}: Triton blocks need a power-of-two pixel count")
    kernel = functools.partial(_composite_kernel_gpu, tile=tile, flat_mode=flat_mode)
    tiles = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((cfg.n_tiles, 4, p), jnp.float32),
        grid=(cfg.n_tiles,),
        out_specs=pl.BlockSpec((None, 4, p), lambda t: (t, 0, 0)),
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, p // (32 * _PIXELS_PER_THREAD)), num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="composite_tiles_gpu",
    )(entries.tile_starts, entries.tile_counts, entries.planes)
    return _tiles_to_image(tiles.transpose(0, 2, 1), cfg)


def composite_tiles_v2(
    entries: SortedEntries, cfg: TileConfig, flat_mode: bool, impl: str
) -> jnp.ndarray:
    """The v2 compositor for implementation `impl` ("gpu" or "cpu")."""
    if impl == "gpu":
        return composite_tiles_gpu(entries, cfg, flat_mode=flat_mode)
    if impl == "cpu":
        return composite_tiles_jnp_v2(entries, cfg, flat_mode=flat_mode)
    raise ValueError(f"unknown render implementation {impl!r}")
