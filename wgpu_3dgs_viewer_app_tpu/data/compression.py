"""On-the-fly quantized compression configs (the `GaussianPod` system).

Parity with reference:
- 8 concrete pod layouts `GaussianPodWithSh{Single|Half|Norm8|None}Cov3d
  {Single|Half}Configs` — dispatch at `src/tab/scene.rs:23-81`, size math at
  `src/app.rs:352-384`.
- Field split: position f32x3 and color u8x4 uncompressed; SH rest and cov3d
  compressed per config (`src/tab/scene.rs:907-1006`).
- Defaults: SH Norm8 + Cov3d Half (`src/app.rs:398-417`).

Design: the Rust crate monomorphizes 8 pod struct layouts at
compile time. Here a config is *data* — per-field dtype policy on a pytree of
device arrays. jit re-specializes the render function per dtype combination,
which is the XLA equivalent of monomorphization, with zero macro machinery.

Device layout per model (struct of arrays, ROW LAYOUT — the splat axis
is split (R, 128) with N padded to a multiple of 128, which is a plain
reshape of the flat splat axis; no 16-bit or
8-bit dtypes on device (f16/u8 data rides in u32 words, decoded with pure
integer math — core f16 codec in ops/binning.py)):
  pos      (3, R, 128) f32
  color0   (R, 128) u32 — packed r|g<<8|b<<16|a<<24; rgb = clamp(0.5+C0*sh0),
                          a = sigmoid(opacity), all u8. Padded splats have
                          a = 0 (always culled).
  sh       SH-rest coefficients per config (coeff-major):
             SINGLE (45, R, 128) f32
             HALF   (23, R, 128) u32 — coeffs (2j, 2j+1) packed per word
             NORM8  (12, R, 128) u32 — coeffs (4j..4j+3) packed per word,
                     plus sh_mn/sh_span (R, 128) f32
             REMOVE absent
  cov3d    SINGLE (6, R, 128) f32 | HALF (3, R, 128) u32 (f16 pairs)

`pack_gaussians(..., layout="flat")` produces the intermediate flat layout
((3, N), (N,), ... raw f16/u8 dtypes) used by the streaming upload path and
the native codec; `pod_rows` converts flat -> rows.
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np

from ..core.covariance import cov3d_from_scale_rot
from ..core.sh import SH_C0
from .gaussian import Gaussians, sigmoid


class ShCompression(enum.Enum):
    """Ref `ShCompression` (`src/app.rs:386-404`); default NORM8."""

    SINGLE = "single"
    HALF = "half"
    NORM8 = "norm8"
    REMOVE = "remove"


class Cov3dCompression(enum.Enum):
    """Ref `Cov3dCompression` (`src/app.rs:406-418`); default HALF."""

    SINGLE = "single"
    HALF = "half"


# Per-splat byte sizes of each field in *our* device layout.
POS_FIELD_SIZE = 12
COLOR_FIELD_SIZE = 4
SH_FIELD_SIZES = {
    ShCompression.SINGLE: 45 * 4,
    ShCompression.HALF: 45 * 2,
    ShCompression.NORM8: 45 * 1 + 8,  # u8 coeffs + f32 min/span
    ShCompression.REMOVE: 0,
}
COV3D_FIELD_SIZES = {
    Cov3dCompression.SINGLE: 6 * 4,
    Cov3dCompression.HALF: 6 * 2,
}


@dataclasses.dataclass(frozen=True)
class Compressions:
    """Compression selection. Ref `Compressions` (`src/app.rs:342-384`)."""

    sh: ShCompression = ShCompression.NORM8
    cov3d: Cov3dCompression = Cov3dCompression.HALF

    def bytes_per_splat(self) -> int:
        return (
            POS_FIELD_SIZE
            + COLOR_FIELD_SIZE
            + SH_FIELD_SIZES[self.sh]
            + COV3D_FIELD_SIZES[self.cov3d]
        )

    def compressed_size(self, gaussian_count: int) -> int:
        """Total compressed byte size. Ref `Compressions::compressed_size`
        (`src/app.rs:352-384`)."""
        return gaussian_count * self.bytes_per_splat()


ALL_COMPRESSIONS = tuple(
    Compressions(sh=s, cov3d=c) for s in ShCompression for c in Cov3dCompression
)


ROW = 128  # lane width; keep in sync with ops/binning.ROW


def _pack_f16_pairs(a: np.ndarray) -> np.ndarray:
    """(k, N) f16 -> (ceil(k/2), N) u32, word j = coeff 2j | coeff 2j+1 << 16."""
    k, n = a.shape
    u = a.view(np.uint16).astype(np.uint32)
    if k % 2:
        u = np.concatenate([u, np.zeros((1, n), np.uint32)])
    return u[0::2] | (u[1::2] << 16)


def _pack_u8_quads(a: np.ndarray) -> np.ndarray:
    """(k, N) u8 -> (ceil(k/4), N) u32, word j = coeffs 4j..4j+3, LSB first."""
    k, n = a.shape
    pad = (-k) % 4
    if pad:
        a = np.concatenate([a, np.zeros((pad, n), np.uint8)])
    u = a.astype(np.uint32)
    return u[0::4] | (u[1::4] << 8) | (u[2::4] << 16) | (u[3::4] << 24)


def flat_pod_to_words(pod: dict, comp: Compressions) -> dict:
    """Flat raw pod (f16/u8 dtypes) -> flat u32-word pod (splat axis last)."""
    out = {"pos": pod["pos"].astype(np.float32), "color0": pod["color0"]}
    if comp.sh == ShCompression.SINGLE:
        out["sh"] = pod["sh"].astype(np.float32)
    elif comp.sh == ShCompression.HALF:
        out["sh"] = _pack_f16_pairs(pod["sh"])
    elif comp.sh == ShCompression.NORM8:
        out["sh"] = _pack_u8_quads(pod["sh"])
        out["sh_mn"] = pod["sh_mn"]
        out["sh_span"] = pod["sh_span"]
    if comp.cov3d == Cov3dCompression.SINGLE:
        out["cov3d"] = pod["cov3d"].astype(np.float32)
    else:
        out["cov3d"] = _pack_f16_pairs(pod["cov3d"].astype(np.float16))
    return out


def pod_rows(flat: dict, comp: Compressions, capacity: int | None = None) -> dict:
    """Flat raw pod -> row layout (see module docstring).

    Pads the splat axis to `capacity` (rounded up to a lane multiple) with
    zeros — zero color0 means alpha 0, so padded splats never render.
    """
    words = flat_pod_to_words(flat, comp)
    n = words["color0"].shape[-1]
    cap = capacity if capacity is not None else n
    n_pad = -(-max(cap, 1) // ROW) * ROW
    out = {}
    for k, v in words.items():
        if n_pad != n:
            pad_shape = v.shape[:-1] + (n_pad - n,)
            v = np.concatenate([v, np.zeros(pad_shape, v.dtype)], axis=-1)
        out[k] = np.ascontiguousarray(v.reshape(v.shape[:-1] + (n_pad // ROW, ROW)))
    return out


def pod_capacity(pod: dict) -> int:
    """Padded splat capacity of a rows-layout pod."""
    return pod["color0"].shape[-2] * pod["color0"].shape[-1]


def pod_positions(pod: dict) -> np.ndarray:
    """Rows-layout pod -> (N_pad, 3) f32 world positions (host-side use)."""
    p = np.asarray(pod["pos"], np.float32)
    return p.reshape(3, -1).T


def pack_gaussians(
    g: Gaussians,
    comp: Compressions,
    use_native: bool | None = None,
    layout: str = "rows",
    capacity: int | None = None,
) -> dict:
    """Host-side pack: raw SoA -> compressed pod arrays (numpy).

    This is the CPU->pod compression applied on upload
    (`gaussians_buffer.update_range`, ref `src/tab/scene.rs:2076-2084`).

    When the gsnative C++ codec is built (native/gsnative.cpp) the fused
    multithreaded native path is used; `use_native=False` forces numpy.

    layout="rows" (default) returns the row layout; layout="flat" the
    intermediate flat layout (streaming-chunk path).
    """
    flat = _pack_gaussians_flat(g, comp, use_native)
    if layout == "flat":
        return flat
    return pod_rows(flat, comp, capacity=capacity)


def _pack_gaussians_flat(g: Gaussians, comp: Compressions, use_native) -> dict:
    if use_native is not False:
        from . import native as _native

        if _native.available():
            out = _native.pack_gaussians_native(g, comp)
            if out is not None:
                return out
    n = g.count
    pos = np.ascontiguousarray(g.pos.astype(np.float32).T)  # (3, N)
    rgb = np.clip(0.5 + SH_C0 * g.sh0, 0.0, 1.0)
    alpha = sigmoid(g.opacity)
    q8 = np.round(rgb * 255.0).astype(np.uint32)
    a8 = np.round(alpha * 255.0).astype(np.uint32)
    color0 = (q8[:, 0] | (q8[:, 1] << 8) | (q8[:, 2] << 16) | (a8 << 24)).astype(np.uint32)

    sh_flat = np.ascontiguousarray(g.sh_rest.reshape(n, 45).astype(np.float32).T)  # (45, N)
    out = {"pos": pos, "color0": color0}
    if comp.sh == ShCompression.SINGLE:
        out["sh"] = sh_flat
    elif comp.sh == ShCompression.HALF:
        out["sh"] = sh_flat.astype(np.float16)
    elif comp.sh == ShCompression.NORM8:
        mn = sh_flat.min(axis=0) if n else np.zeros(0, np.float32)
        mx = sh_flat.max(axis=0) if n else np.zeros(0, np.float32)
        span = np.maximum(mx - mn, 1e-12)
        q = np.round((sh_flat - mn[None, :]) / span[None, :] * 255.0).astype(np.uint8)
        out["sh"] = q
        out["sh_mn"] = mn.astype(np.float32)
        out["sh_span"] = span.astype(np.float32)
    # REMOVE: no sh field.

    scale_lin = np.exp(g.scale.astype(np.float32))
    cov6 = np.asarray(cov3d_from_scale_rot(jnp.asarray(scale_lin), jnp.asarray(g.rot)))
    cov6 = np.ascontiguousarray(cov6.T)  # (6, N)
    if comp.cov3d == Cov3dCompression.SINGLE:
        out["cov3d"] = cov6.astype(np.float32)
    else:
        out["cov3d"] = cov6.astype(np.float16)
    return out


def _rows_flat(a: jnp.ndarray) -> jnp.ndarray:
    """(..., R, 128) rows field -> (..., N_pad) flat view."""
    return a.reshape(a.shape[:-2] + (-1,))


def unpack_sh(pod: dict, comp: Compressions) -> jnp.ndarray:
    """Device-side dequantization: rows pod sh field -> (N_pad, 15, 3) f32
    (test/reference use; the fused preprocess uses `make_sh_coeff_fn`)."""
    n = pod_capacity(pod)
    coeff = make_sh_coeff_fn(pod, comp)
    cols = [coeff(k, c) for k in range(15) for c in range(3)]
    return jnp.stack(cols, axis=-1).reshape(n, 15, 3)


def make_sh_coeff_fn(pod: dict, comp: Compressions):
    """Per-coefficient dequantizer: (k, c) -> (N_pad,) f32 column over the
    rows/words layout (module docstring). Avoids materializing the
    (N, 15, 3) tensor — see the core/covariance.py note."""
    from ..core.f16 import f16_bits_to_f32

    if comp.sh == ShCompression.REMOVE:
        zero = jnp.zeros(pod_capacity(pod), jnp.float32)
        return lambda k, c: zero
    sh = pod["sh"]
    if comp.sh == ShCompression.NORM8:
        mn = _rows_flat(pod["sh_mn"])
        scale = _rows_flat(pod["sh_span"]) * jnp.float32(1.0 / 255.0)

        def coeff(k, c):
            i = k * 3 + c
            w = _rows_flat(sh[i // 4])
            q = (w >> jnp.uint32(8 * (i % 4))) & jnp.uint32(0xFF)
            return q.astype(jnp.int32).astype(jnp.float32) * scale + mn

        return coeff
    if comp.sh == ShCompression.HALF:

        def coeff(k, c):
            i = k * 3 + c
            w = _rows_flat(sh[i // 2])
            h = (w >> jnp.uint32(16 * (i % 2))) & jnp.uint32(0xFFFF)
            return f16_bits_to_f32(h)

        return coeff

    def coeff(k, c):
        return _rows_flat(sh[k * 3 + c]).astype(jnp.float32)

    return coeff


def unpack_cov3d(pod: dict) -> jnp.ndarray:
    """Rows pod cov3d field -> (N_pad, 6) f32 (test/reference use)."""
    return jnp.stack(cov3d_components(pod), axis=-1)


def cov3d_components(pod: dict) -> tuple:
    """Six (N_pad,) f32 covariance uniques (xx, xy, xz, yy, yz, zz)."""
    from ..core.f16 import unpack2xf16

    c = pod["cov3d"]
    if c.dtype == jnp.uint32 or c.dtype == np.uint32:
        out = []
        for j in range(3):
            lo, hi = unpack2xf16(_rows_flat(c[j]))
            out += [lo, hi]
        return tuple(out)
    return tuple(_rows_flat(c[i]).astype(jnp.float32) for i in range(6))


def unpack_color0(pod: dict) -> tuple:
    """Packed u32 rgba -> (rgb (N_pad, 3) f32, alpha (N_pad,) f32)."""
    w = _rows_flat(pod["color0"])
    s = jnp.float32(1.0 / 255.0)
    r = (w & jnp.uint32(0xFF)).astype(jnp.int32).astype(jnp.float32) * s
    g = ((w >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.int32).astype(jnp.float32) * s
    b = ((w >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.int32).astype(jnp.float32) * s
    a = ((w >> jnp.uint32(24)) & jnp.uint32(0xFF)).astype(jnp.int32).astype(jnp.float32) * s
    return jnp.stack([r, g, b], axis=-1), a
