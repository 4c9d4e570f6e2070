"""Fused per-splat preprocess: the JAX equivalent of the crate's
`Preprocessor` compute pass (driven at reference `src/tab/scene.rs:856-863`,
16-buffer contract at `src/tab/scene.rs:1835-1852`).

One jit-fused elementwise pass over all N splats computing, per splat:
  model+view transform -> frustum cull -> 3D cov -> 2D conic (EWA) ->
  SH->RGB for the active degree -> mask gate -> per-splat edit ->
  selection edit + highlight -> depth key
No compaction: XLA wants static shapes, so culled splats carry valid=False
and zero alpha; the binning stage drops them from the sort by keying them to
the sentinel bucket (SURVEY §7 hard-part (3)).

Everything here is elementwise/small-matmul over (N, ...) arrays: XLA fuses
it into a handful of elementwise kernels; no hand-written kernel needed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.covariance import (
    cov2d_to_conic_radius,
    project_cov3d_to_cov2d,
    transform_cov6_t,
)
from ..core.edit import apply_edit
from ..core.sh import eval_sh_rest_channels
from ..data.compression import (
    Compressions,
    cov3d_components,
    make_sh_coeff_fn,
    unpack_color0,
)

ALPHA_EPS = 1.0 / 255.0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PreprocessOut:
    """Per-splat screen-space quantities.

    All fields are FLAT (N,) f32 (valid: bool) — hot consumers (binning,
    sharded renderer) read the flat fields; the `mean2d`/`conic`/`rgb`
    properties serve small-scale consumers (queries, oracle rasterizer,
    tests)."""

    mean_x: jnp.ndarray   # pixel coords
    mean_y: jnp.ndarray
    conic_a: jnp.ndarray  # inverse 2D covariance (A, B, C)
    conic_b: jnp.ndarray
    conic_c: jnp.ndarray
    col_r: jnp.ndarray
    col_g: jnp.ndarray
    col_b: jnp.ndarray
    alpha: jnp.ndarray    # opacity after edits/gates
    depth: jnp.ndarray    # view-space depth (>0 in front)
    radius: jnp.ndarray   # pixel radius of the live extent
    valid: jnp.ndarray    # bool — survives culling/gating

    @property
    def mean2d(self) -> jnp.ndarray:  # (N, 2)
        return jnp.stack([self.mean_x, self.mean_y], axis=-1)

    @property
    def conic(self) -> jnp.ndarray:  # (N, 3)
        return jnp.stack([self.conic_a, self.conic_b, self.conic_c], axis=-1)

    @property
    def rgb(self) -> jnp.ndarray:  # (N, 3)
        return jnp.stack([self.col_r, self.col_g, self.col_b], axis=-1)

    def tree_flatten(self):
        return (
            (
                self.mean_x, self.mean_y,
                self.conic_a, self.conic_b, self.conic_c,
                self.col_r, self.col_g, self.col_b,
                self.alpha, self.depth, self.radius, self.valid,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def camera_position_from_view(view: jnp.ndarray) -> jnp.ndarray:
    """Camera world position from a rigid view matrix: -R^T t."""
    r = view[:3, :3]
    t = view[:3, 3]
    return -jnp.matmul(r.T, t, precision=jax.lax.Precision.HIGHEST)


@functools.partial(
    jax.jit,
    static_argnames=("comp", "sh_degree", "no_sh0", "width", "height", "display_mode"),
)
def preprocess(
    pod: dict,
    comp: Compressions,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    model: jnp.ndarray,
    width: int,
    height: int,
    sh_degree: int = 3,
    no_sh0: bool = False,
    size: float = 1.0,
    display_mode: int = 0,
    z_near: float = 0.1,
    z_far: float = 1e4,
    mask_bits: Optional[jnp.ndarray] = None,
    edit: Optional[tuple] = None,
    selection_bits: Optional[jnp.ndarray] = None,
    selection_edit: Optional[tuple] = None,
    highlight_rgba: Optional[jnp.ndarray] = None,
) -> PreprocessOut:
    """The fused preprocess pass.

    pod: compressed device arrays (see data/compression.py).
    view/proj: (4, 4) f32; model: (4, 4) f32 model matrix (TRS).
    edit: optional per-splat (flags (N,), rgb (N,3), params (N,4)).
    selection_edit: optional scene-wide (flags (), rgb (3,), params (4,))
        applied to splats whose selection bit is set
        (ref `update_selection_edit_with_pod`, `src/tab/scene.rs:815-829`).
    highlight_rgba: optional (4,) selection highlight tint
        (ref `SelectionHighlightPod`, applied in the crate's render stage).
    mask_bits/selection_bits: (N,) uint8/bool gates
        (ref mask_buffer / selection_buffer, `src/tab/scene.rs:1848-1851`).
    """
    pos = pod["pos"].reshape(3, -1)  # rows (3, R, 128) -> (3, N_pad)
    n = pos.shape[1]
    color0_rgb, color0_a = unpack_color0(pod)
    cov6c = cov3d_components(pod)  # six (N_pad,) uniques

    # All fixed-size matrix algebra is component-expanded over (N,) arrays
    # (core/covariance.py note): f32 elementwise math, no tiny matmuls.

    # --- model transform ---
    m3 = model[:3, :3]
    p_world = _apply_affine((pos[0, :], pos[1, :], pos[2, :]), m3, model[:3, 3])
    # Covariance transforms with the linear part: Sigma' = M3 Sigma M3^T.
    # The gaussian `size` multiplier scales the splat extent (sigma *= size),
    # i.e. Sigma *= size^2, applied before the screen-space dilation.
    s2 = jnp.float32(size) * jnp.float32(size)
    cov6_w = tuple(c * s2 for c in transform_cov6_t(cov6c, m3))

    # --- view transform + depth ---
    v3 = view[:3, :3]
    t_view = _apply_affine(p_world, v3, view[:3, 3])
    depth = -t_view[2]

    # --- projection to pixels ---
    fx = 0.5 * width * proj[0, 0]
    fy = 0.5 * height * proj[1, 1]
    tan_half_fov_x = 1.0 / proj[0, 0]
    tan_half_fov_y = 1.0 / proj[1, 1]
    d = jnp.maximum(depth, 1e-6)
    ndc_x = proj[0, 0] * t_view[0] / d
    ndc_y = proj[1, 1] * t_view[1] / d
    px = (ndc_x * 0.5 + 0.5) * width
    py = (0.5 - ndc_y * 0.5) * height

    # --- 2D covariance / conic ---
    cov2d = project_cov3d_to_cov2d(
        cov6_w, t_view, v3, (fx, fy), (tan_half_fov_x, tan_half_fov_y)
    )
    (conic_a, conic_b, conic_c), radius, det_ok = cov2d_to_conic_radius(cov2d)
    if display_mode == 2:
        # POINT: fixed pixel radius flat disc. Conic is set so that the
        # compositor's flat-threshold test (power >= -2) equals dist <= r:
        # power = -0.5 * (A dx^2 + C dy^2) with A = C = 4 / r^2.
        # `size` may be a traced array (the viewer feeds it as a device
        # scalar so size changes don't recompile) — keep this in jnp.
        r_pt = jnp.maximum(2.0 * jnp.asarray(size, jnp.float32), 1.0)
        radius = jnp.broadcast_to(r_pt, radius.shape)
        inv = 4.0 / (r_pt * r_pt)
        conic_a = jnp.broadcast_to(inv, radius.shape)
        conic_b = jnp.zeros_like(radius)
        conic_c = conic_a

    # --- SH -> RGB ---
    cam_pos = camera_position_from_view(view)
    c0r = (color0_rgb[:, 0], color0_rgb[:, 1], color0_rgb[:, 2])
    if sh_degree >= 1:
        dx = p_world[0] - cam_pos[0]
        dy = p_world[1] - cam_pos[1]
        dz = p_world[2] - cam_pos[2]
        inv_n = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-18))
        coeff = make_sh_coeff_fn(pod, comp)
        # Degree-0 term comes from the u8 color0 (0.5 + C0*sh0 pre-baked).
        dr, dg, db = eval_sh_rest_channels(
            coeff, dx * inv_n, dy * inv_n, dz * inv_n, sh_degree
        )
        base = c0r if not no_sh0 else (0.5, 0.5, 0.5)
        col = (dr + base[0], dg + base[1], db + base[2])
    else:
        col = c0r if not no_sh0 else tuple(jnp.full_like(c, 0.5) for c in c0r)
    col_r, col_g, col_b = (jnp.clip(c, 0.0, 1.0) for c in col)
    alpha = color0_a

    # --- gates + edits ---
    valid = det_ok & (depth > z_near) & (depth < z_far)
    if mask_bits is not None:
        valid = valid & (mask_bits.astype(jnp.bool_))
    # Edits operate on stacked (N, 3) rgb — only materialized when edits are
    # active (the editing UI path), never in the plain render hot path.
    if edit is not None:
        e_flags, e_rgb, e_params = edit
        rgb, alpha, hidden = apply_edit(
            jnp.stack([col_r, col_g, col_b], -1),
            alpha,
            e_flags.astype(jnp.uint32),
            e_rgb,
            e_params,
        )
        col_r, col_g, col_b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        valid = valid & ~hidden
    if selection_bits is not None and selection_edit is not None:
        s_flags, s_rgb, s_params = selection_edit
        sel = selection_bits.astype(jnp.bool_)
        nf = jnp.where(sel, jnp.asarray(s_flags, jnp.uint32), jnp.uint32(0))
        rgb2, alpha2, hidden2 = apply_edit(
            jnp.stack([col_r, col_g, col_b], -1),
            alpha,
            nf,
            jnp.broadcast_to(s_rgb, (n, 3)),
            jnp.broadcast_to(s_params, (n, 4)),
        )
        col_r, col_g, col_b = rgb2[:, 0], rgb2[:, 1], rgb2[:, 2]
        alpha = alpha2
        valid = valid & ~hidden2
    if selection_bits is not None and highlight_rgba is not None:
        sel = selection_bits.astype(jnp.bool_)
        hl = jnp.asarray(highlight_rgba, jnp.float32)
        col_r = jnp.where(sel, col_r * (1.0 - hl[3]) + hl[0] * hl[3], col_r)
        col_g = jnp.where(sel, col_g * (1.0 - hl[3]) + hl[1] * hl[3], col_g)
        col_b = jnp.where(sel, col_b * (1.0 - hl[3]) + hl[2] * hl[3], col_b)

    # --- opacity-aware extent ---
    # cov2d_to_conic_radius returns a flat 3-sigma radius. The compositor
    # zeroes contributions below ALPHA_EPS, so the exact live extent is
    # sigma * sqrt(2 ln(alpha/ALPHA_EPS)) in splat mode (larger than 3 sigma
    # for alpha ~ 1, much smaller for dim splats — fewer tile entries), and
    # exactly 2 sigma in ellipse mode (flat fill cuts at power = -2). Point
    # mode's radius is already exact.
    if display_mode == 0:
        cut = jnp.sqrt(2.0 * jnp.maximum(jnp.log(alpha * (1.0 / ALPHA_EPS)), 0.0))
        radius = radius * (cut * (1.0 / 3.0))
    elif display_mode == 1:
        radius = radius * (2.0 / 3.0)

    # --- frustum cull in screen space ---
    margin = radius
    on_screen = (
        (px + margin > 0)
        & (px - margin < width)
        & (py + margin > 0)
        & (py - margin < height)
    )
    valid = valid & on_screen & (alpha > ALPHA_EPS) & (radius > 0)
    alpha = jnp.where(valid, alpha, 0.0)

    return PreprocessOut(
        mean_x=px,
        mean_y=py,
        conic_a=conic_a,
        conic_b=conic_b,
        conic_c=conic_c,
        col_r=col_r,
        col_g=col_g,
        col_b=col_b,
        alpha=alpha,
        depth=depth,
        radius=radius,
        valid=valid,
    )


def _apply_affine(pts: tuple, m3: jnp.ndarray, t: jnp.ndarray) -> tuple:
    """Three (N,) point components through a scalar (3, 3) + (3,) affine."""
    x, y, z = pts
    return (
        m3[0, 0] * x + m3[0, 1] * y + m3[0, 2] * z + t[0],
        m3[1, 0] * x + m3[1, 1] * y + m3[1, 2] * z + t[1],
        m3[2, 0] * x + m3[2, 1] * y + m3[2, 2] * z + t[2],
    )
