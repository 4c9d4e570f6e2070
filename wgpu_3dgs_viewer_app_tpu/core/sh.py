"""Spherical harmonics evaluation (degree 0..3), jnp.

The engine crate evaluates SH->RGB in its WGSL preprocess shader (reference
pipeline at `src/tab/scene.rs:856-863`; crate-internal). This is the standard
real-SH basis used by Inria 3DGS PLYs (f_dc + 45 f_rest coefficients).

Evaluated as a (N, 15) x basis contraction in f32 elementwise math; the
degree is a static argument so XLA compiles a minimal kernel per degree.
"""

from __future__ import annotations

import jax.numpy as jnp

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: jnp.ndarray, degree: int) -> jnp.ndarray:
    """Basis values for degrees 1..`degree` (rest coefficients only, 15 max).

    `dirs`: (..., 3) unit view directions. Returns (..., 15) with entries for
    degrees above `degree` zeroed (static zero — XLA drops the work).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    zeros = jnp.zeros_like(x)
    terms = []
    if degree >= 1:
        terms += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    else:
        terms += [zeros] * 3
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    else:
        terms += [zeros] * 5
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - yy),
        ]
    else:
        terms += [zeros] * 7
    return jnp.stack(terms, axis=-1)


def eval_sh(
    sh0_rgb: jnp.ndarray,
    sh_rest: jnp.ndarray,
    dirs: jnp.ndarray,
    degree: int,
    no_sh0: bool = False,
) -> jnp.ndarray:
    """SH -> linear RGB (before 0..1 clamp).

    sh0_rgb: (..., 3) degree-0 coefficients (f_dc).
    sh_rest: (..., 15, 3) higher-degree coefficients (f_rest, channel-major in
             PLY order converted to [coeff, channel]).
    dirs:    (..., 3) unit direction from camera to splat (world space).
    degree:  static 0..=3; `no_sh0` drops the degree-0 term
             (reference `no_sh0` flag, `src/app.rs:1152-1163`).
    """
    color = jnp.full_like(sh0_rgb, 0.5)
    if not no_sh0:
        color = color + SH_C0 * sh0_rgb
    if degree >= 1:
        import jax

        basis = sh_basis(dirs, degree)  # (..., 15)
        color = color + jnp.einsum(
            "...k,...kc->...c", basis, sh_rest, precision=jax.lax.Precision.HIGHEST
        )
    return color


N_COEFFS_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}


def sh_basis_terms(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray, degree: int) -> list:
    """Rest-coefficient basis values as a list of (N,) arrays (len = coeffs
    for `degree`). Component form: no (N, 15) materialization — each term
    stays a flat (N,) array XLA fuses into the consumer (see the
    core/covariance.py note)."""
    terms = []
    if degree >= 1:
        terms += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - yy),
        ]
    return terms


def eval_sh_rest_channels(coeff_fn, dirs_x, dirs_y, dirs_z, degree: int) -> list:
    """Accumulate the rest-SH contribution per channel in component form.

    `coeff_fn(k, c)` must return the (N,) f32 coefficient for rest-coeff k,
    channel c (dequantized on the fly). Returns [r, g, b] (N,) deltas.
    """
    basis = sh_basis_terms(dirs_x, dirs_y, dirs_z, degree)
    out = []
    for c in range(3):
        acc = None
        for k, bk in enumerate(basis):
            term = bk * coeff_fn(k, c)
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else jnp.zeros_like(dirs_x))
    return out
