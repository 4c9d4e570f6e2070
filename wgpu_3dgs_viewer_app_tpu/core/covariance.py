"""3D covariance construction and EWA projection to 2D conics, jnp.

The engine crate computes these in its WGSL preprocess shader (pipeline stage
at reference `src/tab/scene.rs:856-863`; crate-internal, mechanics standard
EWA splatting / Inria 3DGS math).

Conventions (this framework):
- view matrix is glam `look_at_rh` (camera looks down -Z); depth = -z_view.
- projection is glam `perspective_rh` (NDC y up, z in [0,1]).
- pixel coords: x right, y DOWN (top-left origin), so the y row of the
  projection Jacobian is negated.

Every matrix product here is SCALAR-EXPANDED into (N,) component
arithmetic: batched (N, 3, 3)/(N, 2, 3) matmuls would pad their tiny minor
dims, while flat (N,) arrays stream through elementwise fusions at full
f32 precision (no reduced-precision matrix units involved).
"""

from __future__ import annotations

import jax.numpy as jnp

# Screen-space low-pass filter added to the projected covariance (standard
# EWA anti-aliasing dilation used by 3DGS renderers).
COV2D_DILATION = 0.3


def quat_rot_components(q: jnp.ndarray) -> tuple:
    """Quaternion (..., 4) (w, x, y, z), possibly unnormalized -> the nine
    rotation-matrix components as a 3x3 nested tuple of (...,) arrays."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def quat_to_mat3_jnp(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (..., 4) -> (..., 3, 3) rotation (for host-side/small use)."""
    r = quat_rot_components(q)
    return jnp.stack([jnp.stack(row, -1) for row in r], -2)


def cov3d_from_scale_rot(scale: jnp.ndarray, quat: jnp.ndarray) -> jnp.ndarray:
    """Sigma = R S S^T R^T, packed as 6 uniques (xx, xy, xz, yy, yz, zz).

    `scale`: (..., 3) linear scales (PLY stores log-scale; exp() upstream).
    `quat`: (..., 4) (w, x, y, z). Component-expanded (see module note).
    """
    r = quat_rot_components(quat)
    s2 = (scale[..., 0] ** 2, scale[..., 1] ** 2, scale[..., 2] ** 2)

    def sig(i, j):
        return (
            r[i][0] * s2[0] * r[j][0]
            + r[i][1] * s2[1] * r[j][1]
            + r[i][2] * s2[2] * r[j][2]
        )

    return jnp.stack(
        [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)], axis=-1
    )


def transform_cov6_t(cov6c: tuple, m: jnp.ndarray) -> tuple:
    """Congruence transform Sigma' = M Sigma M^T for a (3, 3) scalar matrix M.

    cov6c: six (N,) uniques (xx, xy, xz, yy, yz, zz); returns the same tuple
    form: tuples of flat (N,) arrays, no (N, 6) array between fusions.
    """
    xx, xy, xz, yy, yz, zz = cov6c
    s = ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))

    # t[i][k] = sum_c M[i, c] * Sigma[c, k]
    def t(i, k):
        return m[i, 0] * s[0][k] + m[i, 1] * s[1][k] + m[i, 2] * s[2][k]

    def out(i, j):
        return t(i, 0) * m[j, 0] + t(i, 1) * m[j, 1] + t(i, 2) * m[j, 2]

    return (out(0, 0), out(0, 1), out(0, 2), out(1, 1), out(1, 2), out(2, 2))


def transform_cov6(cov6: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Stacked-array wrapper over `transform_cov6_t` (small/test use)."""
    return jnp.stack(
        transform_cov6_t(tuple(cov6[..., i] for i in range(6)), m), axis=-1
    )


def unpack_cov3d(cov6: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) packed uniques -> (..., 3, 3) symmetric matrix (small use only)."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([xx, xy, xz], -1),
            jnp.stack([xy, yy, yz], -1),
            jnp.stack([xz, yz, zz], -1),
        ],
        -2,
    )


def project_cov3d_to_cov2d(
    cov6c: tuple,
    t_view: tuple,
    view3: jnp.ndarray,
    focal: tuple,
    tan_half_fov: tuple,
) -> tuple:
    """EWA projection: 3D covariance -> 2D screen-space covariance.

    cov6c:  six (N,) packed world-space covariance uniques.
    t_view: three (N,) splat-center components in view space (camera looks
            down -Z).
    view3:  (3, 3) rotation part of the view matrix (scalar).
    focal:  (fx, fy) focal lengths in pixels.
    tan_half_fov: (tan_fov_x/2, tan_fov_y/2) for center clamping.
    Returns (a, b, c) (N,) components of the symmetric 2D covariance
    [[a, b], [b, c]] in pixel^2 (y down), including the low-pass dilation.

    Fully component-expanded: cov2d = (J W) Sigma (J W)^T with
    J = [[fx/d, 0, fx*tx/d^2], [0, -fy/d, -fy*ty/d^2]].
    """
    fx, fy = focal
    tx, ty, tz = t_view
    d = jnp.maximum(-tz, 1e-6)  # positive depth in front of camera

    # Clamp the projected center to ~1.3x the frustum to bound the Jacobian
    # at grazing angles (standard 3DGS trick).
    limx, limy = 1.3 * tan_half_fov[0], 1.3 * tan_half_fov[1]
    txc = jnp.clip(tx / d, -limx, limx) * d
    tyc = jnp.clip(ty / d, -limy, limy) * d

    inv_d = 1.0 / d
    inv_d2 = inv_d * inv_d
    j00 = fx * inv_d
    j02 = fx * txc * inv_d2
    j11 = -fy * inv_d
    j12 = -fy * tyc * inv_d2

    # Rows of JW (each component is a (N,) array; view3 entries are scalars).
    p = [j00 * view3[0, k] + j02 * view3[2, k] for k in range(3)]
    q = [j11 * view3[1, k] + j12 * view3[2, k] for k in range(3)]

    xx, xy, xz, yy, yz, zz = cov6c
    sp0 = xx * p[0] + xy * p[1] + xz * p[2]
    sp1 = xy * p[0] + yy * p[1] + yz * p[2]
    sp2 = xz * p[0] + yz * p[1] + zz * p[2]
    sq0 = xx * q[0] + xy * q[1] + xz * q[2]
    sq1 = xy * q[0] + yy * q[1] + yz * q[2]
    sq2 = xz * q[0] + yz * q[1] + zz * q[2]

    a = p[0] * sp0 + p[1] * sp1 + p[2] * sp2 + COV2D_DILATION
    b = q[0] * sp0 + q[1] * sp1 + q[2] * sp2
    c = q[0] * sq0 + q[1] * sq1 + q[2] * sq2 + COV2D_DILATION
    return (a, b, c)


def cov2d_to_conic_radius(cov2d: tuple) -> tuple:
    """2D covariance (a, b, c) components -> ((A, B, C) conic components,
    radius_px, valid_det).

    conic = inverse covariance; radius = 3 * sqrt(max eigenvalue).
    """
    a, b, c = cov2d
    det = a * c - b * b
    valid = det > 0.0
    inv_det = jnp.where(valid, 1.0 / jnp.maximum(det, 1e-12), 0.0)
    conic = (c * inv_det, -b * inv_det, a * inv_det)
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius = jnp.ceil(3.0 * jnp.sqrt(jnp.maximum(lambda1, 0.0)))
    return conic, radius, valid
