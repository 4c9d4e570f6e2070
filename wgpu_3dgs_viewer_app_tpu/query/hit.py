"""GPU-picking hit queries — parity with the crate's query subsystem:
per-splat hit candidates evaluated in preprocess, resolved by
`query::hit_pos_by_alpha_range` / `query::hit_pos_by_closest`
(reference `src/tab/scene.rs:650-676`; measurement flow §3.5).

Design: the wgpu pipeline appends candidates to a GPU buffer and
async-readbacks them to the CPU for resolution. Here resolution happens
*on device* as reductions over the per-splat preprocess outputs — no
variable-length candidate buffer, no readback of candidate lists; only the
final (found, world_pos) crosses the device boundary.

Hit-candidate semantics [crate-internal, inferred]: a splat is a candidate if
its Gaussian alpha evaluated at the query pixel clears a threshold
(`hit_pos_by_alpha_range` is called with 0.05 at `src/tab/scene.rs:659-667`).
MostAlpha picks the candidate with the largest composited contribution
(T * alpha, front-to-back); Closest picks the smallest depth.
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp

from ..ops.preprocess import PreprocessOut


class MeasurementHitMethod(enum.Enum):
    """Ref `MeasurementHitMethod` (`src/app.rs:1363-1371`); default MOST_ALPHA."""

    MOST_ALPHA = "most_alpha"
    CLOSEST = "closest"


def alpha_at_pixel(pre: PreprocessOut, pixel: jnp.ndarray) -> jnp.ndarray:
    """Per-splat Gaussian alpha evaluated at one pixel. (N,) f32."""
    d = pixel[None, :] - pre.mean2d
    a, b, c = pre.conic[:, 0], pre.conic[:, 1], pre.conic[:, 2]
    power = -0.5 * (a * d[:, 0] ** 2 + c * d[:, 1] ** 2) - b * d[:, 0] * d[:, 1]
    alpha = pre.alpha * jnp.exp(jnp.minimum(power, 0.0))
    return jnp.where(pre.valid & (power <= 0.0), alpha, 0.0)


def _pixel_ray_world(pixel, view, proj, width, height):
    """World-space ray (origin, dir_at_unit_depth) through a pixel center."""
    tan_x = 1.0 / proj[0, 0]
    tan_y = 1.0 / proj[1, 1]
    u = (pixel[0] / width) * 2.0 - 1.0
    v = 1.0 - (pixel[1] / height) * 2.0
    dir_view = jnp.array([1.0, 1.0, -1.0]) * jnp.stack(
        [u * tan_x, v * tan_y, jnp.float32(1.0)]
    )
    r = view[:3, :3]
    cam_pos = -jnp.matmul(r.T, view[:3, 3], precision=jax.lax.Precision.HIGHEST)
    dir_world = jnp.matmul(r.T, dir_view, precision=jax.lax.Precision.HIGHEST)
    return cam_pos, dir_world


@functools.partial(jax.jit, static_argnames=("method", "width", "height"))
def query_hit(
    pre: PreprocessOut,
    pixel: jnp.ndarray,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    width: int,
    height: int,
    method: MeasurementHitMethod = MeasurementHitMethod.MOST_ALPHA,
    alpha_threshold: float = 0.05,
):
    """Resolve a hit at `pixel`. Returns (found () bool, world_pos (3,) f32).

    world_pos lies on the pixel ray at the winning splat's view depth.
    """
    alpha = alpha_at_pixel(pre, pixel)
    if method == MeasurementHitMethod.CLOSEST:
        cand = alpha > 1.0 / 255.0
        depth = jnp.where(cand, pre.depth, jnp.inf)
        win = jnp.argmin(depth)
        found = cand[win]
    else:
        cand = alpha >= alpha_threshold
        # Weight = composited contribution T_i * a_i in front-to-back order.
        order = jnp.argsort(jnp.where(cand, pre.depth, jnp.inf))
        a_sorted = jnp.where(cand[order], alpha[order], 0.0)
        t_excl = jnp.concatenate(
            [jnp.ones(1, jnp.float32), jnp.cumprod(1.0 - a_sorted)[:-1]]
        )
        w = t_excl * a_sorted
        win = order[jnp.argmax(w)]
        found = jnp.any(cand)

    cam_pos, dir_world = _pixel_ray_world(pixel, view, proj, width, height)
    pos = cam_pos + dir_world * pre.depth[win]
    return found, pos
