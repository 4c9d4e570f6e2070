"""Brute-force per-pixel reference rasterizer (golden oracle for tests).

Composites every splat against every pixel in exact global front-to-back
depth order with full f32 depth — no tiling, no duplication caps, no key
quantization. O(N * H * W): use only for small scenes (N <~ 4k).

This is the behavioral spec the tiled pipeline and its kernel are validated against
(SURVEY §4(c): kernel-level tests against pure-jnp references).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .composite import ALPHA_EPS, ALPHA_MAX, FLAT_POWER_CUTOFF
from .preprocess import PreprocessOut


@functools.partial(jax.jit, static_argnames=("width", "height", "flat_mode"))
def rasterize_reference(
    pre: PreprocessOut, width: int, height: int, flat_mode: bool = False
) -> jnp.ndarray:
    """Returns (H, W, 4) premultiplied rgb + alpha."""
    order = jnp.argsort(pre.depth)
    mean = pre.mean2d[order]
    conic = pre.conic[order]
    rgb = pre.rgb[order]
    alpha = pre.alpha[order]
    valid = pre.valid[order]

    ys = jnp.arange(height, dtype=jnp.float32) + 0.5
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    px, py = jnp.meshgrid(xs, ys)  # (H, W)

    def body(carry, splat):
        t, acc = carry
        m, cn, col, a, v = splat
        dx = px - m[0]
        dy = py - m[1]
        power = -0.5 * (cn[0] * dx * dx + cn[2] * dy * dy) - cn[1] * dx * dy
        if flat_mode:
            av = jnp.where(power >= FLAT_POWER_CUTOFF, a, 0.0)
        else:
            # Clamped (not hard-masked) at power = 0, matching the tiled
            # compositors — see composite._alpha_from_power.
            av = a * jnp.exp(jnp.minimum(power, 0.0))
        av = jnp.minimum(av, ALPHA_MAX)
        av = jnp.where((av < ALPHA_EPS) | ~v, 0.0, av)
        acc = acc + (t * av)[..., None] * col
        t = t * (1.0 - av)
        return (t, acc), None

    t0 = jnp.ones((height, width), jnp.float32)
    acc0 = jnp.zeros((height, width, 3), jnp.float32)
    (t, acc), _ = jax.lax.scan(body, (t0, acc0), (mean, conic, rgb, alpha, valid))
    return jnp.concatenate([acc, (1.0 - t)[..., None]], axis=-1)
