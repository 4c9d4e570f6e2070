"""Screen-space line rasterization + point projection (shared by the
measurement overlay and mask gizmos).

The reference draws lines with a dedicated wgpu pipeline expanding 6
vertices per segment in WGSL (`src/renderer/measurement.rs:78-174`,
`src/shader/measurement.wgsl:22-67`). Here the same visual contract
(screen-space width, per-segment color, alpha blend) is one vectorized jnp
pass scanning segments over the frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def project_points(pts, view, proj, width, height):
    """(M, 3) world -> ((M, 2) pixel, (M,) clip-w depth, (M,) in-front)."""
    ones = jnp.ones((pts.shape[0], 1), jnp.float32)
    clip = jnp.matmul(jnp.concatenate([pts, ones], axis=1),
                      jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST).T, precision=jax.lax.Precision.HIGHEST)
    w = clip[:, 3:4]
    in_front = w[:, 0] > 1e-6
    ndc = clip[:, :3] / jnp.where(jnp.abs(w) < 1e-9, 1e-9, w)
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (0.5 - ndc[:, 1] * 0.5) * height
    return jnp.stack([px, py], -1), w[:, 0], in_front


@jax.jit
def rasterize_lines(
    img: jnp.ndarray,
    a_px: jnp.ndarray,
    b_px: jnp.ndarray,
    colors: jnp.ndarray,
    widths: jnp.ndarray,
    live: jnp.ndarray,
) -> jnp.ndarray:
    """Draw M antialiased segments over (H, W, 3).

    a_px/b_px (M, 2); colors (M, 4); widths (M,) px; live (M,) bool.
    """
    h, w = img.shape[:2]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5

    def one(img, seg):
        a, b, col, lw, lv = seg
        ab = b - a
        denom = jnp.maximum(jnp.dot(ab, ab), 1e-9)
        t = jnp.clip(((xs - a[0]) * ab[0] + (ys - a[1]) * ab[1]) / denom, 0.0, 1.0)
        cx = a[0] + t * ab[0]
        cy = a[1] + t * ab[1]
        d2 = (xs - cx) ** 2 + (ys - cy) ** 2
        half = jnp.maximum(lw * 0.5, 0.5)
        cover = jnp.clip(half + 0.5 - jnp.sqrt(d2), 0.0, 1.0) * col[3] * lv
        out = img * (1.0 - cover[..., None]) + cover[..., None] * col[:3]
        return out, None

    img, _ = jax.lax.scan(
        one, img, (a_px, b_px, colors, widths, live.astype(jnp.float32))
    )
    return img
