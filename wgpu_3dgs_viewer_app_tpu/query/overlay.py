"""Selection overlays: in-progress rect/brush region and brush cursor ring.

Parity with the crate's `QueryTextureOverlay` (visualizes the in-progress
selection region, reference `src/tab/scene.rs:2002-2014,741-742,2321`) and
`QueryCursor` (brush cursor ring, `src/tab/scene.rs:2016-2028,779,2323`).

Design: both are cheap fused image passes over the composited frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def overlay_texture(img: jnp.ndarray, texture: jnp.ndarray, color=(1.0, 0.0, 1.0, 0.25)):
    """Tint pixels covered by the in-progress selection texture."""
    c = jnp.asarray(color, jnp.float32)
    t = texture.astype(jnp.float32)[..., None] * c[3]
    return img * (1.0 - t) + t * c[:3]


@jax.jit
def overlay_cursor_ring(img: jnp.ndarray, center: jnp.ndarray, radius: jnp.ndarray,
                        color=(1.0, 1.0, 1.0, 0.9), thickness: float = 1.5):
    """Brush cursor ring at `center` (pixels)."""
    h, w = img.shape[:2]
    c = jnp.asarray(color, jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    d = jnp.sqrt((xs - center[0]) ** 2 + (ys - center[1]) ** 2)
    cover = jnp.clip(thickness - jnp.abs(d - radius), 0.0, 1.0) * c[3]
    return img * (1.0 - cover[..., None]) + cover[..., None] * c[:3]
