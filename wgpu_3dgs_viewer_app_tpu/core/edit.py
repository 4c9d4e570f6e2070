"""Gaussian edit pods and color-edit math.

Parity with reference:
- `GaussianEditFlag` bitflags {ENABLED, HIDDEN, OVERRIDE_COLOR}
  (`src/app.rs:1548-1554`).
- `GaussianEditPod::new(flag, rgb_or_hsv, contrast, exposure, gamma, alpha)`
  (`src/app.rs:1556-1563`); identity defaults hsv=(0,1,1), contrast=0,
  exposure=0, gamma=1, alpha=1 (`src/app.rs:1530-1540`).
- `SelectionHighlightPod` rgba (`src/app.rs:824-828`).

The per-splat edit state lives on device as a struct-of-arrays
(`flags` u32, `rgb` f32x3, `params` f32x4) — the device layout of the
crate's `GaussiansEditBuffer` (`src/tab/scene.rs:1830-1833`).
Application happens inside the fused preprocess (ops/preprocess.py).

Edit mechanics are crate-internal in the reference [inferred]: HSV mode
shifts hue and scales saturation/value; override mode replaces RGB; then
contrast/exposure/gamma/alpha are applied. Defaults are exact identities.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

EDIT_FLAG_ENABLED = 1 << 0
EDIT_FLAG_HIDDEN = 1 << 1
EDIT_FLAG_OVERRIDE_COLOR = 1 << 2


@dataclasses.dataclass(frozen=True)
class GaussianEditPod:
    """One edit record. Ref `gs::GaussianEditPod` (`src/app.rs:1556-1563`)."""

    flags: int = 0
    rgb_or_hsv: tuple = (0.0, 1.0, 1.0)
    contrast: float = 0.0
    exposure: float = 0.0
    gamma: float = 1.0
    alpha: float = 1.0

    @staticmethod
    def identity() -> "GaussianEditPod":
        return GaussianEditPod()

    def as_arrays(self):
        return (
            np.uint32(self.flags),
            np.asarray(self.rgb_or_hsv, np.float32),
            np.asarray([self.contrast, self.exposure, self.gamma, self.alpha], np.float32),
        )


def make_edit_soa(n: int):
    """Identity per-splat edit SoA: (flags u32 (N,), rgb f32 (N,3), params f32 (N,4))."""
    flags = np.zeros(n, np.uint32)
    rgb = np.tile(np.array([0.0, 1.0, 1.0], np.float32), (n, 1))
    params = np.tile(np.array([0.0, 0.0, 1.0, 1.0], np.float32), (n, 1))
    return flags, rgb, params


def rgb_to_hsv(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) RGB [0,1] -> HSV (h in [0,1))."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = jnp.maximum(jnp.maximum(r, g), b)
    minc = jnp.minimum(jnp.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = jnp.where(maxc > 0, delta / jnp.maximum(maxc, 1e-12), 0.0)
    safe_delta = jnp.maximum(delta, 1e-12)
    hr = ((g - b) / safe_delta) % 6.0
    hg = (b - r) / safe_delta + 2.0
    hb = (r - g) / safe_delta + 4.0
    h = jnp.where(maxc == r, hr, jnp.where(maxc == g, hg, hb)) / 6.0
    h = jnp.where(delta > 0, h, 0.0)
    return jnp.stack([h, s, v], -1)


def hsv_to_rgb(hsv: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) HSV (h in [0,1)) -> RGB."""
    h, s, v = hsv[..., 0] % 1.0, hsv[..., 1], hsv[..., 2]
    i = jnp.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return jnp.stack([r, g, b], -1)


def apply_edit(
    rgb: jnp.ndarray,
    opacity: jnp.ndarray,
    flags: jnp.ndarray,
    edit_rgb: jnp.ndarray,
    edit_params: jnp.ndarray,
):
    """Apply per-splat edits. Returns (rgb', opacity', hidden_mask).

    rgb (N, 3), opacity (N,), flags (N,) u32, edit_rgb (N, 3),
    edit_params (N, 4) = (contrast, exposure, gamma, alpha).
    Disabled edits (ENABLED bit clear) are exact no-ops.
    """
    enabled = (flags & EDIT_FLAG_ENABLED) != 0
    hidden = enabled & ((flags & EDIT_FLAG_HIDDEN) != 0)
    override = (flags & EDIT_FLAG_OVERRIDE_COLOR) != 0

    # Color: HSV adjust (hue shift, sat/val scale) or RGB override.
    hsv = rgb_to_hsv(jnp.clip(rgb, 0.0, 1.0))
    hsv_adj = jnp.stack(
        [hsv[..., 0] + edit_rgb[..., 0], hsv[..., 1] * edit_rgb[..., 1], hsv[..., 2] * edit_rgb[..., 2]],
        -1,
    )
    color_hsv = hsv_to_rgb(hsv_adj)
    color = jnp.where(override[..., None], edit_rgb, color_hsv)

    contrast = edit_params[..., 0:1]
    exposure = edit_params[..., 1:2]
    gamma = edit_params[..., 2:3]
    alpha = edit_params[..., 3]

    color = (color - 0.5) * (1.0 + contrast) + 0.5
    color = color * jnp.exp2(exposure)
    color = jnp.power(jnp.clip(color, 0.0, 1.0), jnp.maximum(gamma, 1e-6))

    rgb_out = jnp.where(enabled[..., None], color, rgb)
    op_out = jnp.where(enabled, opacity * alpha, opacity)
    return rgb_out, op_out, hidden


def apply_edit_np(rgb, opacity, flags, edit_rgb, edit_params):
    """Pure-numpy `apply_edit` for HOST paths (export baking): eager JAX
    op-by-op dispatch here costs seconds per export and would touch the
    device for host-only work. Math mirrors `apply_edit` exactly."""
    rgb = np.asarray(rgb, np.float32)
    opacity = np.asarray(opacity, np.float32)
    flags = np.asarray(flags, np.uint32)
    edit_rgb = np.asarray(edit_rgb, np.float32)
    edit_params = np.asarray(edit_params, np.float32)
    enabled = (flags & EDIT_FLAG_ENABLED) != 0
    hidden = enabled & ((flags & EDIT_FLAG_HIDDEN) != 0)
    override = (flags & EDIT_FLAG_OVERRIDE_COLOR) != 0

    c = np.clip(rgb, 0.0, 1.0)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    sd = np.maximum(delta, 1e-12)
    hr = ((g - b) / sd) % 6.0
    hg = (b - r) / sd + 2.0
    hb = (r - g) / sd + 4.0
    h = np.where(maxc == r, hr, np.where(maxc == g, hg, hb)) / 6.0
    h = np.where(delta > 0, h, 0.0)
    hsv_adj = np.stack(
        [h + edit_rgb[..., 0], s * edit_rgb[..., 1], v * edit_rgb[..., 2]], -1
    )
    h2, s2, v2 = hsv_adj[..., 0] % 1.0, hsv_adj[..., 1], hsv_adj[..., 2]
    i = np.floor(h2 * 6.0)
    f = h2 * 6.0 - i
    p = v2 * (1.0 - s2)
    q = v2 * (1.0 - s2 * f)
    t = v2 * (1.0 - s2 * (1.0 - f))
    i = i.astype(np.int32) % 6
    rh = np.choose(i, [v2, q, p, p, t, v2])
    gh = np.choose(i, [t, v2, v2, q, p, p])
    bh = np.choose(i, [p, p, t, v2, v2, q])
    color_hsv = np.stack([rh, gh, bh], -1)
    color = np.where(override[..., None], edit_rgb, color_hsv)

    contrast = edit_params[..., 0:1]
    exposure = edit_params[..., 1:2]
    gamma = edit_params[..., 2:3]
    alpha = edit_params[..., 3]
    color = (color - 0.5) * (1.0 + contrast) + 0.5
    color = color * np.exp2(exposure)
    color = np.power(np.clip(color, 0.0, 1.0), np.maximum(gamma, 1e-6))

    rgb_out = np.where(enabled[..., None], color, rgb).astype(np.float32)
    op_out = np.where(enabled, opacity * alpha, opacity).astype(np.float32)
    return rgb_out, op_out, hidden


@dataclasses.dataclass(frozen=True)
class SelectionHighlightPod:
    """Highlight color rgba. Ref `SelectionHighlightPod` (`src/app.rs:824-828`)."""

    rgba: tuple = (1.0, 0.0, 1.0, 0.5)
