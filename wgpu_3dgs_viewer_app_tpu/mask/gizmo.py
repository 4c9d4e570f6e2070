"""Mask gizmos: wireframe box/ellipsoid overlays for mask shapes.

Parity with the crate's `MaskGizmo` (reference `src/tab/scene.rs:2144-2162,
2229-2247,2286-2292`): per-shape wireframes in the shape's color, drawn over
the scene (`render_box_with_pass` / `render_ellipsoid_with_pass`).

Design: gizmo edges become line-segment lists transformed on host and
rasterized by the same vectorized jnp line pass as the measurement overlay.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..core.lines import project_points as _project_points, rasterize_lines
from ..core.transform import quat_from_euler_zyx_deg, quat_to_mat3
from .shapes import MaskShape, MaskShapeKind

# Unit box edges (half-extent 0.5), 12 segments.
_BOX_CORNERS = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
    np.float32,
)
_BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _circle_segments(n: int = 32):
    t = np.linspace(0, 2 * math.pi, n + 1)
    return np.stack([np.cos(t), np.sin(t)], -1).astype(np.float32)


def shape_segments(shape: MaskShape) -> np.ndarray:
    """World-space line segments (M, 2, 3) for one shape's wireframe."""
    r = quat_to_mat3(quat_from_euler_zyx_deg(shape.rot))
    s = np.asarray(shape.scale, np.float32)
    p = np.asarray(shape.pos, np.float32)

    def xf(local):
        return (local * s) @ r.T + p

    segs = []
    if shape.kind == MaskShapeKind.BOX:
        for a, b in _BOX_EDGES:
            segs.append([xf(_BOX_CORNERS[a]), xf(_BOX_CORNERS[b])])
    else:
        c = _circle_segments() * 0.5  # radius 0.5 to match containment
        for axis in range(3):
            pts = np.zeros((len(c), 3), np.float32)
            pts[:, (axis + 1) % 3] = c[:, 0]
            pts[:, (axis + 2) % 3] = c[:, 1]
            w = xf(pts)
            segs.extend([[w[i], w[i + 1]] for i in range(len(w) - 1)])
    return np.asarray(segs, np.float32)


def render_mask_gizmos(
    img: jnp.ndarray,
    shapes: Sequence[MaskShape],
    view: np.ndarray,
    proj: np.ndarray,
    line_width: float = 1.5,
) -> jnp.ndarray:
    """Draw all visible shapes' wireframes over the frame."""
    visible = [s for s in shapes if s.visible]
    if not visible:
        return img
    h, w = img.shape[:2]
    all_segs, colors = [], []
    for s in visible:
        segs = shape_segments(s)
        all_segs.append(segs)
        col = np.asarray(s.color, np.float32)
        colors.append(np.tile(col, (len(segs), 1)))
    segs = np.concatenate(all_segs)  # (M, 2, 3)
    colors = np.concatenate(colors)
    pts = segs.reshape(-1, 3)
    px, _, in_front = _project_points(
        jnp.asarray(pts), jnp.asarray(view), jnp.asarray(proj), w, h
    )
    px = px.reshape(-1, 2, 2)
    ok = in_front.reshape(-1, 2)
    live = ok[:, 0] & ok[:, 1]
    widths = jnp.full(len(segs), line_width, jnp.float32)
    return rasterize_lines(img, px[:, 0], px[:, 1], jnp.asarray(colors), widths, live)
