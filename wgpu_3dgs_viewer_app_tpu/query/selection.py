"""Selection: rect/brush queries with Set/Add/Remove ops, immediate and
texture modes — parity with the crate's `QueryToolset` machinery
(reference `src/tab/scene.rs:1994-2000,753-792`, two-path note at
`src/tab/scene.rs:768` / SURVEY §2.2: immediate per-frame query evaluation
vs rasterize-to-`query_texture` then sample on end).

A splat is selected when its projected center falls inside the region
[crate-internal; inferred from the preprocess-driven selection contract].
Selection state is per-splat bits (the crate's `selection_buffer`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.preprocess import PreprocessOut
from .pods import QueryBrushPod, QueryRectPod, QuerySelectionOp


def combine_selection(old_bits, new_bits, op: QuerySelectionOp):
    """Apply a selection op (ref `QuerySelectionOp`, `src/tab/scene.rs:1223-1228`)."""
    old_b = old_bits.astype(bool)
    new_b = new_bits.astype(bool)
    if op == QuerySelectionOp.SET:
        out = new_b
    elif op == QuerySelectionOp.ADD:
        out = old_b | new_b
    else:
        out = old_b & ~new_b
    return out.astype(jnp.uint8)


@jax.jit
def select_rect(pre: PreprocessOut, top_left, bottom_right):
    """Splat centers inside the pixel rect -> (N,) uint8."""
    tl = jnp.minimum(jnp.asarray(top_left, jnp.float32), jnp.asarray(bottom_right, jnp.float32))
    br = jnp.maximum(jnp.asarray(top_left, jnp.float32), jnp.asarray(bottom_right, jnp.float32))
    m = pre.mean2d
    inside = (
        (m[:, 0] >= tl[0]) & (m[:, 0] <= br[0]) & (m[:, 1] >= tl[1]) & (m[:, 1] <= br[1])
    )
    return (inside & pre.valid).astype(jnp.uint8)


@jax.jit
def select_brush_segment(pre: PreprocessOut, seg_start, seg_end, radius):
    """Splat centers within `radius` px of the stroke segment -> (N,) uint8."""
    a = jnp.asarray(seg_start, jnp.float32)
    b = jnp.asarray(seg_end, jnp.float32)
    m = pre.mean2d
    ab = b - a
    denom = jnp.maximum(jnp.dot(ab, ab, precision=jax.lax.Precision.HIGHEST), 1e-12)
    t = jnp.clip(jnp.matmul(m - a, ab, precision=jax.lax.Precision.HIGHEST) / denom, 0.0, 1.0)
    closest = a + t[:, None] * ab
    dist2 = jnp.sum((m - closest) ** 2, axis=1)
    inside = dist2 <= jnp.asarray(radius, jnp.float32) ** 2
    return (inside & pre.valid).astype(jnp.uint8)


@functools.partial(jax.jit, donate_argnums=(0,))
def _paint_rect(tex, top_left, bottom_right):
    h, w = tex.shape
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    tl = jnp.minimum(top_left, bottom_right)
    br = jnp.maximum(top_left, bottom_right)
    inside = (xs >= tl[0]) & (xs <= br[0]) & (ys >= tl[1]) & (ys <= br[1])
    return tex | inside


@functools.partial(jax.jit, donate_argnums=(0,))
def _paint_segment(tex, a, b, radius):
    h, w = tex.shape
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    ab = b - a
    denom = jnp.maximum(jnp.dot(ab, ab, precision=jax.lax.Precision.HIGHEST), 1e-12)
    px = jnp.stack([jnp.broadcast_to(xs, (h, w)), jnp.broadcast_to(ys, (h, w))], -1)
    t = jnp.clip(jnp.matmul(px - a, ab, precision=jax.lax.Precision.HIGHEST) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    dist2 = jnp.sum((px - closest) ** 2, axis=-1)
    return tex | (dist2 <= radius * radius)


@jax.jit
def sample_texture_at_centers(pre: PreprocessOut, tex):
    """Texture-mode resolve: sample the query texture at projected centers."""
    h, w = tex.shape
    xi = jnp.clip(pre.mean2d[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(pre.mean2d[:, 1].astype(jnp.int32), 0, h - 1)
    inside = tex[yi, xi]
    on_screen = (
        (pre.mean2d[:, 0] >= 0)
        & (pre.mean2d[:, 0] < w)
        & (pre.mean2d[:, 1] >= 0)
        & (pre.mean2d[:, 1] < h)
    )
    return (inside & on_screen & pre.valid).astype(jnp.uint8)


class QueryToolset:
    """Stateful rect/brush tool — mirror of crate `QueryToolset`
    (`start(tool, op, pos)` / `update_pos` / `end` / `query`, reference
    `src/tab/scene.rs:768-792,1994-2000`).

    In texture mode (`use_texture=True`) strokes rasterize into a boolean
    query texture (the crate's `query_texture`, rendered by
    `QueryToolset::render`); the selection resolves on `end()`. In immediate
    mode each `update_pos` emits a query pod to apply this frame.
    """

    RECT = "rect"
    BRUSH = "brush"

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.use_texture = False
        self.brush_radius = 40.0  # ref default `src/app.rs:1454`
        self.texture = jnp.zeros((height, width), bool)
        self._active = None  # (tool, op)
        self._start_pos = None
        self._last_pos = None
        self._pending: list = []

    def set_use_texture(self, value: bool) -> None:
        self.use_texture = value

    def update_brush_radius(self, r: float) -> None:
        self.brush_radius = float(r)

    def state(self):
        return self._active

    def start(self, tool: str, op: QuerySelectionOp, pos) -> None:
        self._active = (tool, op)
        self._start_pos = np.asarray(pos, np.float32)
        self._last_pos = self._start_pos
        self._op_emitted = False
        self.texture = jnp.zeros((self.height, self.width), bool)
        if tool == self.BRUSH:
            self._stroke(self._start_pos, self._start_pos)

    def update_pos(self, pos) -> None:
        if self._active is None:
            return
        pos = np.asarray(pos, np.float32)
        tool, op = self._active
        if tool == self.BRUSH:
            self._stroke(self._last_pos, pos)
        else:
            self.texture = jnp.zeros((self.height, self.width), bool)
            self.texture = _paint_rect(
                self.texture, jnp.asarray(self._start_pos), jnp.asarray(pos)
            )
            if not self.use_texture:
                self._pending = [QueryRectPod(tuple(self._start_pos), tuple(pos), op)]
        self._last_pos = pos

    def _stroke(self, a, b) -> None:
        _, op = self._active
        self.texture = _paint_segment(
            self.texture, jnp.asarray(a), jnp.asarray(b), jnp.float32(self.brush_radius)
        )
        if not self.use_texture:
            # Within one gesture, only the first stroke carries the gesture op;
            # later strokes extend it (a SET drag must not erase its own path).
            eff = op
            if self._op_emitted and op == QuerySelectionOp.SET:
                eff = QuerySelectionOp.ADD
            self._op_emitted = True
            self._pending.append(QueryBrushPod(tuple(a), tuple(b), self.brush_radius, eff))

    def end(self):
        """Finish the gesture. Returns (op, texture) for texture-mode resolve,
        or None in immediate mode (pods were already emitted per frame)."""
        if self._active is None:
            return None
        tool, op = self._active
        self._active = None
        if self.use_texture:
            return op, self.texture
        if tool == self.RECT:
            self._pending = [
                QueryRectPod(tuple(self._start_pos), tuple(self._last_pos), op)
            ]
        return None

    def query(self):
        """Drain immediate-mode query pods for this frame."""
        pods, self._pending = self._pending, []
        return pods


def apply_query_pod(pre: PreprocessOut, bits, pod):
    """Evaluate one immediate-mode query pod against preprocess outputs."""
    if isinstance(pod, QueryRectPod):
        new = select_rect(pre, jnp.asarray(pod.top_left), jnp.asarray(pod.bottom_right))
    elif isinstance(pod, QueryBrushPod):
        new = select_brush_segment(
            pre, jnp.asarray(pod.start), jnp.asarray(pod.end), jnp.float32(pod.radius)
        )
    else:
        return bits
    return combine_selection(bits, new, pod.op)
