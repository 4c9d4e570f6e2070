"""Mask evaluation: set-op tree over shape containments -> per-splat bits.

Parity with the crate's `MaskEvaluator::evaluate(device, queue, tree,
mask_buffer, model_transform, gaussians)` (reference
`src/tab/scene.rs:2033-2034,2201-2209`): evaluates the op tree per splat into
the mask bit buffer, which then gates splats out of the draw every frame
(mask bound into preprocess, `src/tab/scene.rs:1851`).

Design: the whole tree folds into one fused XLA elementwise expression
over COMPONENT-FORM positions — three flat (N,) planes, never an (N, 3)
array and no `(N,3) @ (3,3)` tiny matmuls. Each Shape leaf is 9 fma + 3 sub +
a compare reduction; each tree node one boolean op. `MaskOpTree::Reset`
(SURVEY §2.2) sets all bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

from ..core.transform import ModelTransform
from .expr import MaskOp
from .shapes import MaskOpShapePod, shape_contains_xyz

Positions = Union[jnp.ndarray, np.ndarray, Tuple]


def _components(positions: Positions):
    """Positions -> three flat (N,) planes.

    Accepts a (x, y, z) tuple of flat planes (the fast path — pod storage is
    already a (3, N_pad) row plane), or an (N, 3) array (host/test
    convenience; numpy column slices stay on the host so no padded device
    layout ever materializes).
    """
    if isinstance(positions, (tuple, list)):
        x, y, z = positions
        return jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)
    p = np.asarray(positions) if isinstance(positions, np.ndarray) else positions
    return (jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(p[:, 2]))


class MaskEvaluator:
    """Evaluates a mask op tree against one model's splat centers."""

    def evaluate(
        self,
        op: Optional[MaskOp],
        shapes: Sequence[MaskOpShapePod],
        positions: Positions,
        model_transform: Optional[ModelTransform] = None,
    ) -> jnp.ndarray:
        """Returns (N,) uint8 mask bits (1 = keep).

        `op=None` is Reset: all splats visible (ref
        `SceneCommand::EvaluateMask(None)` path, `src/tab/scene.rs:447-456`).
        Shape pods are in world space; splat positions are model-local, so the
        model transform is applied first (mirrors the crate taking the
        `model_transform_buffer`, `src/tab/scene.rs:2201-2209`).
        """
        x, y, z = _components(positions)
        if op is None:
            return jnp.ones(x.shape[0], jnp.uint8)
        if model_transform is not None:
            m = np.asarray(model_transform.matrix(), np.float32)
            xw = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
            yw = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
            zw = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
            x, y, z = xw, yw, zw
        return self._eval(op, shapes, x, y, z).astype(jnp.uint8)

    def _eval(self, op: MaskOp, shapes, x, y, z) -> jnp.ndarray:
        k = op.kind
        if k == "shape":
            return shape_contains_xyz(shapes[op.index], x, y, z)
        if k == "complement":
            return ~self._eval(op.left, shapes, x, y, z)
        a = self._eval(op.left, shapes, x, y, z)
        b = self._eval(op.right, shapes, x, y, z)
        if k == "union":
            return a | b
        if k == "intersection":
            return a & b
        if k == "difference":
            return a & ~b
        if k == "symmetric_difference":
            return a ^ b
        raise ValueError(f"unknown mask op kind {k!r}")


def evaluate_mask_numpy(
    op: Optional[MaskOp],
    shapes: Sequence[MaskOpShapePod],
    positions: np.ndarray,
    model_transform: Optional[ModelTransform] = None,
) -> np.ndarray:
    """Host-side convenience wrapper returning numpy bits."""
    return np.asarray(
        MaskEvaluator().evaluate(op, shapes, positions, model_transform)
    )
