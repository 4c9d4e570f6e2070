"""Mask shapes (Box / Ellipsoid) and vectorized containment evaluation.

Parity with reference:
- `MaskShape { kind, pos, rotation, scale, color }`, `MaskShapeKind::{Box,
  Ellipsoid}`, `to_mask_op_shape_pod()` (`src/app.rs:1621-1624`,
  `src/tab/mask.rs:152-231`).
- Containment semantics [crate-internal, inferred]: a splat is inside a
  shape if its (model-transformed) center lies inside the shape's unit
  box/ball after the shape's inverse TRS.
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np

from ..core.transform import quat_from_euler_zyx_deg, quat_to_mat3


class MaskShapeKind(enum.Enum):
    """Ref `MaskShapeKind` (`src/app.rs:1601`)."""

    BOX = "box"
    ELLIPSOID = "ellipsoid"


@dataclasses.dataclass
class MaskShape:
    """One mask shape with TRS + display color + visibility.

    Mirror of `GaussianSplattingMaskShape` (`src/app.rs:1591-1616`):
    rotation held as Euler degrees like the app UI, converted ZYX.
    """

    kind: MaskShapeKind = MaskShapeKind.BOX
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rot: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1, 1, 0, 1], np.float32)
    )
    visible: bool = True

    def to_pod(self) -> "MaskOpShapePod":
        """`to_mask_op_shape_pod` equivalent: bake inverse transform."""
        r = quat_to_mat3(quat_from_euler_zyx_deg(self.rot))
        inv_scale = 1.0 / np.maximum(np.asarray(self.scale, np.float32), 1e-12)
        # world -> shape-local: S^-1 R^T (p - t)
        inv_lin = (inv_scale[:, None] * r.T).astype(np.float32)
        return MaskOpShapePod(
            kind=self.kind,
            inv_lin=inv_lin,
            pos=np.asarray(self.pos, np.float32),
        )


@dataclasses.dataclass(frozen=True)
class MaskOpShapePod:
    """GPU-ready shape record (ref `gs::MaskOpShapePod`)."""

    kind: MaskShapeKind
    inv_lin: np.ndarray  # (3, 3) world->local linear part
    pos: np.ndarray      # (3,) shape origin


def shape_contains_xyz(pod: MaskOpShapePod, x, y, z) -> jnp.ndarray:
    """Component-form containment: three flat (N,) world planes -> (N,) bool.

    All math stays on flat (N,) arrays — 9 fma + 3 sub per shape, fused by
    XLA with the surrounding set-op tree; no (N, 3) array, no tiny matmuls."""
    il = np.asarray(pod.inv_lin, np.float32)
    px, py, pz = (float(v) for v in np.asarray(pod.pos, np.float32))
    dx, dy, dz = x - px, y - py, z - pz
    lx = il[0, 0] * dx + il[0, 1] * dy + il[0, 2] * dz
    ly = il[1, 0] * dx + il[1, 1] * dy + il[1, 2] * dz
    lz = il[2, 0] * dx + il[2, 1] * dy + il[2, 2] * dz
    if pod.kind == MaskShapeKind.BOX:
        # Unit box: |local| <= 0.5 on every axis.
        return (jnp.abs(lx) <= 0.5) & (jnp.abs(ly) <= 0.5) & (jnp.abs(lz) <= 0.5)
    # Unit ball: |local| <= 0.5 radius (diameter-1 ellipsoid, matching box).
    return lx * lx + ly * ly + lz * lz <= 0.25


def shape_contains(pod: MaskOpShapePod, points: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) world points -> (N,) bool containment (test/host convenience;
    the evaluator uses the component form above)."""
    return shape_contains_xyz(pod, points[:, 0], points[:, 1], points[:, 2])
