"""3D Gaussian Splatting viewer framework on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
LioQing/wgpu-3dgs-viewer-app (and the `wgpu-3dgs-viewer` engine crate it
drives): streamed PLY loading with quantized compression, the
preprocess -> depth sort -> alpha-composite splat pipeline, multi-model
scenes, selection/edits, composite shape masks, measurement, and export —
re-designed as one JAX pipeline (fused XLA preprocess, tile-binned sort,
a Pallas tile compositor, shard_map multi-device scaling).
"""

from . import app, core, data, mask, ops, parallel, query, utils, viewer

__version__ = "0.1.0"
