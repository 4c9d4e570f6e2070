"""Per-model device buffer set — the JAX equivalent of the crate's
`MultiModelViewerGaussianBuffers<G>` inventory (reference
`src/tab/scene.rs:2111-2112` and the buffer list in SURVEY §2.2):

reference buffer                  -> here
gaussians_buffer                  -> pod arrays (pos/color0/sh/cov3d), fixed
                                     capacity, streaming `update_range`
gaussians_edit_buffer             -> edit_flags/edit_rgb/edit_params SoA
selection_buffer                  -> selection (N,) uint8 bits
mask_buffer                       -> mask (N,) uint8 bits
indirect_args / sort args buffers -> not needed: XLA static shapes replace
                                     indirect dispatch; per-tile ranges are
                                     computed by ops/binning.py each frame
gaussians_depth / indices         -> transient values inside the jitted frame

Streaming uploads use donated jit updates (XLA in-place dynamic_update_slice)
so a chunk upload is O(chunk), not O(capacity) — the analog of
`gaussians_buffer.update_range` (`src/tab/scene.rs:2076-2084`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.edit import make_edit_soa
from ..data.compression import (
    Compressions,
    ShCompression,
    flat_pod_to_words,
    pack_gaussians,
)
from ..data.gaussian import Gaussians


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_slice(dst, src, start):
    """In-place range update along the splat axis. Rows-layout pod arrays
    (..., R, 128) are updated through a flat (..., R*128) view — the two
    reshapes are per-chunk relayouts on the streaming path only."""
    if dst.ndim == 1:
        return jax.lax.dynamic_update_slice(dst, src, (start,))
    shape = dst.shape
    flat = dst.reshape(shape[:-2] + (-1,))
    flat = jax.lax.dynamic_update_slice(flat, src, (0,) * (flat.ndim - 1) + (start,))
    return flat.reshape(shape)


class GaussianBuffers:
    """Device-resident splat state for one model, with fixed capacity."""

    def __init__(self, capacity: int, comp: Compressions, device=None):
        # Round up to the lane width: rows-layout pods, and every per-splat
        # sidecar array (edits/selection/mask), share the padded capacity.
        self.capacity = -(-max(int(capacity), 1) // 128) * 128
        self.comp = comp
        self.loaded = 0
        n = self.capacity
        zeros = Gaussians.empty(1)
        pod_np = pack_gaussians(zeros, comp, capacity=n)
        self.pod = {k: jnp.asarray(v) for k, v in pod_np.items()}
        ef, er, ep = make_edit_soa(n)
        self.edit_flags = jnp.asarray(ef)
        self.edit_rgb = jnp.asarray(er)
        self.edit_params = jnp.asarray(ep)
        self.selection = jnp.zeros(n, jnp.uint8)
        self.mask = jnp.ones(n, jnp.uint8)

    def __len__(self) -> int:
        return self.loaded

    def update_range(self, start: int, chunk: Gaussians) -> None:
        """Upload a chunk with on-the-fly pod compression (streaming path)."""
        packed = flat_pod_to_words(
            pack_gaussians(chunk, self.comp, layout="flat"), self.comp
        )
        for k, v in packed.items():
            self.pod[k] = _update_slice(self.pod[k], jnp.asarray(v), start)
        self.loaded = max(self.loaded, start + chunk.count)

    def upload_all(self, g: Gaussians) -> None:
        assert g.count <= self.capacity
        self.update_range(0, g)
        self.loaded = g.count

    # --- edit / selection / mask state updates -----------------------------

    def _pad_bits(self, bits, fill: int) -> jnp.ndarray:
        """Bits arrays live at the padded capacity; accept unpadded input."""
        bits = jnp.asarray(bits).astype(jnp.uint8)
        short = self.capacity - bits.shape[0]
        if short > 0:
            bits = jnp.concatenate([bits, jnp.full(short, fill, jnp.uint8)])
        return bits

    def set_selection(self, bits: np.ndarray) -> None:
        self.selection = self._pad_bits(bits, 0)

    def set_mask(self, bits: np.ndarray) -> None:
        self.mask = self._pad_bits(bits, 1)

    def set_edits(self, flags, rgb, params) -> None:
        self.edit_flags = jnp.asarray(flags)
        self.edit_rgb = jnp.asarray(rgb)
        self.edit_params = jnp.asarray(params)

    def commit_selection_edit(self, pod_flags: int, rgb, params) -> None:
        """Bake the scene-wide selection edit into per-splat edit storage for
        currently-selected splats (the crate's postprocess commit path
        [inferred], export-visible via `gaussians_edit_buffer.download`)."""
        sel = self.selection.astype(bool)
        self.edit_flags = jnp.where(sel, jnp.uint32(pod_flags), self.edit_flags)
        self.edit_rgb = jnp.where(sel[:, None], jnp.asarray(rgb, jnp.float32), self.edit_rgb)
        self.edit_params = jnp.where(
            sel[:, None], jnp.asarray(params, jnp.float32), self.edit_params
        )

    # --- downloads (device -> host readbacks for export/query) -------------

    def download_edits(self):
        """Equivalent of `GaussiansEditBuffer::download` (`src/app.rs:776-789`)."""
        n = self.loaded
        return (
            np.asarray(self.edit_flags[:n]),
            np.asarray(self.edit_rgb[:n]),
            np.asarray(self.edit_params[:n]),
        )

    def download_mask(self) -> np.ndarray:
        """Equivalent of mask buffer download (`src/app.rs:777,806`)."""
        return np.asarray(self.mask[: self.loaded])

    def download_selection(self) -> np.ndarray:
        return np.asarray(self.selection[: self.loaded])

    def compressed_size(self) -> int:
        return self.comp.compressed_size(self.capacity)
