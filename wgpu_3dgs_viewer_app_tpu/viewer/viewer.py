"""Single- and multi-model viewer — the JAX equivalent of the crate's
`MultiModelViewer<G>` (constructed at reference `src/tab/scene.rs:1963-1980`;
update_* surface at `src/tab/scene.rs:794-849`; per-frame drive at
`src/tab/scene.rs:698-874` and paint at `src/tab/scene.rs:2251-2327`).

Where the crate encodes four GPU passes per model (preprocess -> radix sort
-> render -> postprocess) with bind groups and indirect buffers, here one
jitted `render_frame` closes over the whole pipeline — XLA sees
preprocess+binning+sort and the tile compositor as a single compiled
program per (resolution, compression, degree, mode) specialization, the
functional analog of the crate's 8-way monomorphization.

Multi-model compositing follows the reference: each model renders its own
sorted pass; model images are blended back-to-front by camera distance of
the model center (host-side ordering, ref `src/tab/scene.rs:533-542`).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.camera import CameraTrait
from ..core.edit import GaussianEditPod, SelectionHighlightPod
from ..core.transform import GaussianDisplayMode, GaussianTransform, ModelTransform
from ..data.compression import Compressions
from ..data.gaussian import Gaussians
from ..ops.backend import render_impl
from ..ops.binning import (
    TileConfig,
    build_sorted_entries,
    enumerate_entries_from_pre,
    sort_and_range_entries,
)
from ..ops.composite import composite_tiles_v2, over_background
from ..ops.preprocess import preprocess
from ..utils.log import get_logger

_log = get_logger("viewer")
from .buffers import GaussianBuffers


@functools.partial(
    jax.jit,
    static_argnames=(
        "comp",
        "cfg",
        "sh_degree",
        "no_sh0",
        "display_mode",
        "impl",
        "with_highlight",
    ),
)
def render_frame(
    pod: dict,
    comp: Compressions,
    cfg: TileConfig,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    model: jnp.ndarray,
    size: jnp.ndarray,
    sh_degree: int,
    no_sh0: bool,
    display_mode: int,
    mask_bits,
    edit,
    selection_bits,
    selection_edit,
    highlight_rgba,
    impl: str,
    with_highlight: bool,
) -> jnp.ndarray:
    """One model's full pipeline -> (H, W, 4) premultiplied rgba."""
    pre = preprocess(
        pod,
        comp,
        view,
        proj,
        model,
        cfg.width,
        cfg.height,
        sh_degree=sh_degree,
        no_sh0=no_sh0,
        size=size,
        display_mode=display_mode,
        mask_bits=mask_bits,
        edit=edit,
        selection_bits=selection_bits,
        selection_edit=selection_edit,
        highlight_rgba=highlight_rgba if with_highlight else None,
    )
    entries = build_sorted_entries(pre, cfg)
    flat = display_mode != int(GaussianDisplayMode.SPLAT)
    return composite_tiles_v2(entries, cfg, flat, impl)


class ViewerModel:
    """One model slot: buffers + transform + visibility.

    Mirror of `MultiModelViewerModel` + app-side `GaussianSplattingModel`
    (reference `src/tab/scene.rs:2135-2138`, `src/app.rs:1006-1046`).
    """

    def __init__(self, file_name: str, capacity: int, comp: Compressions):
        self.file_name = file_name
        self.buffers = GaussianBuffers(capacity, comp)
        self.transform = ModelTransform()
        self.visible = True
        self.center = np.zeros(3, np.float32)
        self.gaussians: Optional[Gaussians] = None  # CPU copy (export path)

    def set_gaussians(self, g: Gaussians) -> None:
        self.gaussians = g
        self.center = g.center()
        self.buffers.upload_all(g)


class MultiModelViewer:
    """Scene-level viewer: models map + world state + render loop.

    API parity (SURVEY §2.2 "Viewer core"): models add/remove,
    update_camera / update_model_transform / update_gaussian_transform /
    update_selection_edit / update_selection_highlight / update_query,
    render -> image.
    """

    def __init__(
        self,
        width: int,
        height: int,
        comp: Compressions = Compressions(),
        # Product default == headline bench config (tile 32, max_dup 4).
        # max_dup caps tiles-per-splat: 4 is exact for splats spanning
        # <= 2x2 tiles (64 px) and dims larger ones center-out; the error
        # bound vs the effectively-exact dup=16 is pinned by
        # tests/test_image_gpu.py::test_max_dup_truncation_bound_at_bench_scale.
        # Pass max_dup=8 or 16 for quality presets; sort cost scales ~N*dup.
        tile: int = 32,
        max_dup: int = 4,
        background=(0.0, 0.0, 0.0),
        impl: Optional[str] = None,
    ):
        self.cfg = TileConfig(width, height, tile=tile, max_dup=max_dup)
        self.comp = comp
        self.models: dict[str, ViewerModel] = {}
        self.gaussian_transform = GaussianTransform()
        self.selection_edit: Optional[GaussianEditPod] = None
        self.highlight = SelectionHighlightPod()
        self.show_highlight = False
        self.background = np.asarray(background, np.float32)
        self.impl = impl or render_impl()
        self._view = jnp.eye(4)
        self._proj = jnp.eye(4)
        self._cam_pos = np.zeros(3, np.float32)

    # --- model management (ref `src/tab/scene.rs:2101-2177`) ---------------

    def add_model(self, key: str, g: Gaussians, capacity: Optional[int] = None) -> ViewerModel:
        key = self.dedup_key(key)
        m = ViewerModel(key, capacity or g.count, self.comp)
        m.set_gaussians(g)
        self.models[key] = m
        _log.debug("add_model %r: %d splats, comp=%s", key, g.count, self.comp)
        return m

    def add_empty_model(self, key: str, capacity: int) -> ViewerModel:
        """Streaming slot: allocate capacity; fill via `buffers.update_range`."""
        key = self.dedup_key(key)
        m = ViewerModel(key, capacity, self.comp)
        self.models[key] = m
        _log.debug("add_empty_model %r: capacity %d (streaming)", key, capacity)
        return m

    def dedup_key(self, key: str) -> str:
        """Duplicate file names become `name (n)` (ref `src/tab/scene.rs:386-393`)."""
        if key not in self.models:
            return key
        i = 1
        while f"{key} ({i})" in self.models:
            i += 1
        return f"{key} ({i})"

    def remove_model(self, key: str) -> None:
        """Refuses to remove the last model (ref `src/tab/scene.rs:2169-2177`)."""
        if len(self.models) <= 1:
            raise ValueError("cannot remove the last model")
        del self.models[key]
        _log.debug("remove_model %r (%d left)", key, len(self.models))

    def set_compressions(self, comp: Compressions) -> None:
        """Switch compression on a LOADED scene: re-pack every model's pod
        buffers from its retained CPU gaussians under the new config. The
        reference changes compression from the settings menu and rebuilds
        the scene resource for the new pod type (`src/app.rs:228-258`,
        `src/tab/scene.rs:876-1006`); here the jit simply re-specializes on
        the new `comp` key. Sidecar state (edits/selection/mask) carries
        over unchanged — it is compression-independent."""
        if comp == self.comp:
            return
        _log.info("set_compressions %s -> %s: re-packing %d model(s)",
                  self.comp, comp, len(self.models))
        self.comp = comp
        for m in self.models.values():
            old = m.buffers
            buf = GaussianBuffers(old.capacity, comp)
            if m.gaussians is not None and m.gaussians.count:
                buf.upload_all(m.gaussians)
            buf.selection = old.selection
            buf.mask = old.mask
            buf.edit_flags = old.edit_flags
            buf.edit_rgb = old.edit_rgb
            buf.edit_params = old.edit_params
            m.buffers = buf

    # --- world-state updates (ref `src/tab/scene.rs:794-849`) --------------

    def update_camera(self, camera: CameraTrait) -> None:
        aspect = self.cfg.width / self.cfg.height
        self._view = jnp.asarray(camera.view())
        self._proj = jnp.asarray(camera.projection(aspect))
        self._cam_pos = np.asarray(camera.pos, np.float32)

    def update_model_transform(self, key: str, transform: ModelTransform) -> None:
        self.models[key].transform = transform

    def update_gaussian_transform(self, gt: GaussianTransform) -> None:
        self.gaussian_transform = gt

    def update_selection_edit(self, pod: Optional[GaussianEditPod]) -> None:
        self.selection_edit = pod

    def update_selection_highlight(self, pod: SelectionHighlightPod, show: bool = True) -> None:
        self.highlight = pod
        self.show_highlight = show

    def resize(self, width: int, height: int) -> None:
        """Viewport resize == new static specialization
        (ref `update_query_texture_size`, `src/tab/scene.rs:732-751`)."""
        self.cfg = TileConfig(width, height, tile=self.cfg.tile, max_dup=self.cfg.max_dup)

    # --- rendering ---------------------------------------------------------

    def model_order(self) -> list:
        """Visible model keys sorted back-to-front by center distance to the
        camera (ref `src/tab/scene.rs:533-542`)."""
        keys = [k for k, m in self.models.items() if m.visible and len(m.buffers) > 0]

        def depth(k):
            m = self.models[k]
            c = m.transform.matrix()[:3, :3] @ m.center + m.transform.matrix()[:3, 3]
            return float(np.linalg.norm(c - self._cam_pos))

        return sorted(keys, key=depth, reverse=True)

    def render_model(self, key: str, show_unedited: bool = False) -> jnp.ndarray:
        """One model -> (H, W, 4) premultiplied rgba."""
        m = self.models[key]
        gt = self.gaussian_transform
        sel_edit = None
        if self.selection_edit is not None and not show_unedited:
            f, rgb, params = self.selection_edit.as_arrays()
            sel_edit = (jnp.asarray(f), jnp.asarray(rgb), jnp.asarray(params))
        edit = None
        if not show_unedited:
            edit = (m.buffers.edit_flags, m.buffers.edit_rgb, m.buffers.edit_params)
        hl = jnp.asarray(self.highlight.rgba, jnp.float32)
        return render_frame(
            m.buffers.pod,
            self.comp,
            self.cfg,
            self._view,
            self._proj,
            jnp.asarray(m.transform.matrix()),
            jnp.float32(gt.size),
            gt.sh_deg.degree,
            gt.no_sh0,
            int(gt.display_mode),
            m.buffers.mask,
            edit,
            m.buffers.selection,
            sel_edit,
            hl,
            self.impl,
            self.show_highlight,
        )

    def _model_entry_planes(self, key: str, cfg, rank, show_unedited: bool):
        """One model's unsorted flat entry planes under `cfg` with
        `model_rank` = rank."""
        m = self.models[key]
        gt = self.gaussian_transform
        mmat = jnp.asarray(m.transform.matrix())
        sel_edit = None
        if self.selection_edit is not None and not show_unedited:
            f, rgb, params = self.selection_edit.as_arrays()
            sel_edit = (jnp.asarray(f), jnp.asarray(rgb), jnp.asarray(params))
        edit = None
        if not show_unedited:
            edit = (m.buffers.edit_flags, m.buffers.edit_rgb, m.buffers.edit_params)
        pre = preprocess(
            m.buffers.pod, self.comp, self._view, self._proj, mmat,
            cfg.width, cfg.height,
            sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0,
            size=jnp.float32(gt.size), display_mode=int(gt.display_mode),
            mask_bits=m.buffers.mask, edit=edit,
            selection_bits=m.buffers.selection, selection_edit=sel_edit,
            highlight_rgba=jnp.asarray(self.highlight.rgba, jnp.float32)
            if self.show_highlight else None,
        )
        return enumerate_entries_from_pre(pre, cfg, model_rank=rank)

    def _render_merged(self, order, show_unedited: bool):
        """Fused multi-model frame: every model's entries carry a model
        rank in the sort key (nearest model = 0), so ONE sort + ONE
        compositing pass reproduce the reference's back-to-front per-model
        draws exactly (the over operator is associative)."""
        import dataclasses as _dc

        n = len(order)
        mbits = max(1, (n - 1).bit_length())
        cfg_m = _dc.replace(self.cfg, model_bits=mbits)
        parts = [
            self._model_entry_planes(key, cfg_m, jnp.uint32(n - 1 - i),
                                     show_unedited)
            for i, key in enumerate(order)  # order is back-to-front
        ]
        keys, p1, p2, p3 = (
            jnp.concatenate([p[j] for p in parts]) for j in range(4)
        )
        entries = sort_and_range_entries(keys, p1, p2, p3, cfg_m)
        flat = int(self.gaussian_transform.display_mode) != 0
        img = composite_tiles_v2(entries, cfg_m, flat, self.impl)
        return over_background(img, self.background)

    def render(self, camera: Optional[CameraTrait] = None, show_unedited: bool = False):
        """Full frame -> (H, W, 3) f32 over background.

        Multi-model frames run the merged single-sort pipeline (model rank
        in the key); the result is identical to per-model passes blended
        back-to-front, matching the reference's per-model sorted draws
        (`src/tab/scene.rs:2299-2315`).
        """
        if camera is not None:
            self.update_camera(camera)
        order = self.model_order()
        if not order:
            return jnp.broadcast_to(
                jnp.asarray(self.background, jnp.float32),
                (self.cfg.height, self.cfg.width, 3),
            )
        if len(order) > 1:
            return self._render_merged(order, show_unedited)
        acc = None
        for key in order:
            img = self.render_model(key, show_unedited=show_unedited)
            if acc is None:
                acc = img
            else:
                # back-to-front "over": img is nearer than acc
                a = img[..., 3:4]
                rgb = img[..., :3] + (1.0 - a) * acc[..., :3]
                alpha = a + (1.0 - a) * acc[..., 3:4]
                acc = jnp.concatenate([rgb, alpha], axis=-1)
        return over_background(acc, self.background)


class Viewer(MultiModelViewer):
    """Single-model convenience viewer (crate `Viewer` minus multi-model)."""

    def __init__(self, g: Gaussians, width: int, height: int, **kw):
        super().__init__(width, height, **kw)
        self.add_model("model", g)
