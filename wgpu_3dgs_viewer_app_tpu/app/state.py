"""Session state + scene orchestration: the domain layer (L4) and per-frame
driver (L3) of the reference, fused into one host-side session object.

Parity with reference:
- `GaussianSplatting` root state (`src/app.rs:502-589`): camera, models,
  loader handle, scene command channel, selected key, gaussian transform,
  action, measurement, selection, compressions.
- `SceneCommand` bus {AddModel, RemoveModel, UpdateMeasurementHit,
  EvaluateMask} (`src/app.rs:469-500`), drained each frame
  (`src/tab/scene.rs:382-458`).
- Per-frame sequencing (`src/tab/scene.rs:262-571`): drain loader ->
  drain commands -> handle input-produced queries -> render. The reference's
  postprocess-first inversion (queries resolve one frame late because eframe
  can't encode compute after its render pass, `src/tab/scene.rs:573-576`)
  is deliberately dropped: queries complete in the same logical frame here
  (SURVEY §7 non-goals).
- Selection / edit / mask / measurement state (`src/app.rs:1345-1571`).
- FPS counter: 1 s refresh interval (`src/tab/scene.rs:86-93,327-337`).
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import time
from typing import BinaryIO, Optional

import jax.numpy as jnp
import numpy as np

from ..core.camera import Camera
from ..core.edit import GaussianEditPod, SelectionHighlightPod
from ..core.transform import GaussianTransform
from ..data.compression import Compressions
from ..mask.evaluate import MaskEvaluator
from ..mask.expr import MaskOp, parse
from ..mask.shapes import MaskShape
from ..ops.preprocess import preprocess
from ..query.hit import MeasurementHitMethod, query_hit
from ..query.pods import QuerySelectionOp
from ..query.selection import (
    QueryToolset,
    apply_query_pod,
    combine_selection,
    sample_texture_at_centers,
)
from ..utils.log import get_logger
from ..viewer.viewer import MultiModelViewer
from .loader import StreamingLoader
from .measurement import Measurement, MeasurementHitPair, render_measurement_overlay


_LOG = get_logger("state")

class Action(enum.Enum):
    """Current viewport action mode (camera vs query actions)."""

    NONE = "none"
    SELECTION = "selection"
    MEASUREMENT_LOCATE_HIT = "measurement_locate_hit"


class SelectionMethod(enum.Enum):
    """Ref `SelectionMethod` (`src/app.rs:1466-1474`)."""

    RECT = "rect"
    BRUSH = "brush"


@dataclasses.dataclass
class Selection:
    """Ref `Selection` defaults (`src/app.rs:1443-1460`)."""

    method: SelectionMethod = SelectionMethod.RECT
    operation: QuerySelectionOp = QuerySelectionOp.SET
    immediate: bool = False
    brush_radius: int = 40
    highlight_color: tuple = (1.0, 0.0, 1.0, 127 / 255)
    edit: Optional["SelectionEdit"] = None
    show_unedited: bool = False


@dataclasses.dataclass
class SelectionEdit:
    """Ref `SelectionEdit` (`src/app.rs:1510-1571`); `to_pod` equivalent."""

    hidden: bool = False
    hsv: Optional[tuple] = (0.0, 1.0, 1.0)
    override_rgb: Optional[tuple] = None
    contrast: float = 0.0
    exposure: float = 0.0
    gamma: float = 1.0
    alpha: float = 1.0

    def to_pod(self) -> GaussianEditPod:
        from ..core.edit import (
            EDIT_FLAG_ENABLED,
            EDIT_FLAG_HIDDEN,
            EDIT_FLAG_OVERRIDE_COLOR,
        )

        flags = EDIT_FLAG_ENABLED
        color = self.hsv if self.override_rgb is None else self.override_rgb
        if self.hidden:
            flags |= EDIT_FLAG_HIDDEN
        if self.override_rgb is not None:
            flags |= EDIT_FLAG_OVERRIDE_COLOR
        return GaussianEditPod(
            flags=flags,
            rgb_or_hsv=tuple(color),
            contrast=self.contrast,
            exposure=self.exposure,
            gamma=self.gamma,
            alpha=self.alpha,
        )


@dataclasses.dataclass
class MaskState:
    """Ref `GaussianSplattingMask` (`src/app.rs:1573-1604`)."""

    shapes: list = dataclasses.field(default_factory=list)
    op_code: str = ""

    def add_shape(self, shape: Optional[MaskShape] = None) -> MaskShape:
        s = shape or MaskShape()
        self.shapes.append(s)
        return s

    def parse_op(self) -> Optional[MaskOp]:
        op = parse(self.op_code)
        if op is not None:
            op.validate_shapes(len(self.shapes))
        return op


class SceneCommandKind(enum.Enum):
    ADD_MODEL = "add_model"
    REMOVE_MODEL = "remove_model"
    UPDATE_MEASUREMENT_HIT = "update_measurement_hit"
    EVALUATE_MASK = "evaluate_mask"


@dataclasses.dataclass
class SceneCommand:
    """Ref `SceneCommand` (`src/app.rs:469-500`)."""

    kind: SceneCommandKind
    file_name: Optional[str] = None
    reader: Optional[BinaryIO] = None
    key: Optional[str] = None
    mask_op: Optional[MaskOp] = None


class FpsCounter:
    """1 s-interval FPS readout (ref `src/tab/scene.rs:86-93,327-337`)."""

    def __init__(self):
        self._last = time.monotonic()
        self._frames = 0
        self.fps = 0.0

    def tick(self) -> float:
        self._frames += 1
        now = time.monotonic()
        dt = now - self._last
        if dt >= 1.0:
            self.fps = self._frames / dt
            self._frames = 0
            self._last = now
        return self.fps


class GaussianSplattingSession:
    """The root interactive session (reference `GaussianSplatting` +
    `Scene`/`SceneResource` responsibilities)."""

    def __init__(
        self,
        width: int = 1280,
        height: int = 720,
        compressions: Compressions = Compressions(),
        impl: Optional[str] = None,
        tile: int = 32,
        max_dup: int = 4,
    ):
        self.camera = Camera.default()
        self.compressions = compressions
        # Product default (32, 4) == the headline bench config; the dup=4
        # truncation error bound vs dup=16 is pinned by
        # tests/test_image_gpu.py::test_max_dup_truncation_bound_at_bench_scale.
        # --max-dup 8/16 are the quality presets.
        self.viewer = MultiModelViewer(width, height, comp=compressions,
                                       impl=impl, tile=tile,
                                       max_dup=max_dup)
        self.selected_key: Optional[str] = None
        self.gaussian_transform = GaussianTransform()
        self.action = Action.NONE
        self.measurement = Measurement()
        self.selection = Selection()
        self.mask = MaskState()
        self.toolset = QueryToolset(width, height)
        self.scene_q: "queue.Queue[SceneCommand]" = queue.Queue()
        self.loader: Optional[tuple] = None  # (key, StreamingLoader)
        self.fps = FpsCounter()
        self.mask_evaluator = MaskEvaluator()
        self.theme = "dark"  # ref theme menu (src/app.rs:249-259), persisted
        self._pending_hit: Optional[tuple] = None  # (pair_idx, hit_idx)
        # Snapshot of the as-constructed camera pose: _auto_frame only moves
        # a camera nobody has repositioned since construction (CLI flags and
        # user input both make the current pose diverge from this snapshot).
        self._camera_initial_pose = self._camera_pose()

    def _camera_pose(self):
        import numpy as np

        ctl = self.camera.control
        if hasattr(ctl, "target"):
            return (np.array(ctl.target, np.float32), np.array(ctl.pos, np.float32))
        return (np.array(ctl.pos, np.float32),)

    # --- model loading (ref src/app.rs:1048-1096, src/tab/scene.rs:340-458) --

    def open_model(self, file_name: str, reader: BinaryIO) -> None:
        """Start a streamed load; rejected while another load runs
        (ref `src/tab/scene.rs:395-398`)."""
        if self.loader is not None:
            raise RuntimeError("another model is still loading")
        loader = StreamingLoader(reader)
        key = self.viewer.dedup_key(file_name)
        _LOG.info("streaming load %r: %d splats", key, loader.count)
        self.viewer.add_empty_model(key, loader.count)
        if self.selected_key is None:
            self.selected_key = key
        self.loader = (key, loader)

    def send_command(self, cmd: SceneCommand) -> None:
        self.scene_q.put(cmd)

    def set_compressions(self, comp: Compressions) -> None:
        """Change compression on the live scene, re-packing loaded models
        (closes the reference's init-modal/settings-menu compression UX,
        `src/tab/scene.rs:876-1006`, `src/app.rs:228-258`)."""
        if self.loader is not None:
            raise RuntimeError("cannot change compression while a model is loading")
        self.compressions = comp
        _LOG.info("re-packing loaded models to %s", comp)
        self.viewer.set_compressions(comp)

    def _drain_loader(self) -> None:
        if self.loader is None:
            return
        key, loader = self.loader
        model = self.viewer.models.get(key)
        if model is None:
            self.loader = None
            return

        chunks = []

        def on_chunk(start, chunk):
            model.buffers.update_range(start, chunk)
            chunks.append(chunk)

        loader.drain(on_chunk=on_chunk)
        if chunks:
            from ..data.gaussian import Gaussians

            prev = [model.gaussians] if model.gaussians is not None else []
            model.gaussians = Gaussians.concat(prev + chunks)
            model.center = model.gaussians.center()
        if loader.finished:
            self.loader = None
            self._auto_frame(model)

    def _auto_frame(self, model) -> None:
        """Frame the default orbit camera on the first fully-loaded model:
        the session has no CLI --distance, and the default 1-unit arm sits
        INSIDE typical scenes (every splat projects enormous and the
        max_dup tile truncation becomes the whole image). Only moves a
        camera still at its default; user navigation is never overridden."""
        import numpy as np

        from ..core.camera import CameraOrbitControl

        ctl = self.camera.control
        if not isinstance(ctl, CameraOrbitControl):
            return
        pose = self._camera_pose()
        if len(pose) != len(self._camera_initial_pose) or not all(
            np.allclose(a, b) for a, b in zip(pose, self._camera_initial_pose)
        ):
            return
        if model.gaussians is None or len(model.gaussians) == 0:
            return
        pos = model.gaussians.pos
        center = model.center
        radius = float(np.quantile(np.linalg.norm(pos - center[None, :], axis=1), 0.95))
        arm = max(2.0 * radius, 0.5)
        ctl.target = np.asarray(center, np.float32)
        ctl.pos = np.asarray(center + np.array([0.0, 0.0, -arm]), np.float32)

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self.scene_q.get_nowait()
            except queue.Empty:
                return
            if cmd.kind == SceneCommandKind.ADD_MODEL:
                self.open_model(cmd.file_name, cmd.reader)
            elif cmd.kind == SceneCommandKind.REMOVE_MODEL:
                self.viewer.remove_model(cmd.key)
                if self.selected_key == cmd.key:
                    self.selected_key = next(iter(self.viewer.models), None)
            elif cmd.kind == SceneCommandKind.EVALUATE_MASK:
                self.evaluate_mask(cmd.mask_op)

    # --- mask (ref src/tab/scene.rs:2190-2248) -----------------------------

    def evaluate_mask(self, op: Optional[MaskOp]) -> None:
        pods = [s.to_pod() for s in self.mask.shapes]
        for key, model in self.viewer.models.items():
            if model.gaussians is None:
                continue
            pos = np.asarray(model.gaussians.pos)
            # Component planes: the evaluator's fast path (host column
            # slices; no (N, 3) device array ever materializes).
            bits = self.mask_evaluator.evaluate(
                op, pods, (pos[:, 0], pos[:, 1], pos[:, 2]), model.transform
            )
            model.buffers.set_mask(bits)

    # --- selection / queries ----------------------------------------------

    def _selected_model(self):
        if self.selected_key is None:
            return None
        return self.viewer.models.get(self.selected_key)

    def _preprocess_selected(self):
        """Preprocess pass for the selected model at current camera (for
        query evaluation; mirrors the query path through the crate's
        preprocess, `src/tab/scene.rs:753-792`)."""
        m = self._selected_model()
        if m is None or len(m.buffers) == 0:
            return None
        self.viewer.update_camera(self.camera.control)
        gt = self.gaussian_transform
        # sh_degree=0: queries consume geometry (screen means, conic, depth,
        # alpha, validity) — never colors — so the SH->RGB evaluation (the
        # bulk of a degree-3 preprocess) is skipped.
        return preprocess(
            m.buffers.pod,
            self.compressions,
            self.viewer._view,
            self.viewer._proj,
            jnp.asarray(m.transform.matrix()),
            self.viewer.cfg.width,
            self.viewer.cfg.height,
            sh_degree=0,
            size=jnp.float32(gt.size),
            display_mode=int(gt.display_mode),
            mask_bits=m.buffers.mask,
            edit=(m.buffers.edit_flags, m.buffers.edit_rgb, m.buffers.edit_params),
        )

    def apply_selection_queries(self) -> None:
        """Drain immediate-mode pods from the toolset into selection bits."""
        m = self._selected_model()
        if m is None:
            return
        pods = self.toolset.query()
        if not pods:
            return
        pre = self._preprocess_selected()
        if pre is None:
            return
        bits = m.buffers.selection
        for pod in pods:
            bits = apply_query_pod(pre, bits, pod)
        m.buffers.set_selection(bits)

    def end_selection_gesture(self) -> None:
        """Texture-mode resolve on gesture end (ref `src/tab/scene.rs:787-792`)."""
        result = self.toolset.end()
        self.apply_selection_queries()
        if result is None:
            return
        op, texture = result
        m = self._selected_model()
        pre = self._preprocess_selected()
        if m is None or pre is None:
            return
        new_bits = sample_texture_at_centers(pre, texture)
        m.buffers.set_selection(combine_selection(m.buffers.selection, new_bits, op))

    def locate_hit(self, pixel, pair_idx: int, hit_idx: int) -> bool:
        """Measurement click -> device hit query -> hit pair position
        (ref flow §3.5, `src/tab/scene.rs:1171-1186,650-683`)."""
        pre = self._preprocess_selected()
        if pre is None:
            return False
        found, pos = query_hit(
            pre,
            jnp.asarray(pixel, jnp.float32),
            self.viewer._view,
            self.viewer._proj,
            self.viewer.cfg.width,
            self.viewer.cfg.height,
            method=self.measurement.hit_method,
        )
        if not bool(found):
            return False
        while len(self.measurement.hit_pairs) <= pair_idx:
            self.measurement.hit_pairs.append(
                MeasurementHitPair(label=f"Pair {len(self.measurement.hit_pairs)}")
            )
        self.measurement.hit_pairs[pair_idx].hits[hit_idx].pos = np.asarray(pos)
        return True

    def commit_selection_edit(self) -> None:
        """Bake the live selection edit into per-splat edit buffers."""
        if self.selection.edit is None:
            return
        pod = self.selection.edit.to_pod()
        f, rgb, params = pod.as_arrays()
        for m in self.viewer.models.values():
            m.buffers.commit_selection_edit(int(f), rgb, params)

    # --- the frame loop ----------------------------------------------------

    def update(self):
        """One frame: drain loader + commands, apply queries, render.

        Returns (H, W, 3) f32 image (device array).
        """
        self._drain_loader()
        self._drain_commands()
        self.apply_selection_queries()

        self.viewer.update_gaussian_transform(self.gaussian_transform)
        sel_pod = (
            self.selection.edit.to_pod() if self.selection.edit is not None else None
        )
        self.viewer.update_selection_edit(sel_pod)
        self.viewer.update_selection_highlight(
            SelectionHighlightPod(rgba=self.selection.highlight_color),
            show=self.action == Action.SELECTION,
        )
        img = self.viewer.render(
            self.camera.control, show_unedited=self.selection.show_unedited
        )
        # Overlays in the reference's paint order (`src/tab/scene.rs:2283-2325`):
        # mask gizmos -> measurement lines -> selection overlay / brush cursor.
        from ..mask.gizmo import render_mask_gizmos
        from ..query.overlay import overlay_cursor_ring, overlay_texture

        img = render_mask_gizmos(
            img, self.mask.shapes, self.viewer._view, self.viewer._proj
        )
        img = render_measurement_overlay(
            img,
            self.measurement,
            self.viewer._view,
            self.viewer._proj,
        )
        if self.toolset.state() is not None and self.toolset.use_texture:
            img = overlay_texture(img, self.toolset.texture)
        if (
            self.action == Action.SELECTION
            and self.selection.method == SelectionMethod.BRUSH
            and self.toolset._last_pos is not None
        ):
            img = overlay_cursor_ring(
                img,
                jnp.asarray(self.toolset._last_pos, jnp.float32),
                jnp.float32(self.selection.brush_radius),
            )
        self.fps.tick()
        return img
