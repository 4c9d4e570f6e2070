"""Interactive web viewer: the accelerator-host equivalent of the
reference's egui/eframe shell (L5/L6).

The reference renders into a native/wasm window via wgpu (`src/main.rs`,
`src/app.rs:95-329`, tab system `src/tab/mod.rs`). The renderer here runs
headless, so the shell becomes a host HTTP server streaming PNG frames to a
browser canvas, with the tab surface (camera / transform / models / selection /
mask / measurement / metadata — `src/tab/*.rs`) exposed as a JSON state API
driven by an HTML panel (assets/index.html).

Protocol:
  GET  /            the viewer page
  GET  /frame.png   render one frame (the frame loop is client-paced)
  GET  /state       full UI state JSON (all tabs + fps + metadata)
  POST /event       viewport input {type: orbit|pan|zoom|look|move|action_*}
  POST /set         state updates from the tab panel
  POST /open        upload a .ply body (X-Filename header)
  POST /command     remove_model | evaluate_mask | commit_edit | add_shape...
  GET  /export      download PLY (single) / ZIP (multi) with edits/mask baked
"""

from __future__ import annotations

import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ..core.camera import CameraFirstPersonControl, CameraOrbitControl, to_first_person, to_orbit
from ..core.transform import GaussianDisplayMode, GaussianShDegree, ModelTransform
from ..mask.shapes import MaskShape, MaskShapeKind
from ..query.pods import QuerySelectionOp
from ..query.selection import QueryToolset
from ..utils.format import human_readable_size
from ..utils.log import get_logger
from ..utils.png import encode_png, to_u8
from .export import ExportChoice, serialize_exports, snapshot_exports

from .state import (
    Action,
    GaussianSplattingSession,
    SelectionEdit,
    SelectionMethod,
)

_LOG = get_logger("server")
ASSETS = Path(__file__).parent / "assets"


def _sharded_stats() -> dict | None:
    """Routing stats of the most recent sharded render, or None when the
    session is single-device (the common case). Lazy import: the parallel
    module builds jit machinery the single-chip server never needs."""
    import sys

    mod = sys.modules.get("wgpu_3dgs_viewer_app_tpu.parallel.render_sharded")
    if mod is None:
        return None
    return mod.last_stats()


def _compression_field_sizes() -> dict:
    """Per-field byte sizes for every compression option — the data behind
    the picker's live size readout (ref `src/tab/scene.rs:897-1006`)."""
    from ..data.compression import (
        COLOR_FIELD_SIZE,
        COV3D_FIELD_SIZES,
        POS_FIELD_SIZE,
        Cov3dCompression,
        ShCompression,
    )
    from ..data.compression import SH_FIELD_SIZES

    return {
        "pos": POS_FIELD_SIZE,
        "color": COLOR_FIELD_SIZE,
        "sh": {e.value: SH_FIELD_SIZES[e] for e in ShCompression},
        "cov3d": {e.value: COV3D_FIELD_SIZES[e] for e in Cov3dCompression},
    }


def _encode_frame(img: np.ndarray, scale: float = 1.0) -> bytes:
    """(H, W, 3) float frame -> PNG bytes, nearest-neighbour resized by
    `scale`. zlib level 1: frames are re-encoded every poll."""
    arr = to_u8(img)
    if scale != 1.0:
        h, w = arr.shape[:2]
        ys = (np.arange(max(1, round(h * scale))) / scale).astype(np.int64)
        xs = (np.arange(max(1, round(w * scale))) / scale).astype(np.int64)
        arr = arr[np.minimum(ys, h - 1)][:, np.minimum(xs, w - 1)]
    return encode_png(arr, level=1)


class ViewerServer:
    """Owns the session + a lock; handlers call into it."""

    def __init__(self, session: GaussianSplattingSession):
        self.session = session
        self.lock = threading.Lock()
        self._last_frame = None  # (version, scale, png bytes, ts)
        self._frame_gate = threading.Lock()  # serializes renderers, not /state
        # Bumped by every mutating request (event/set/command/open); an
        # unchanged scene serves the cached frame instead of re-rendering —
        # the client's poll loop must not burn device time on an idle scene
        # (the reference repaints continuously, but its GPU is local and
        # otherwise idle; a serving accelerator is shared).
        self._scene_version = 0

    def mark_dirty(self) -> None:
        """Callers MUST hold self.lock: the version bump must order with the
        mutation it describes (and += alone is not atomic), or a concurrent
        render could tag a pre-mutation frame with the post-mutation version
        and the idle cache would serve the stale frame forever."""
        self._scene_version += 1

    # --- frame ---

    def frame_png(self, max_age: float | None = None, scale: float = 1.0) -> bytes:
        """Render one frame. The state lock is held only for the frame
        DISPATCH (jax enqueues asynchronously); the device->host transfer
        and PNG encode run outside it, so `/state`/`/set` stay responsive
        while a large frame renders.
        `max_age` (seconds) serves the cached previous frame when fresh
        enough (client-side staleness tolerance); `scale` downsizes the
        encoded image (resolution degrade knob)."""
        def cached():
            if self._last_frame is None:
                return None
            ver, sc, blob, ts = self._last_frame
            same_cfg = sc == scale
            if max_age is not None and same_cfg \
                    and time.monotonic() - ts <= max_age:
                return blob
            # Idle scene (no mutations since the last render and no load in
            # flight): the frame is identical by construction.
            if same_cfg and ver == self._scene_version \
                    and self.session.loader is None:
                return blob
            return None

        blob = cached()
        if blob is not None:
            return blob
        with self._frame_gate:  # one in-flight render; /state never waits here
            # Double-check: concurrent polls that queued on the gate while
            # another rendered the same scene collapse to one render.
            blob = cached()
            if blob is not None:
                return blob
            with self.lock:
                # Version capture and the render order under the SAME lock
                # as mutators' mark_dirty: a mutation either lands in this
                # frame (bump <= ver) or invalidates it (bump > ver).
                ver = self._scene_version
                img = self.session.update()
                loading = self.session.loader is not None
            blob = _encode_frame(np.asarray(img), scale)
            # A load in flight invalidates immediately (drain happens inside
            # update(), not through a mutating request).
            self._last_frame = (ver if not loading else ver - 1, scale, blob,
                                time.monotonic())
            return blob

    # --- input events (ref input system src/tab/scene.rs:1082-1569) ---

    def handle_event(self, ev: dict) -> None:
        with self.lock:
            self.mark_dirty()
            s = self.session
            cam = s.camera
            t = ev.get("type")
            sens = cam.sensitivity * 0.005
            if t == "orbit" and isinstance(cam.control, CameraOrbitControl):
                cam.control.orbit_by(-ev["dx"] * sens, ev["dy"] * sens)
            elif t == "zoom" and isinstance(cam.control, CameraOrbitControl):
                cam.control.zoom_by(math.pow(1.0015, ev["dy"]))
            elif t == "pan" and isinstance(cam.control, CameraOrbitControl):
                # Exact screen-to-world pan scaling (ref scene.rs:1460-1562):
                # world units per pixel at the target's depth.
                c = cam.control
                d = float(np.linalg.norm(c.arm()))
                h = s.viewer.cfg.height
                per_px = 2.0 * d * math.tan(c.vertical_fov / 2) / h
                view = c.view()
                right = view[0, :3]
                up = view[1, :3]
                c.pan_by((-ev["dx"] * right + ev["dy"] * up) * per_px)
            elif t == "look":
                fp = to_first_person(cam.control)
                fp.yaw_by(-ev["dx"] * sens)
                fp.pitch_by(-ev["dy"] * sens)
                if isinstance(cam.control, CameraOrbitControl):
                    d = float(np.linalg.norm(cam.control.arm()))
                    cam.control = to_orbit(fp, d)
                else:
                    cam.control = fp
            elif t == "move":
                fp = to_first_person(cam.control)
                fwd, rgt = fp.get_forward(), fp.get_right()
                up = np.array([0, 1, 0], np.float32)
                v = (
                    fwd * ev.get("z", 0) + rgt * ev.get("x", 0) + up * ev.get("y", 0)
                ) * cam.speed * ev.get("dt", 0.016)
                if isinstance(cam.control, CameraOrbitControl):
                    cam.control.pan_by(v)
                else:
                    cam.control.pos = cam.control.pos + v
            elif t == "set_control":
                if ev["control"] == "first_person":
                    cam.control = to_first_person(cam.control)
                else:
                    arm = ev.get("arm", 1.0)
                    cam.control = to_orbit(cam.control, arm)
            elif t == "action_start":
                self._action_start(ev)
            elif t == "action_move":
                pos = (ev["x"], ev["y"])
                s.toolset.update_pos(pos)
            elif t == "action_end":
                if s.action == Action.SELECTION:
                    s.end_selection_gesture()
                elif s.action == Action.MEASUREMENT_LOCATE_HIT:
                    s.locate_hit(
                        (ev["x"], ev["y"]), ev.get("pair", 0), ev.get("hit", 0)
                    )
            elif t == "brush_radius":
                s.selection.brush_radius = max(1, int(s.selection.brush_radius + ev["delta"]))
                s.toolset.update_brush_radius(s.selection.brush_radius)

    def _action_start(self, ev: dict) -> None:
        s = self.session
        if s.action != Action.SELECTION:
            return
        # Modifier ops: Shift=Add, Ctrl=Remove (ref scene.rs:1218-1229).
        op = s.selection.operation
        if ev.get("shift"):
            op = QuerySelectionOp.ADD
        elif ev.get("ctrl"):
            op = QuerySelectionOp.REMOVE
        tool = (
            QueryToolset.BRUSH
            if s.selection.method == SelectionMethod.BRUSH
            else QueryToolset.RECT
        )
        s.toolset.set_use_texture(not s.selection.immediate)
        s.toolset.update_brush_radius(s.selection.brush_radius)
        s.toolset.start(tool, op, (ev["x"], ev["y"]))

    # --- state JSON (the tab surface) ---

    def state_json(self) -> dict:
        with self.lock:
            s = self.session
            cam = s.camera
            ctrl = cam.control
            models = {}
            for k, m in s.viewer.models.items():
                count = m.buffers.capacity
                models[k] = {
                    "visible": m.visible,
                    "count": count,
                    "loaded": len(m.buffers),
                    "transform": {
                        "pos": m.transform.pos.tolist(),
                        "rot": m.transform.rot.tolist(),
                        "scale": m.transform.scale.tolist(),
                    },
                    "original_size": human_readable_size(count * 248),
                    "compressed_size": human_readable_size(
                        s.compressions.compressed_size(count)
                    ),
                }
            gt = s.gaussian_transform
            sel = s.selection
            edit = sel.edit
            return {
                "fps": round(s.fps.fps, 1),
                "theme": s.theme,
                "loading": None
                if s.loader is None
                else {
                    "key": s.loader[0],
                    "received": s.loader[1].received,
                    "count": s.loader[1].count,
                },
                "camera": {
                    "control": "orbit" if isinstance(ctrl, CameraOrbitControl) else "first_person",
                    "pos": np.asarray(ctrl.pos).tolist(),
                    "fov_deg": math.degrees(ctrl.vertical_fov),
                    "speed": cam.speed,
                    "sensitivity": cam.sensitivity,
                },
                "models": models,
                "selected_key": s.selected_key,
                "gaussian_transform": {
                    "size": gt.size,
                    "display_mode": gt.display_mode.name.lower(),
                    "sh_deg": gt.sh_deg.degree,
                    "no_sh0": gt.no_sh0,
                },
                "action": s.action.value,
                "selection": {
                    "method": sel.method.value,
                    "operation": sel.operation.value,
                    "immediate": sel.immediate,
                    "brush_radius": sel.brush_radius,
                    "highlight_color": list(sel.highlight_color),
                    "show_unedited": sel.show_unedited,
                    "edit": None
                    if edit is None
                    else {
                        "hidden": edit.hidden,
                        "hsv": list(edit.hsv) if edit.hsv else None,
                        "override_rgb": list(edit.override_rgb) if edit.override_rgb else None,
                        "contrast": edit.contrast,
                        "exposure": edit.exposure,
                        "gamma": edit.gamma,
                        "alpha": edit.alpha,
                    },
                },
                "mask": {
                    "op_code": s.mask.op_code,
                    "shapes": [
                        {
                            "kind": sh.kind.value,
                            "pos": sh.pos.tolist(),
                            "rot": sh.rot.tolist(),
                            "scale": sh.scale.tolist(),
                            "visible": sh.visible,
                        }
                        for sh in s.mask.shapes
                    ],
                },
                "measurement": {
                    "hit_method": s.measurement.hit_method.value,
                    "pairs": [
                        {
                            "label": p.label,
                            "visible": p.visible,
                            "color": list(p.color),
                            "line_width": p.line_width,
                            "hits": [h.pos.tolist() for h in p.hits],
                            "distance": p.distance(),
                        }
                        for p in s.measurement.hit_pairs
                    ],
                },
                # Multi-device routing observability: when a
                # sharded render has run in this process, report its slab
                # routing overflow — nonzero means the scene's slab skew
                # exceeded capacity_factor and far entries were dropped
                # (parallel/render_sharded.py).
                "parallel": _sharded_stats(),
                "compressions": {
                    "sh": s.compressions.sh.value,
                    "cov3d": s.compressions.cov3d.value,
                    # Live size readout data for the picker (the reference's
                    # init modal shows per-field and total sizes,
                    # `src/tab/scene.rs:897-1006`).
                    "field_sizes": _compression_field_sizes(),
                    "total_count": sum(
                        m.buffers.capacity for m in s.viewer.models.values()
                    ),
                },
            }

    def handle_set(self, body: dict) -> None:
        with self.lock:
            self.mark_dirty()
            s = self.session
            for key, v in body.items():
                if key == "gaussian_transform":
                    gt = s.gaussian_transform
                    gt.size = float(v.get("size", gt.size))
                    if "display_mode" in v:
                        gt.display_mode = GaussianDisplayMode[v["display_mode"].upper()]
                    if "sh_deg" in v:
                        gt.sh_deg = GaussianShDegree(int(v["sh_deg"]))
                    gt.no_sh0 = bool(v.get("no_sh0", gt.no_sh0))
                elif key == "action":
                    s.action = Action(v)
                elif key == "selected_key":
                    s.selected_key = v
                elif key == "camera":
                    ctrl = s.camera.control
                    if "fov_deg" in v:
                        ctrl.vertical_fov = math.radians(float(v["fov_deg"]))
                    s.camera.speed = float(v.get("speed", s.camera.speed))
                    s.camera.sensitivity = float(v.get("sensitivity", s.camera.sensitivity))
                elif key == "selection":
                    sel = s.selection
                    if "method" in v:
                        sel.method = SelectionMethod(v["method"])
                    if "operation" in v:
                        sel.operation = QuerySelectionOp(v["operation"])
                    sel.immediate = bool(v.get("immediate", sel.immediate))
                    if "brush_radius" in v:
                        sel.brush_radius = int(v["brush_radius"])
                    if "show_unedited" in v:
                        sel.show_unedited = bool(v["show_unedited"])
                    if "edit" in v:
                        e = v["edit"]
                        sel.edit = None if e is None else SelectionEdit(
                            hidden=e.get("hidden", False),
                            hsv=tuple(e["hsv"]) if e.get("hsv") else (0.0, 1.0, 1.0),
                            override_rgb=tuple(e["override_rgb"]) if e.get("override_rgb") else None,
                            contrast=e.get("contrast", 0.0),
                            exposure=e.get("exposure", 0.0),
                            gamma=e.get("gamma", 1.0),
                            alpha=e.get("alpha", 1.0),
                        )
                elif key == "model":
                    m = s.viewer.models.get(v["key"])
                    if m is None:
                        continue
                    if "visible" in v:
                        m.visible = bool(v["visible"])
                    if "transform" in v:
                        tr = v["transform"]
                        m.transform = ModelTransform(
                            pos=np.asarray(tr["pos"], np.float32),
                            rot=np.asarray(tr["rot"], np.float32),
                            scale=np.asarray(tr["scale"], np.float32),
                        )
                elif key == "compressions":
                    from ..data.compression import (
                        Compressions,
                        Cov3dCompression,
                        ShCompression,
                    )

                    cur = s.compressions
                    s.set_compressions(Compressions(
                        sh=ShCompression(v.get("sh", cur.sh.value)),
                        cov3d=Cov3dCompression(v.get("cov3d", cur.cov3d.value)),
                    ))
                elif key == "theme":
                    if v in ("dark", "light"):
                        s.theme = v
                elif key == "mask_op_code":
                    s.mask.op_code = v
                elif key == "mask_shape":
                    i = v["index"]
                    if 0 <= i < len(s.mask.shapes):
                        sh = s.mask.shapes[i]
                        sh.kind = MaskShapeKind(v.get("kind", sh.kind.value))
                        sh.pos = np.asarray(v.get("pos", sh.pos), np.float32)
                        sh.rot = np.asarray(v.get("rot", sh.rot), np.float32)
                        sh.scale = np.asarray(v.get("scale", sh.scale), np.float32)
                        sh.visible = bool(v.get("visible", sh.visible))
                elif key == "measurement":
                    from ..query.hit import MeasurementHitMethod

                    if "hit_method" in v:
                        s.measurement.hit_method = MeasurementHitMethod(v["hit_method"])
                    if "pair" in v:
                        p = v["pair"]
                        i = p["index"]
                        if 0 <= i < len(s.measurement.hit_pairs):
                            pair = s.measurement.hit_pairs[i]
                            pair.visible = bool(p.get("visible", pair.visible))
                            pair.label = p.get("label", pair.label)
                            if "color" in p:
                                pair.color = tuple(p["color"])
                            if "line_width" in p:
                                pair.line_width = float(p["line_width"])

    def handle_command(self, body: dict) -> dict:
        with self.lock:
            self.mark_dirty()
            s = self.session
            cmd = body.get("cmd")
            if cmd == "remove_model":
                s.viewer.remove_model(body["key"])
                if s.selected_key == body["key"]:
                    s.selected_key = next(iter(s.viewer.models), None)
            elif cmd == "evaluate_mask":
                op = s.mask.parse_op()
                s.evaluate_mask(op)
            elif cmd == "reset_mask":
                s.evaluate_mask(None)
            elif cmd == "commit_edit":
                s.commit_selection_edit()
            elif cmd == "clear_selection":
                for m in s.viewer.models.values():
                    m.buffers.set_selection(np.zeros(m.buffers.capacity, np.uint8))
            elif cmd == "add_mask_shape":
                s.mask.add_shape()
            elif cmd == "remove_mask_shape":
                i = body.get("index", -1)
                if 0 <= i < len(s.mask.shapes):
                    s.mask.shapes.pop(i)
            elif cmd == "add_measurement_pair":
                from .measurement import MeasurementHitPair

                s.measurement.hit_pairs.append(
                    MeasurementHitPair(label=f"Pair {len(s.measurement.hit_pairs)}")
                )
            elif cmd == "remove_measurement_pair":
                i = body.get("index", -1)
                if 0 <= i < len(s.measurement.hit_pairs):
                    s.measurement.hit_pairs.pop(i)
            else:
                return {"ok": False, "error": f"unknown command {cmd!r}"}
            return {"ok": True}

    def handle_open(self, filename: str, data: bytes) -> dict:
        with self.lock:
            self.mark_dirty()
            try:
                self.session.open_model(filename, io.BytesIO(data))
                return {"ok": True}
            except Exception as e:
                return {"ok": False, "error": str(e)}

    def export_bytes(self, choices: dict | None = None) -> tuple:
        # Snapshot under the lock (cheap buffer downloads), serialize the
        # potentially-hundreds-of-MB PLY/ZIP OUTSIDE it so /state, /set and
        # events stay responsive during a 6M-splat export (same fix class
        # as _frame_gate).
        with self.lock:
            s = self.session
            ch = None
            if choices:
                ch = {
                    k: ExportChoice(
                        export=c.get("export", True),
                        with_edit=c.get("with_edit", True),
                        with_mask=c.get("with_mask", True),
                    )
                    for k, c in choices.items()
                }
            snap = snapshot_exports(s.viewer, ch)
        t0 = time.perf_counter()
        buf = io.BytesIO()
        names = serialize_exports(snap, buf)
        _LOG.info("export %s: %s in %.2fs (serialized off-lock)", names,
                  human_readable_size(buf.getbuffer().nbytes),
                  time.perf_counter() - t0)
        multi = len(names) > 1
        fname = "models.zip" if multi else (names[0] if names else "model.ply")
        if not fname.endswith((".ply", ".zip")):
            fname += ".ply"
        ctype = "application/zip" if multi else "application/octet-stream"
        return buf.getvalue(), fname, ctype


def make_handler(server: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json", extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            path = self.path.split("?")[0]
            try:
                if path == "/":
                    html = (ASSETS / "index.html").read_bytes()
                    self._send(200, html, "text/html; charset=utf-8")
                elif path == "/manifest.json":
                    self._send(200, (ASSETS / "manifest.json").read_bytes(),
                               "application/manifest+json")
                elif path == "/sw.js":
                    self._send(200, (ASSETS / "sw.js").read_bytes(),
                               "text/javascript")
                elif path == "/frame.png":
                    from urllib.parse import parse_qs, urlparse

                    qs = parse_qs(urlparse(self.path).query)
                    scale = float(qs.get("scale", ["1.0"])[0])
                    max_age = (
                        float(qs["max_age"][0]) if "max_age" in qs else None
                    )
                    self._send(
                        200, server.frame_png(max_age, scale), "image/png"
                    )
                elif path == "/state":
                    self._json(server.state_json())
                elif path == "/export":
                    data, fname, ctype = server.export_bytes()
                    self._send(
                        200, data, ctype,
                        {"Content-Disposition": f'attachment; filename="{fname}"'},
                    )
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:
                _LOG.warning("GET %s failed: %s", self.path, e)
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                if self.path == "/event":
                    server.handle_event(json.loads(data))
                    self._json({"ok": True})
                elif self.path == "/set":
                    server.handle_set(json.loads(data))
                    self._json({"ok": True})
                elif self.path == "/command":
                    self._json(server.handle_command(json.loads(data)))
                elif self.path == "/open":
                    fname = self.headers.get("X-Filename", "model.ply")
                    self._json(server.handle_open(fname, data))
                elif self.path == "/export":
                    body = json.loads(data) if data else {}
                    blob, fname, ctype = server.export_bytes(body.get("choices"))
                    self._send(
                        200, blob, ctype,
                        {"Content-Disposition": f'attachment; filename="{fname}"'},
                    )
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:
                _LOG.warning("POST %s failed: %s", self.path, e)
                self._json({"error": str(e)}, 500)

    return Handler


def serve(
    session: GaussianSplattingSession | None = None,
    host: str = "127.0.0.1",
    port: int = 8080,
    **session_kw,
):
    """Run the viewer server (blocking)."""
    session = session or GaussianSplattingSession(**session_kw)
    vs = ViewerServer(session)
    httpd = ThreadingHTTPServer((host, port), make_handler(vs))
    _LOG.info("serving on %s:%d", host, port)
    print(f"3DGS viewer at http://{host}:{port}/")
    httpd.serve_forever()
