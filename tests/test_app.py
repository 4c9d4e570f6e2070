"""App layer tests: session orchestration, streaming load, export, measurement."""

import io

import numpy as np
import pytest

from wgpu_3dgs_viewer_app_tpu.app import (
    Action,
    ExportChoice,
    GaussianSplattingSession,
    SceneCommand,
    SceneCommandKind,
    SelectionEdit,
    SelectionMethod,
    export_models,
)
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene, read_ply, write_ply


def ply_bytes(n=200, seed=0, **kw):
    g = make_random_scene(n, seed=seed, **kw)
    buf = io.BytesIO()
    write_ply(buf, g)
    buf.seek(0)
    return g, buf


def make_session(**kw):
    kw.setdefault("width", 64)
    kw.setdefault("height", 64)
    return GaussianSplattingSession(**kw)


def test_open_and_stream_load():
    s = make_session()
    g, buf = ply_bytes(500)
    s.open_model("m.ply", buf)
    assert s.loader is not None
    # Loader count known header-first.
    assert s.loader[1].count == 500
    for _ in range(100):
        s._drain_loader()
        if s.loader is None:
            break
    assert s.loader is None
    m = s.viewer.models["m.ply"]
    assert len(m.buffers) == 500
    np.testing.assert_allclose(m.gaussians.pos, g.pos)


def test_concurrent_load_rejected():
    s = make_session()
    _, buf = ply_bytes(300)
    s.open_model("a.ply", buf)
    _, buf2 = ply_bytes(10)
    with pytest.raises(RuntimeError):
        s.open_model("b.ply", buf2)  # ref scene.rs:395-398


def test_frame_update_renders():
    s = make_session()
    _, buf = ply_bytes(200, extent=0.5, scale_range=(0.05, 0.1))
    s.open_model("m.ply", buf)
    img = None
    for _ in range(50):
        img = s.update()
        if s.loader is None:
            break
    img = np.asarray(s.update())
    assert img.shape == (64, 64, 3)
    assert img.max() > 0


def test_scene_command_bus():
    s = make_session()
    _, buf = ply_bytes(50)
    s.send_command(
        SceneCommand(SceneCommandKind.ADD_MODEL, file_name="x.ply", reader=buf)
    )
    s.update()
    assert "x.ply" in s.viewer.models


def test_mask_evaluate_via_opcode():
    from wgpu_3dgs_viewer_app_tpu.mask import MaskShape, MaskShapeKind

    s = make_session()
    g, buf = ply_bytes(100, extent=1.0)
    s.open_model("m.ply", buf)
    while s.loader is not None:
        s._drain_loader()
    shape = MaskShape(kind=MaskShapeKind.BOX, scale=np.array([1, 1, 1], np.float32))
    s.mask.add_shape(shape)
    s.mask.op_code = "0"
    s.evaluate_mask(s.mask.parse_op())
    bits = s.viewer.models["m.ply"].buffers.download_mask()  # trims lane padding
    inside = np.all(np.abs(g.pos) <= 0.5, axis=1)
    np.testing.assert_array_equal(bits.astype(bool), inside)
    # Reset restores everything.
    s.evaluate_mask(None)
    assert s.viewer.models["m.ply"].buffers.download_mask().all()


def test_measurement_locate_hit_and_distance():
    s = make_session()
    g, buf = ply_bytes(1, extent=0.0, scale_range=(0.3, 0.30001))
    s.open_model("m.ply", buf)
    while s.loader is not None:
        s._drain_loader()
    s.action = Action.MEASUREMENT_LOCATE_HIT
    ok = s.locate_hit((32, 32), 0, 0)
    assert ok
    pair = s.measurement.hit_pairs[0]
    # Splat sits at its position; hit should be near it (cam on -z axis).
    assert abs(pair.hits[0].pos[2] - g.pos[0][2]) < 0.2
    pair.hits[1].pos = pair.hits[0].pos + np.array([3, 4, 0], np.float32)
    assert abs(pair.distance() - 5.0) < 1e-5


def test_selection_gesture_and_commit_edit():
    s = make_session()
    g, buf = ply_bytes(100, extent=1.0, scale_range=(0.02, 0.05))
    s.open_model("m.ply", buf)
    while s.loader is not None:
        s._drain_loader()
    s.action = Action.SELECTION
    s.selection.method = SelectionMethod.RECT
    s.selection.immediate = True
    s.toolset.set_use_texture(False)
    from wgpu_3dgs_viewer_app_tpu.query import QuerySelectionOp, QueryToolset

    s.toolset.start(QueryToolset.RECT, QuerySelectionOp.SET, (0, 0))
    s.toolset.update_pos((64, 64))
    s.end_selection_gesture()
    # download_selection trims the device array's padded capacity to the
    # loaded count, matching download_edits below.
    bits = s.viewer.models["m.ply"].buffers.download_selection()
    assert bits.sum() > 0
    # live edit then commit
    s.selection.edit = SelectionEdit(alpha=0.5)
    s.commit_selection_edit()
    flags, _, params = s.viewer.models["m.ply"].buffers.download_edits()
    assert (flags[bits.astype(bool)] != 0).all()
    np.testing.assert_allclose(params[bits.astype(bool), 3], 0.5)


def test_export_single_and_zip():
    import zipfile

    s = make_session()
    g, buf = ply_bytes(40)
    s.open_model("a.ply", buf)
    while s.loader is not None:
        s._drain_loader()
    out = io.BytesIO()
    names = export_models(s.viewer, out)
    assert names == ["a.ply"]
    out.seek(0)
    g2 = read_ply(out)
    np.testing.assert_allclose(g2.pos, g.pos)

    # add second model -> zip
    _, buf2 = ply_bytes(30, seed=9)
    s.open_model("b.ply", buf2)
    while s.loader is not None:
        s._drain_loader()
    out = io.BytesIO()
    names = export_models(s.viewer, out)
    assert set(names) == {"a.ply", "b.ply"}
    out.seek(0)
    with zipfile.ZipFile(out) as zf:
        assert set(zf.namelist()) == {"a.ply", "b.ply"}


def test_server_export_choices_and_off_lock():
    """POST /export body path (the browser modal, ref src/app.rs:659-894):
    per-model choices select which models ship, and serialization runs
    OUTSIDE the session lock so /state stays responsive during big exports."""
    import zipfile

    from wgpu_3dgs_viewer_app_tpu.app import export as export_mod
    from wgpu_3dgs_viewer_app_tpu.app.server import ViewerServer

    s = make_session()
    for name, n in (("a.ply", 40), ("b.ply", 30)):
        _, buf = ply_bytes(n, seed=n)
        s.open_model(name, buf)
        while s.loader is not None:
            s._drain_loader()
    vs = ViewerServer(s)

    lock_free_during_write = []
    real_write_ply = export_mod.write_ply

    def probing_write_ply(*a, **kw):
        ok = vs.lock.acquire(blocking=False)
        if ok:
            vs.lock.release()
        lock_free_during_write.append(ok)
        return real_write_ply(*a, **kw)

    export_mod.write_ply = probing_write_ply
    try:
        blob, fname, ctype = vs.export_bytes(
            {"a.ply": {"export": True, "with_edit": False},
             "b.ply": {"export": False}}
        )
    finally:
        export_mod.write_ply = real_write_ply
    assert fname == "a.ply" and ctype == "application/octet-stream"
    assert read_ply(io.BytesIO(blob)).count == 40
    assert lock_free_during_write and all(lock_free_during_write)

    # Both selected -> zip with both members.
    blob, fname, _ = vs.export_bytes(None)
    assert fname == "models.zip"
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert set(zf.namelist()) == {"a.ply", "b.ply"}


def test_export_with_mask_filter():
    s = make_session()
    g, buf = ply_bytes(60)
    s.open_model("a.ply", buf)
    while s.loader is not None:
        s._drain_loader()
    mask = np.zeros(60, np.uint8)
    mask[:25] = 1
    s.viewer.models["a.ply"].buffers.set_mask(mask)
    out = io.BytesIO()
    export_models(s.viewer, out, {"a.ply": ExportChoice(with_edit=False, with_mask=True)})
    out.seek(0)
    assert read_ply(out).count == 25


def test_cli_orbit_sequence(tmp_path):
    """`render --frames N` writes an indexed orbit sequence through the
    same pipelined dispatch the bench measures."""
    from wgpu_3dgs_viewer_app_tpu.app.cli import main

    _, buf = ply_bytes(150, extent=0.5)
    ply = tmp_path / "m.ply"
    ply.write_bytes(buf.getvalue())
    out = tmp_path / "seq.png"
    rc = main(["--platform", "cpu", "render", str(ply), "-o", str(out),
               "--width", "64", "--height", "64", "--sh-deg", "0",
               "--frames", "2", "--orbit-step", "20", "--distance", "3"])
    assert rc == 0
    a, b = tmp_path / "seq_000.png", tmp_path / "seq_001.png"
    assert a.exists() and b.exists()
    assert a.read_bytes() != b.read_bytes()  # camera actually moved


def test_fps_counter():
    from wgpu_3dgs_viewer_app_tpu.app import FpsCounter

    c = FpsCounter()
    for _ in range(5):
        c.tick()
    assert c.fps == 0.0  # refreshes at 1 s interval (ref scene.rs:327-337)


def test_measurement_overlay_draws_line():
    import jax.numpy as jnp

    from wgpu_3dgs_viewer_app_tpu.app import Measurement, MeasurementHitPair
    from wgpu_3dgs_viewer_app_tpu.app.measurement import render_measurement_overlay
    from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl

    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    img = jnp.zeros((64, 64, 3))
    m = Measurement()
    pair = MeasurementHitPair(label="p", line_width=2.0)
    pair.hits[0].pos = np.array([-0.5, 0, 0], np.float32)
    pair.hits[1].pos = np.array([0.5, 0, 0], np.float32)
    m.hit_pairs.append(pair)
    out = np.asarray(
        render_measurement_overlay(img, m, cam.view(), cam.projection(1.0))
    )
    assert out[:, :, 0].max() > 0.5  # red line drawn
    pair.visible = False
    out2 = np.asarray(
        render_measurement_overlay(img, m, cam.view(), cam.projection(1.0))
    )
    assert out2.max() == 0.0


def test_compression_switch_repacks_loaded_models():
    """Changing compression on a loaded scene re-packs pods and keeps the
    render close to the original (closes the reference's compression-menu
    UX, `src/app.rs:228-258`, `src/tab/scene.rs:876-1006`)."""
    from wgpu_3dgs_viewer_app_tpu.data import (
        Compressions,
        Cov3dCompression,
        ShCompression,
    )

    s = make_session()
    _, buf = ply_bytes(300, extent=0.5, scale_range=(0.05, 0.1))
    s.open_model("m.ply", buf)
    for _ in range(50):
        s.update()
        if s.loader is None:
            break
    img_norm8 = np.asarray(s.update())
    full = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)
    s.set_compressions(full)
    assert s.viewer.comp == full
    assert s.viewer.models["m.ply"].buffers.comp == full
    img_full = np.asarray(s.update())
    assert img_full.shape == img_norm8.shape
    # Quantization differences only — images stay visually identical.
    assert np.abs(img_full - img_norm8).mean() < 0.02
    # Selection/mask sidecars carried over.
    m = s.viewer.models["m.ply"]
    assert m.buffers.mask.shape[0] == m.buffers.capacity


def test_compression_switch_rejected_while_loading():
    s = make_session()
    _, buf = ply_bytes(100)
    s.open_model("m.ply", buf)
    from wgpu_3dgs_viewer_app_tpu.data import (
        Compressions,
        Cov3dCompression,
        ShCompression,
    )

    with pytest.raises(RuntimeError):
        s.set_compressions(Compressions(ShCompression.HALF, Cov3dCompression.HALF))


def test_server_state_and_set_compressions():
    from wgpu_3dgs_viewer_app_tpu.app.server import ViewerServer
    from wgpu_3dgs_viewer_app_tpu.utils.png import decode_png

    s = make_session()
    _, buf = ply_bytes(120, extent=0.5)
    s.open_model("m.ply", buf)
    for _ in range(50):
        s.update()
        if s.loader is None:
            break
    vs = ViewerServer(s)
    st = vs.state_json()
    assert st["compressions"]["sh"] == "norm8"
    fs = st["compressions"]["field_sizes"]
    assert fs["pos"] == 12 and "norm8" in fs["sh"] and "half" in fs["cov3d"]
    assert st["compressions"]["total_count"] >= 120
    vs.handle_set({"compressions": {"sh": "half", "cov3d": "single"}})
    assert s.compressions.sh.value == "half"
    assert s.compressions.cov3d.value == "single"
    # frame path with staleness + scale knobs
    blob1 = vs.frame_png(scale=0.5)
    assert blob1[:8] == b"\x89PNG\r\n\x1a\n"
    assert decode_png(blob1).shape[:2] == (s.viewer.cfg.height // 2, s.viewer.cfg.width // 2)
    blob2 = vs.frame_png(max_age=60.0, scale=0.5)
    assert blob2 == blob1  # served from cache within max_age


def test_frame_cache_idle_scene_and_dirty_invalidation():
    """An unchanged scene serves the cached frame (no device re-render);
    any mutating request invalidates it."""
    from wgpu_3dgs_viewer_app_tpu.app.server import ViewerServer

    s = make_session()
    _, buf = ply_bytes(60, extent=0.5)
    s.open_model("m.ply", buf)
    for _ in range(50):
        s.update()
        if s.loader is None:
            break
    vs = ViewerServer(s)
    renders = []
    real_update = s.update
    s.update = lambda: (renders.append(1), real_update())[1]

    b1 = vs.frame_png()
    b2 = vs.frame_png()  # idle: cached, no render
    assert b2 is b1 and len(renders) == 1
    assert vs.frame_png(scale=0.5) != b""  # knob change -> re-render
    assert len(renders) == 2
    vs.handle_event({"type": "orbit", "dx": 10.0, "dy": 0.0})
    b3 = vs.frame_png(scale=0.5)
    assert len(renders) == 3
    vs.frame_png(scale=0.5)
    assert len(renders) == 3  # idle again
    assert b3 is not b1


def test_first_person_look_and_move_events():
    """The pointer-lock FP path: set_control -> look -> move over /event
    (ref scene.rs:1278-1326 pointer lock, :1357-1458 FP camera)."""
    from wgpu_3dgs_viewer_app_tpu.app.server import ViewerServer
    from wgpu_3dgs_viewer_app_tpu.core.camera import CameraFirstPersonControl

    s = make_session()
    _, buf = ply_bytes(50, extent=0.5)
    s.open_model("m.ply", buf)
    for _ in range(50):
        s.update()
        if s.loader is None:
            break
    vs = ViewerServer(s)

    vs.handle_event({"type": "set_control", "control": "first_person"})
    fp = s.camera.control
    assert isinstance(fp, CameraFirstPersonControl)
    yaw0, pitch0, pos0 = fp.yaw, fp.pitch, np.array(fp.pos)

    vs.handle_event({"type": "look", "dx": 40.0, "dy": -25.0})
    fp = s.camera.control
    assert isinstance(fp, CameraFirstPersonControl)  # stays FP
    assert fp.yaw != yaw0 and fp.pitch != pitch0

    vs.handle_event({"type": "move", "x": 1.0, "z": 0.5, "dt": 0.1})
    assert np.linalg.norm(np.array(s.camera.control.pos) - pos0) > 0

    # In orbit mode a look is pose-preserving: position fixed, target moves.
    vs.handle_event({"type": "set_control", "control": "orbit", "arm": 2.0})
    orb_pos0 = np.array(s.camera.control.pos)
    vs.handle_event({"type": "look", "dx": 30.0, "dy": 0.0})
    assert np.allclose(np.array(s.camera.control.pos), orb_pos0, atol=1e-5)
