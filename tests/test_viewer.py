"""Viewer layer tests: buffers, streaming upload, multi-model compositing."""

import numpy as np

import jax.numpy as jnp

from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl, ModelTransform
from wgpu_3dgs_viewer_app_tpu.data import Compressions, make_random_scene
from wgpu_3dgs_viewer_app_tpu.viewer import GaussianBuffers, MultiModelViewer, Viewer

CAM = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))


def test_streaming_update_range_matches_bulk():
    g = make_random_scene(300, seed=0)
    comp = Compressions()
    bulk = GaussianBuffers(300, comp)
    bulk.upload_all(g)
    streamed = GaussianBuffers(300, comp)
    for start in range(0, 300, 100):
        streamed.update_range(start, g.slice(start, start + 100))
    assert len(streamed) == 300
    for k in bulk.pod:
        np.testing.assert_array_equal(np.asarray(bulk.pod[k]), np.asarray(streamed.pod[k]))


def test_single_model_render_shapes():
    g = make_random_scene(256, seed=1, extent=1.0, scale_range=(0.03, 0.1))
    v = Viewer(g, 96, 64)
    img = v.render(CAM)
    assert img.shape == (64, 96, 3)
    arr = np.asarray(img)
    assert np.isfinite(arr).all() and arr.max() > 0.0


def test_background_color():
    g = make_random_scene(8, seed=2, extent=0.1)
    v = Viewer(g, 64, 64, background=(0.2, 0.3, 0.4))
    arr = np.asarray(v.render(CAM))
    # corners should be background (tiny centered scene)
    np.testing.assert_allclose(arr[0, 0], [0.2, 0.3, 0.4], atol=1e-5)


def test_multi_model_back_to_front():
    comp_scene = make_random_scene(128, seed=3, extent=0.3, scale_range=(0.05, 0.12))
    v = MultiModelViewer(64, 64)
    v.add_model("a", comp_scene)
    v.add_model("b", comp_scene)
    # Push model b behind model a.
    v.models["b"].transform = ModelTransform(pos=np.array([0.8, 0, 3.0], np.float32))
    v.update_camera(CAM)
    order = v.model_order()
    assert order == ["b", "a"]  # farthest first
    img2 = np.asarray(v.render(CAM))
    v.models["b"].visible = False
    img1 = np.asarray(v.render(CAM))
    assert np.abs(img2 - img1).max() > 0.01  # b contributes behind a


def test_model_key_dedup_and_remove_last():
    import pytest

    g = make_random_scene(16, seed=4)
    v = MultiModelViewer(32, 32)
    v.add_model("m.ply", g)
    m2 = v.add_model("m.ply", g)
    assert m2.file_name == "m.ply (1)"  # ref dedup `name (n)` scene.rs:386-393
    v.remove_model("m.ply (1)")
    with pytest.raises(ValueError):
        v.remove_model("m.ply")  # refuses last (ref scene.rs:2169-2175)


def test_show_unedited_bypasses_edits():
    from wgpu_3dgs_viewer_app_tpu.core import GaussianEditPod, EDIT_FLAG_ENABLED, EDIT_FLAG_HIDDEN

    g = make_random_scene(128, seed=5, extent=0.5, scale_range=(0.05, 0.1))
    v = Viewer(g, 64, 64)
    base = np.asarray(v.render(CAM))
    # Hide everything via per-splat edits.
    m = v.models["model"]
    flags = np.full(128, EDIT_FLAG_ENABLED | EDIT_FLAG_HIDDEN, np.uint32)
    m.buffers.set_edits(flags, np.asarray(m.buffers.edit_rgb), np.asarray(m.buffers.edit_params))
    hidden = np.asarray(v.render(CAM))
    assert hidden.max() == 0.0
    unedited = np.asarray(v.render(CAM, show_unedited=True))
    np.testing.assert_allclose(unedited, base, atol=1e-6)


def test_resize_respecializes():
    g = make_random_scene(64, seed=6, extent=0.5)
    v = Viewer(g, 64, 64)
    assert v.render(CAM).shape == (64, 64, 3)
    v.resize(96, 48)
    assert v.render(CAM).shape == (48, 96, 3)


def test_commit_selection_edit_and_download():
    from wgpu_3dgs_viewer_app_tpu.core import EDIT_FLAG_ENABLED

    g = make_random_scene(32, seed=7)
    b = GaussianBuffers(32, Compressions())
    b.upload_all(g)
    sel = np.zeros(32, np.uint8)
    sel[:10] = 1
    b.set_selection(sel)
    b.commit_selection_edit(EDIT_FLAG_ENABLED, (0.5, 0.5, 0.5), (0, 0, 1, 0.7))
    flags, rgb, params = b.download_edits()
    assert (flags[:10] == EDIT_FLAG_ENABLED).all() and (flags[10:] == 0).all()
    np.testing.assert_allclose(params[:10, 3], 0.7)


def test_merged_multimodel_equals_sequential_blend():
    """The fused multi-model pass (model rank in the sort key, one sort +
    one compositing pass) must reproduce per-model back-to-front blending
    (`src/tab/scene.rs:2299-2315` semantics) — the over operator is
    associative, so the images agree up to float tolerance."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu.core import ModelTransform
    from wgpu_3dgs_viewer_app_tpu.data import make_random_scene
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer
    from wgpu_3dgs_viewer_app_tpu.core.camera import CameraOrbitControl

    v = MultiModelViewer(160, 96, tile=16, max_dup=4)
    for i, dx in enumerate((-0.6, 0.5)):
        g = make_random_scene(400, seed=i, extent=0.8, scale_range=(0.02, 0.08))
        v.add_model(f"m{i}", g)
        v.update_model_transform(f"m{i}", ModelTransform(pos=np.array([dx, 0, 0.3 * i], np.float32)))
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -3))
    v.update_camera(cam)

    merged = np.asarray(v.render())
    order = v.model_order()
    # sequential reference: per-model images blended back-to-front
    acc = None
    for key in order:
        img = v.render_model(key)
        if acc is None:
            acc = img
        else:
            a = img[..., 3:4]
            acc = np.concatenate(
                [np.asarray(img[..., :3]) + (1.0 - np.asarray(a)) * np.asarray(acc[..., :3]),
                 np.asarray(a) + (1.0 - np.asarray(a)) * np.asarray(acc[..., 3:4])], axis=-1)
    from wgpu_3dgs_viewer_app_tpu.ops.composite import over_background

    seq = np.asarray(over_background(jnp_asarray(acc), v.background))
    diff = np.abs(merged - seq)
    assert diff.max() < 3e-2 and diff.mean() < 1e-4


def jnp_asarray(x):
    import jax.numpy as jnp

    return jnp.asarray(x)
