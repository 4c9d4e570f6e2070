"""Core math tests: cameras, transforms, SH, covariance, edits."""

import math

import numpy as np
import pytest

from wgpu_3dgs_viewer_app_tpu.core import (
    Camera,
    CameraFirstPersonControl,
    CameraOrbitControl,
    GaussianDisplayMode,
    GaussianShDegree,
    ModelTransform,
    look_at_rh,
    perspective_rh,
    quat_from_euler_zyx_deg,
    quat_to_mat3,
    to_first_person,
    to_orbit,
)


def test_look_at_rh_basics():
    # Camera at +Z looking at origin: forward is -Z in view space.
    v = look_at_rh(np.array([0, 0, 5.0]), np.zeros(3), np.array([0, 1, 0.0]))
    p = v @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 0, -5], atol=1e-6)
    # A point right of the target (+X from camera's view at +Z looking -Z):
    p2 = v @ np.array([1, 0, 0, 1.0])
    assert p2[0] > 0  # glam look_at_rh: +x view axis is camera right


def test_perspective_rh_depth_range():
    pr = perspective_rh(math.radians(60), 16 / 9, 0.1, 100.0)
    # near plane -> ndc z 0, far plane -> 1 (wgpu convention)
    for z, expect in ((-0.1, 0.0), (-100.0, 1.0)):
        clip = pr @ np.array([0, 0, z, 1.0])
        np.testing.assert_allclose(clip[2] / clip[3], expect, atol=1e-5)


def test_camera_conversions_preserve_pose():
    # Ref src/app.rs:1293-1327: orbit -> first person keeps pos + direction.
    orbit = CameraOrbitControl(target=(1, 2, 3), pos=(4, 2, -1))
    fp = to_first_person(orbit)
    np.testing.assert_allclose(fp.pos, orbit.pos)
    d = orbit.target - orbit.pos
    d = d / np.linalg.norm(d)
    np.testing.assert_allclose(fp.get_forward(), d, atol=1e-6)
    # and back with arm length = distance restores the target
    back = to_orbit(fp, float(np.linalg.norm(orbit.target - orbit.pos)))
    np.testing.assert_allclose(back.target, orbit.target, atol=1e-5)
    # view matrices agree
    np.testing.assert_allclose(fp.view(), orbit.view(), atol=1e-5)


def test_camera_defaults_match_reference():
    # Ref src/app.rs:1186-1200: orbit at origin from -Z, fov 60deg, z 0.1..1e4.
    cam = Camera.default()
    c = cam.control
    assert isinstance(c, CameraOrbitControl)
    np.testing.assert_allclose(c.target, 0)
    np.testing.assert_allclose(c.pos, [0, 0, -1])
    assert (c.z_near, c.z_far) == (0.1, 1e4)
    assert abs(c.vertical_fov - math.radians(60)) < 1e-9
    assert cam.speed == 1.0 and cam.sensitivity == 0.5


def test_orbit_controls():
    c = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -2))
    c.orbit_by(math.pi / 2, 0.0)
    np.testing.assert_allclose(np.linalg.norm(c.arm()), 2.0, rtol=1e-6)
    c.zoom_by(0.5)
    np.testing.assert_allclose(np.linalg.norm(c.arm()), 1.0, rtol=1e-6)
    c.pan_by((1, 0, 0))
    np.testing.assert_allclose(c.target, [1, 0, 0], atol=1e-6)


def test_first_person_controls():
    fp = CameraFirstPersonControl()
    fp.pitch_by(10.0)  # clamped below pi/2
    assert fp.pitch < math.pi / 2
    fp2 = CameraFirstPersonControl()
    fp2.yaw_by(math.pi / 2)
    np.testing.assert_allclose(fp2.get_forward(), [1, 0, 0], atol=1e-6)


def test_quat_euler_zyx_matches_reference_convention():
    # Ref src/app.rs:1122-1131: Quat::from_euler(ZYX, z, y, x), degrees.
    # Pure Z rotation of 90deg about Z maps +X to +Y.
    q = quat_from_euler_zyx_deg((0, 0, 90))
    m = quat_to_mat3(q)
    np.testing.assert_allclose(m @ np.array([1, 0, 0.0]), [0, 1, 0], atol=1e-6)
    # Composition order: ZYX means q = qz * qy * qx.
    q2 = quat_from_euler_zyx_deg((90, 0, 90))
    m2 = quat_to_mat3(q2)
    # apply x-rot first (maps +Y->+Z), then z-rot (maps +Z->+Z): +Y -> +Z
    np.testing.assert_allclose(m2 @ np.array([0, 1, 0.0]), [0, 0, 1], atol=1e-6)


def test_model_transform_matrix():
    t = ModelTransform(
        pos=np.array([1, 2, 3], np.float32),
        rot=np.array([0, 90, 0], np.float32),
        scale=np.array([2, 2, 2], np.float32),
    )
    m = t.matrix()
    # +Z rotated about Y by 90deg -> +X, scaled by 2, translated.
    p = m @ np.array([0, 0, 1, 1.0])
    np.testing.assert_allclose(p[:3], [3, 2, 3], atol=1e-5)


def test_sh_degree_validation():
    with pytest.raises(ValueError):
        GaussianShDegree(4)
    assert GaussianShDegree(2).degree == 2
    assert list(GaussianDisplayMode) == [0, 1, 2]


def test_sh_eval_dc_only():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core.sh import SH_C0, eval_sh

    sh0 = jnp.ones((4, 3))
    rest = jnp.zeros((4, 15, 3))
    dirs = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4, 1))
    c = eval_sh(sh0, rest, dirs, degree=0)
    np.testing.assert_allclose(np.asarray(c), 0.5 + SH_C0, rtol=1e-6)
    c2 = eval_sh(sh0, rest, dirs, degree=0, no_sh0=True)
    np.testing.assert_allclose(np.asarray(c2), 0.5, rtol=1e-6)


def test_sh_eval_degree1_direction_dependence():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core.sh import eval_sh

    sh0 = jnp.zeros((1, 3))
    rest = jnp.zeros((1, 15, 3)).at[0, 1, :].set(1.0)  # the +z-linear basis fn
    up = eval_sh(sh0, rest, jnp.array([[0.0, 0.0, 1.0]]), 1)
    down = eval_sh(sh0, rest, jnp.array([[0.0, 0.0, -1.0]]), 1)
    assert float(up[0, 0]) > 0.5 > float(down[0, 0])


def test_cov3d_isotropic():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core.covariance import cov3d_from_scale_rot

    c6 = cov3d_from_scale_rot(jnp.full((1, 3), 2.0), jnp.array([[1.0, 0, 0, 0]]))
    np.testing.assert_allclose(np.asarray(c6)[0], [4, 0, 0, 4, 0, 4], atol=1e-6)
    # Rotation invariance for isotropic scale.
    q = jnp.asarray(np.random.default_rng(0).normal(size=(1, 4)))
    c6r = cov3d_from_scale_rot(jnp.full((1, 3), 2.0), q)
    np.testing.assert_allclose(np.asarray(c6r)[0], [4, 0, 0, 4, 0, 4], atol=1e-5)


def test_edit_identity_is_noop():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core import EDIT_FLAG_ENABLED, apply_edit, make_edit_soa

    rgb = jnp.asarray(np.random.default_rng(1).uniform(0.05, 0.95, (16, 3)).astype(np.float32))
    op = jnp.asarray(np.random.default_rng(2).uniform(0.1, 1, 16).astype(np.float32))
    f, r, p = (jnp.asarray(a) for a in make_edit_soa(16))
    # Disabled: exact no-op.
    rgb2, op2, hidden = apply_edit(rgb, op, f, r, p)
    np.testing.assert_array_equal(np.asarray(rgb2), np.asarray(rgb))
    # Enabled with identity params: near no-op (hsv roundtrip).
    f = f | jnp.uint32(EDIT_FLAG_ENABLED)
    rgb3, op3, hidden3 = apply_edit(rgb, op, f, r, p)
    np.testing.assert_allclose(np.asarray(rgb3), np.asarray(rgb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(op3), np.asarray(op), atol=1e-6)
    assert not np.asarray(hidden3).any()


def test_edit_override_and_hidden():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core import (
        EDIT_FLAG_ENABLED,
        EDIT_FLAG_HIDDEN,
        EDIT_FLAG_OVERRIDE_COLOR,
        apply_edit,
    )

    rgb = jnp.full((2, 3), 0.25)
    op = jnp.full((2,), 0.8)
    flags = jnp.asarray(
        [EDIT_FLAG_ENABLED | EDIT_FLAG_OVERRIDE_COLOR, EDIT_FLAG_ENABLED | EDIT_FLAG_HIDDEN],
        jnp.uint32,
    )
    er = jnp.asarray([[0.1, 0.9, 0.3], [0, 1, 1]], jnp.float32)
    ep = jnp.asarray([[0, 0, 1, 1], [0, 0, 1, 1]], jnp.float32)
    rgb2, op2, hidden = apply_edit(rgb, op, flags, er, ep)
    np.testing.assert_allclose(np.asarray(rgb2)[0], [0.1, 0.9, 0.3], atol=1e-6)
    assert bool(hidden[1]) and not bool(hidden[0])


def test_hsv_roundtrip():
    import jax.numpy as jnp
    from wgpu_3dgs_viewer_app_tpu.core.edit import hsv_to_rgb, rgb_to_hsv

    rgb = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (64, 3)).astype(np.float32))
    back = hsv_to_rgb(rgb_to_hsv(rgb))
    np.testing.assert_allclose(np.asarray(back), np.asarray(rgb), atol=1e-5)


def test_apply_edit_np_matches_jnp():
    """Host-path numpy edit baking == the device apply_edit (export must
    not touch JAX: eager op-by-op dispatch costs seconds per export)."""
    import numpy as np
    import jax.numpy as jnp

    from wgpu_3dgs_viewer_app_tpu.core.edit import (
        EDIT_FLAG_ENABLED,
        EDIT_FLAG_HIDDEN,
        EDIT_FLAG_OVERRIDE_COLOR,
        apply_edit,
        apply_edit_np,
    )

    rng = np.random.default_rng(4)
    n = 512
    rgb = rng.random((n, 3), np.float32)
    op = rng.random(n, np.float32)
    flags = rng.choice(
        [0, EDIT_FLAG_ENABLED, EDIT_FLAG_ENABLED | EDIT_FLAG_OVERRIDE_COLOR,
         EDIT_FLAG_ENABLED | EDIT_FLAG_HIDDEN], n).astype(np.uint32)
    ergb = rng.random((n, 3), np.float32) * np.array([1.0, 1.5, 1.5], np.float32)
    eprm = np.stack([
        rng.uniform(-0.5, 0.5, n), rng.uniform(-1, 1, n),
        rng.uniform(0.2, 2.5, n), rng.uniform(0, 1, n),
    ], -1).astype(np.float32)

    r_np, o_np, h_np = apply_edit_np(rgb, op, flags, ergb, eprm)
    r_j, o_j, h_j = apply_edit(
        jnp.asarray(rgb), jnp.asarray(op), jnp.asarray(flags),
        jnp.asarray(ergb), jnp.asarray(eprm))
    np.testing.assert_allclose(r_np, np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(o_np, np.asarray(o_j), atol=1e-6)
    np.testing.assert_array_equal(h_np, np.asarray(h_j))
