"""The one backend choice (`ops/backend.render_impl`) and the sharded
renderer's transport choice that follows from it."""

import jax
import pytest

from wgpu_3dgs_viewer_app_tpu.ops import render_impl
from wgpu_3dgs_viewer_app_tpu.parallel import make_mesh
from wgpu_3dgs_viewer_app_tpu.parallel.render_sharded import mesh_impl


@pytest.mark.parametrize("platform,impl", [("gpu", "gpu"), ("cpu", "cpu")])
def test_render_impl_by_platform(platform, impl):
    assert render_impl(platform) == impl


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_render_impl_rejects_unknown_platform(platform):
    with pytest.raises(ValueError, match=repr(platform)):
        render_impl(platform)


def test_render_impl_defaults_to_jax_backend():
    assert render_impl() == render_impl(jax.default_backend()) == "cpu"


def test_cpu_mesh_routes_with_equal_split_all_to_all():
    assert mesh_impl(make_mesh(jax.devices()[:2])) == ("cpu", False)


def test_viewer_and_session_take_the_backend_choice():
    from wgpu_3dgs_viewer_app_tpu.app.state import GaussianSplattingSession
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer

    assert MultiModelViewer(32, 32).impl == "cpu"
    assert MultiModelViewer(32, 32, impl="gpu").impl == "gpu"
    assert GaussianSplattingSession(32, 32).viewer.impl == "cpu"
