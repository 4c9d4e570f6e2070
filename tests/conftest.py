"""Test configuration: force the CPU backend with 8 virtual devices.

Tests run on an 8-device virtual CPU mesh so multi-device sharding paths
(`parallel/`) are exercised without accelerators. Set before jax import.

GPU runs: `GS_GPU_TESTS=1 python -m pytest tests/ -m gpu -p no:xdist
-o addopts=""` keeps JAX's default backend, so the `gpu`-marked tests
(compiled Triton kernel, end-to-end images on the card) execute for real in
one process. Whether a card is present is decided by the `gpu` fixture.
"""

import os

import pytest

_GPU_RUN = os.environ.get("GS_GPU_TESTS") == "1"

if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _GPU_RUN:
    # Env vars alone are not enough: a pytest plugin may import jax before
    # this conftest runs, so pin the platform through the config API as well
    # (works any time before first backend creation).
    jax.config.update("jax_platforms", "cpu")
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("JAX_COMPILATION_CACHE_DIR")
    or os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    ".jax_cache"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (GS_GPU_TESTS=1 python -m pytest "
                    "tests/ -m gpu -p no:xdist -o addopts='' on the card)")
    return devs[0]

