"""The one place the render path picks its implementation.

Every stage that has a hand-written GPU kernel and a plain jnp reference
asks `render_impl` which to run; nothing else inspects the platform.
"""

from __future__ import annotations

from typing import Optional

import jax

# Platform -> implementation name. "gpu" runs the Triton tile compositor
# (ops/composite.composite_tiles_gpu); "cpu" runs the jnp reference path.
_IMPLS = {"gpu": "gpu", "cpu": "cpu"}


def render_impl(platform: Optional[str] = None) -> str:
    """Implementation name for `platform` (default: JAX's default backend).

    Raises ValueError for a platform with no render path, naming it."""
    platform = platform or jax.default_backend()
    try:
        return _IMPLS[platform]
    except KeyError:
        raise ValueError(
            f"no render implementation for platform {platform!r} "
            f"(supported: {sorted(_IMPLS)})"
        ) from None
