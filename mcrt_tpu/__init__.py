"""mcrt_tpu — a differentiable Monte Carlo path tracer in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference OpenCL
wavefront renderer (compix/Monte-Carlo-Raytracer): the bounce loop is one
jitted XLA program, intersection runs in Pallas kernels compiled through
Triton for NVIDIA GPUs, distribution is a `jax.sharding.Mesh`, and the whole
renderer differentiates end-to-end.  See SURVEY.md for the reference
analysis this build follows.

Compiled programs persist in ``JAX_COMPILATION_CACHE_DIR`` when that is
set, and otherwise in ``<repo>/.jax_cache``.
"""
import os as _os

import jax as _jax

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

from .config import (  # noqa: E402
    AccelType,
    FilterType,
    IntegratorType,
    RenderConfig,
    SamplerType,
)
from .renderer import Renderer  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AccelType",
    "FilterType",
    "IntegratorType",
    "RenderConfig",
    "Renderer",
    "SamplerType",
]
