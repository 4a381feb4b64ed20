"""Progressive filter-importance-weighted accumulation.

Analogue of ``assets/kernels/reconstruction.cl:6-60``: radiance is clamped to
``max_radiance`` (``RT_MAX_ALLOWED_RADIANCE``, ``kernel_data.h:13``), weighted
by the reconstruction filter evaluated at the frame's sub-pixel jitter offset,
and accumulated into (weighted-sum, weight-sum) buffers; the display image is
weightedSum / weightSum.  This accumulator state *is* the checkpointable
render state (SURVEY §5 checkpoint/resume).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core.pytree import PyTreeNode, field

from ..config import FilterConfig
from .filters import eval_filter


class Accumulator(PyTreeNode):
    weighted: jax.Array  # (H, W, 3) filter-weighted radiance sum
    weight: jax.Array  # (H, W) filter weight sum
    frame: jax.Array  # () i32 frames accumulated (spp so far)

    @classmethod
    def zeros(cls, width: int, height: int):
        return cls(
            weighted=jnp.zeros((height, width, 3), jnp.float32),
            weight=jnp.zeros((height, width), jnp.float32),
            frame=jnp.asarray(0, jnp.int32),
        )

    def reset(self):
        """Accumulation reset on camera move / scene update
        (``RTPathTracingPass.cpp:31, 49-53``)."""
        return Accumulator.zeros(self.weighted.shape[1], self.weighted.shape[0])

    @property
    def image(self) -> jax.Array:
        w = jnp.maximum(self.weight, 1e-8)[..., None]
        return self.weighted / w


def accumulate(
    accum: Accumulator,
    radiance: jax.Array,  # (H, W, 3) or (H*W, 3)
    jitter: jax.Array,  # (2,) this frame's sub-pixel offset in pixels
    cfg: FilterConfig,
    max_radiance: float = 1000.0,
) -> Accumulator:
    h, w = accum.weight.shape
    radiance = radiance.reshape(h, w, 3)
    radiance = jnp.clip(radiance, 0.0, max_radiance)
    # single jitter per frame (the reference jitters the whole frame by one
    # TAA sobol offset, PathTracingApp.cpp:208-215): one filter weight/frame
    fw = eval_filter(cfg, jitter)
    return Accumulator(
        weighted=accum.weighted + radiance * fw,
        weight=accum.weight + fw,
        frame=accum.frame + 1,
    )
