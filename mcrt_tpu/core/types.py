"""Core SoA pytrees for the wavefront renderer.

Re-design of the reference's device structs
(``assets/kernels/kernel_data.h``): instead of arrays-of-structs in OpenCL
global memory (``RTRay`` :404-417, ``RTIntersection`` :394-402,
``RTInteraction`` :162-200, ``RTThroughput`` :154-160) we carry
struct-of-arrays pytrees, each leaf a flat ``(N, ...)`` jnp array.  XLA lays
these out densely; masking replaces the reference's
per-ray active flags (``kernel_data.h:419-440``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .pytree import PyTreeNode, field


class Rays(PyTreeNode):
    """A batch of rays (SoA). Inactive rays are masked via ``active``."""

    o: jax.Array  # (N, 3) origins
    d: jax.Array  # (N, 3) directions (unit)
    tmin: jax.Array  # (N,)
    tmax: jax.Array  # (N,)
    active: jax.Array  # (N,) bool

    @classmethod
    def make(cls, o, d, tmin=None, tmax=None, active=None):
        n = o.shape[0]
        if tmin is None:
            tmin = jnp.zeros((n,), jnp.float32)
        if tmax is None:
            tmax = jnp.full((n,), jnp.finfo(jnp.float32).max, jnp.float32)
        if active is None:
            active = jnp.ones((n,), bool)
        return cls(o=o, d=d, tmin=tmin, tmax=tmax, active=active)

    @property
    def n(self) -> int:
        return self.o.shape[0]

    def at(self, t: jax.Array) -> jax.Array:
        return self.o + self.d * t[..., None]


class RayDiff(PyTreeNode):
    """Camera-ray differentials — analogue of ``RTRayDifferentials``
    (``kernel_data.h:266-272``): the directions of the rays through the
    neighboring pixel centers (+1 in x, +1 in y).  A pinhole shares the
    origin across pixels, so only the directions are carried."""

    dddx: jax.Array  # (N, 3) direction of the x-neighbor pixel's ray
    dddy: jax.Array  # (N, 3) direction of the y-neighbor pixel's ray


class Hit(PyTreeNode):
    """Closest-hit record — analogue of ``RTIntersection``
    (``kernel_data.h:394-402``): shape id, prim id, barycentric uv, t."""

    t: jax.Array  # (N,) hit distance (tmax if miss)
    prim: jax.Array  # (N,) int32 global triangle index (-1 if miss)
    shape: jax.Array  # (N,) int32 shape id (-1 if miss)
    u: jax.Array  # (N,) barycentric u
    v: jax.Array  # (N,) barycentric v
    valid: jax.Array  # (N,) bool

    @classmethod
    def none(cls, n: int):
        return cls(
            t=jnp.full((n,), jnp.finfo(jnp.float32).max, jnp.float32),
            prim=jnp.full((n,), -1, jnp.int32),
            shape=jnp.full((n,), -1, jnp.int32),
            u=jnp.zeros((n,), jnp.float32),
            v=jnp.zeros((n,), jnp.float32),
            valid=jnp.zeros((n,), bool),
        )


class Interaction(PyTreeNode):
    """Surface interaction — analogue of ``RTInteraction``
    (``kernel_data.h:162-200``): position, geometric + shading frames, uv and
    its screen-space derivatives for texture LOD."""

    p: jax.Array  # (N, 3) world hit point
    ng: jax.Array  # (N, 3) geometric normal
    ns: jax.Array  # (N, 3) shading normal (normal-mapped)
    dpdu: jax.Array  # (N, 3) shading tangent
    dpdv: jax.Array  # (N, 3) shading bitangent
    uv: jax.Array  # (N, 2) texture coords
    wo: jax.Array  # (N, 3) outgoing (towards previous vertex), unit
    duvdx: jax.Array  # (N, 2) uv footprint (texture LOD); zeros if no differentials
    duvdy: jax.Array  # (N, 2)
    material: jax.Array  # (N,) int32 material id
    light: jax.Array  # (N,) int32 area-light id (-1 if not emissive)
    valid: jax.Array  # (N,) bool


class Throughput(PyTreeNode):
    """Per-path wavefront state carried across bounces — analogue of
    ``RTThroughput`` (``kernel_data.h:154-160``)."""

    beta: jax.Array  # (N, 3) path throughput
    radiance: jax.Array  # (N, 3) accumulated radiance
    specular_bounce: jax.Array  # (N,) bool — last bounce was specular
    active: jax.Array  # (N,) bool — path still alive

    @classmethod
    def fresh(cls, n: int):
        return cls(
            beta=jnp.ones((n, 3), jnp.float32),
            radiance=jnp.zeros((n, 3), jnp.float32),
            specular_bounce=jnp.zeros((n,), bool),
            active=jnp.ones((n,), bool),
        )
