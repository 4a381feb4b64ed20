"""Brute-force O(N·T) ray-triangle intersector.

This is the conformance *oracle*: the reference validates every acceleration
structure against a brute-force all-triangles intersector
(``third_party/RadeonRays/UnitTest/utils.cpp:11-37``); we keep the same role
for it — the BVH paths must match it bit-for-bit on hit ids — and it doubles
as the intersector of choice for tiny scenes (Cornell: 36 tris) where it is a
perfectly dense, branch-free workload.

Triangles are processed in static chunks inside a ``lax.fori_loop`` to bound
live memory at (N_rays × CHUNK); each chunk is a dense broadcasted
Möller-Trumbore test with a running min-reduction — fully regular compute that
XLA fuses with no gathers beyond the chunk fetch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Hit, Rays
from ..scene.scene import Geometry

F32_MAX = jnp.finfo(jnp.float32).max
_CHUNK = 256


def _gather_chunk(geom: Geometry, start: jax.Array, chunk: int):
    idx = start + jnp.arange(chunk)
    tri = jnp.take(geom.indices, idx, axis=0, mode="clip")  # (C, 3)
    valid = jnp.take(geom.face_valid, idx, axis=0, mode="fill", fill_value=False)
    p0 = jnp.take(geom.positions, tri[:, 0], axis=0, mode="clip")  # (C, 3)
    p1 = jnp.take(geom.positions, tri[:, 1], axis=0, mode="clip")
    p2 = jnp.take(geom.positions, tri[:, 2], axis=0, mode="clip")
    return p0, p1, p2, valid, idx


def moller_trumbore(o, d, p0, p1, p2, eps: float = 1e-9):
    """Batched Möller-Trumbore: o,d (..., 3) vs p0/p1/p2 (..., 3).

    Returns (t, u, v, hit_mask). Same test the reference's traversal kernels
    use per BVH leaf (``kernels/CL/intersect_bvh2_skiplinks.cl``), formulated
    branch-free.
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def intersect_brute(geom: Geometry, rays: Rays, chunk: int = _CHUNK) -> Hit:
    """Closest-hit query — analogue of ``IntersectionApi::QueryIntersection``
    (``radeon_rays.h:267``) against every triangle."""
    n = rays.n
    num_faces = geom.num_faces
    num_chunks = -(-num_faces // chunk)

    o = rays.o[:, None, :]  # (N, 1, 3)
    d = rays.d[:, None, :]

    def body(i, carry):
        best_t, best_prim, best_u, best_v = carry
        p0, p1, p2, cvalid, idx = _gather_chunk(geom, i * chunk, chunk)
        t, u, v, hit = moller_trumbore(o, d, p0[None], p1[None], p2[None])  # (N, C)
        hit = hit & cvalid[None, :]
        hit = hit & (t > rays.tmin[:, None]) & (t < rays.tmax[:, None])
        hit = hit & (t < best_t[:, None])
        t_masked = jnp.where(hit, t, F32_MAX)
        j = jnp.argmin(t_masked, axis=-1)  # (N,)
        row = jnp.arange(n)
        t_new = t_masked[row, j]
        any_hit = t_new < best_t
        best_prim = jnp.where(any_hit, idx[j].astype(jnp.int32), best_prim)
        best_u = jnp.where(any_hit, u[row, j], best_u)
        best_v = jnp.where(any_hit, v[row, j], best_v)
        best_t = jnp.where(any_hit, t_new, best_t)
        return best_t, best_prim, best_u, best_v

    init = (
        jnp.full((n,), F32_MAX, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    best_t, best_prim, best_u, best_v = jax.lax.fori_loop(0, num_chunks, body, init)
    valid = (best_prim >= 0) & rays.active
    shape = jnp.where(
        valid, jnp.take(geom.face_shape, jnp.maximum(best_prim, 0), axis=0, mode="clip"), -1
    )
    return Hit(
        t=jnp.where(valid, best_t, F32_MAX),
        prim=jnp.where(valid, best_prim, -1),
        shape=shape.astype(jnp.int32),
        u=best_u,
        v=best_v,
        valid=valid,
    )


def occluded_brute(geom: Geometry, rays: Rays, chunk: int = _CHUNK) -> jax.Array:
    """Any-hit query — analogue of ``QueryOcclusion`` (``radeon_rays.h:270``).
    Returns (N,) bool, True where the segment [tmin, tmax] is blocked."""
    num_faces = geom.num_faces
    num_chunks = -(-num_faces // chunk)
    o = rays.o[:, None, :]
    d = rays.d[:, None, :]

    def body(i, blocked):
        p0, p1, p2, cvalid, _ = _gather_chunk(geom, i * chunk, chunk)
        t, _, _, hit = moller_trumbore(o, d, p0[None], p1[None], p2[None])
        hit = hit & cvalid[None, :]
        hit = hit & (t > rays.tmin[:, None]) & (t < rays.tmax[:, None])
        return blocked | jnp.any(hit, axis=-1)

    blocked = jax.lax.fori_loop(0, num_chunks, body, jnp.zeros((rays.n,), bool))
    return blocked & rays.active
