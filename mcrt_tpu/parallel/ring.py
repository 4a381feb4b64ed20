"""Sharded-scene intersection with ray ring exchange.

New capability (SURVEY §2e "scene/BVH sharding — the model axis"): the
reference holds the whole scene in one device's memory (its GUI merely
*reports* allocation totals, ``PathTracingGUI.cpp:110-114``); at
San-Miguel scale one device's memory may not.  Here the per-face tables (the
memory-dominant triangle/BVH data) are partitioned into one shard per
device on the ``rays`` mesh axis, and **rays travel to the data**: each
ring step intersects the resident ray block against the local shard, then
rotates the (rays + running-best-hit) state to the next device with
``jax.lax.ppermute``.  After ``n_shards`` steps every ray has
visited every shard and is back home carrying the global closest hit —
the renderer's ring-attention analogue (blockwise KV rotation with a
running reduction).

Vertex attribute arrays (positions/normals/uvs) stay replicated for
shading — the same split the reference's device scene makes between the
intersection-owned geometry inside Radeon Rays and the shading attribute
buffers bound to the shade kernels (``RTScene.cpp:178-197``).

Pure GSPMD-compatible: the ring function is a ``shard_map`` region, so it
composes with the (spp, rays) sharded renderer in one jitted program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field
from jax.sharding import Mesh, PartitionSpec as P

from ..core.types import Hit, Rays
from ..scene.scene import Geometry
from .mesh import RAYS_AXIS

F32_MAX = float(jnp.finfo(jnp.float32).max)


def shard_faces(geom: Geometry, n_shards: int,
                return_face_map: bool = False):
    """Partition per-face tables into `n_shards` equal blocks (Morton order
    over centroids so shards are spatially compact, like the blocked accel's
    block decomposition), padded to a common size; vertex arrays replicated.

    Returns a Geometry whose face tables have leading dim (n_shards * Fpad)
    — shard i owns rows [i*Fpad, (i+1)*Fpad).  ``face_valid`` is False on
    padding.  Prim ids returned by the ring intersector index these stacked
    tables directly, so downstream interaction code works unchanged.

    ``return_face_map`` additionally returns the (F_old,) old->new face
    index map so face-indexed side tables (mesh-light ``tri_index``,
    ``Lights``) can be remapped to the sharded order.
    """
    idx = np.asarray(geom.indices)
    valid = np.asarray(geom.face_valid)
    pos = np.asarray(geom.positions)
    real = np.nonzero(valid)[0]
    tri = idx[real]
    cent = (pos[tri[:, 0]] + pos[tri[:, 1]] + pos[tri[:, 2]]) / 3.0
    lo = cent.min(0)
    span = np.maximum(cent.max(0) - lo, 1e-12)
    c01 = (cent - lo) / span
    # Morton order (reuses the accel build's key)
    from ..accel.pallas_blocked import _morton_u32

    order = real[np.argsort(_morton_u32(c01), kind="stable")]

    n = len(order)
    fpad = -(-n // n_shards)
    fpad = max(1, fpad)
    total = n_shards * fpad
    sel = np.full((total,), 0, np.int64)
    ok = np.zeros((total,), bool)
    sel[:n] = order
    ok[:n] = True
    # NOTE: contiguous fill: shard i gets Morton range [i*fpad, (i+1)*fpad)
    from ..scene.scene import FA_LIGHT, FA_MAT

    new_indices = idx[sel]
    new_shape = np.asarray(geom.face_shape)[sel]
    # face_attrs rows follow the face reorder; padding rows get id -1
    new_attrs = np.asarray(geom.face_attrs)[sel]
    new_attrs[~ok, FA_MAT] = -1.0
    new_attrs[~ok, FA_LIGHT] = -1.0
    out = geom.replace(
        indices=jnp.asarray(new_indices),
        face_shape=jnp.asarray(np.where(ok, new_shape, -1).astype(np.int32)),
        face_valid=jnp.asarray(ok),
        face_attrs=jnp.asarray(new_attrs),
    )
    if not return_face_map:
        return out
    face_map = np.full((idx.shape[0],), -1, np.int64)
    face_map[sel[:n]] = np.arange(n)
    return out, face_map


class ShardedBlockedAccel(PyTreeNode):
    """Per-shard blocked accels stacked on a leading shard axis (sharded
    ``P(rays)`` so each device holds exactly its own shard's tables) — the
    role of the per-GPU BVH the reference can never split
    (``intersector_skip_links.cpp:133-268`` uploads ONE node buffer)."""

    tri: jax.Array  # (nd, 16, NTmax)
    aabb: jax.Array  # (nd, NBmax, 8)
    slot_prim: jax.Array  # (nd, NTmax)
    bounds: jax.Array  # (2, 3) GLOBAL scene bounds (replicated sort key)
    num_blocks: int = field(pytree_node=False)


def _build_shard_accels(geom: Geometry, n_shards: int, fpad: int,
                        cfg=None) -> ShardedBlockedAccel:
    """Host build: one blocked accel per contiguous face shard, padded to
    common shapes.  Padding blocks carry NaN AABBs (never visited) and
    padding slots carry degenerate triangles + prim id -1."""
    from ..accel.pallas_blocked import BLOCK, build_blocked

    accels = []
    for s in range(n_shards):
        sl = slice(s * fpad, (s + 1) * fpad)
        sub = geom.replace(
            indices=geom.indices[sl],
            face_shape=geom.face_shape[sl],
            face_valid=geom.face_valid[sl],
            face_attrs=geom.face_attrs[sl],
        )
        if bool(np.asarray(sub.face_valid).any()):
            accels.append(build_blocked(sub, cfg))
        else:
            accels.append(None)

    nt = max((a.tri.shape[1] for a in accels if a is not None),
             default=BLOCK)
    nb = max((a.aabb.shape[0] for a in accels if a is not None),
             default=128)
    tris = np.zeros((n_shards, 16, nt), np.float32)
    aabbs = np.full((n_shards, nb, 8), np.nan, np.float32)
    slots = np.full((n_shards, nt), -1, np.int32)
    lo = np.full((3,), np.inf, np.float32)
    hi = np.full((3,), -np.inf, np.float32)
    for s, a in enumerate(accels):
        if a is None:
            continue
        tris[s, :, : a.tri.shape[1]] = np.asarray(a.tri)
        aabbs[s, : a.aabb.shape[0]] = np.asarray(a.aabb)
        slots[s, : a.slot_prim.shape[0]] = np.asarray(a.slot_prim)
        b = np.asarray(a.bounds)
        lo = np.minimum(lo, b[0])
        hi = np.maximum(hi, b[1])
    return ShardedBlockedAccel(
        tri=jnp.asarray(tris),
        aabb=jnp.asarray(aabbs),
        slot_prim=jnp.asarray(slots),
        bounds=jnp.asarray(np.stack([lo, hi])),
        num_blocks=nt // BLOCK,
    )


def _merge_best(h: Hit, best: Hit, base_prim) -> Hit:
    better = h.valid & (h.t < best.t)
    return Hit(
        t=jnp.where(better, h.t, best.t),
        prim=jnp.where(better, h.prim + base_prim, best.prim),
        shape=jnp.where(better, h.shape, best.shape),
        u=jnp.where(better, h.u, best.u),
        v=jnp.where(better, h.v, best.v),
        valid=best.valid | better,
    )


def make_ring_intersector(mesh: Mesh, n_shards: int, fpad: int,
                          accel: "ShardedBlockedAccel | None" = None):
    """Build (intersect, occluded) closures running the ray ring over the
    ``rays`` mesh axis.  `fpad` is the per-shard face count (static).

    With ``accel``, each ring step runs the production Pallas blocked
    kernel over the local shard (never O(N) — the round-1..2 brute-force
    placeholder is kept only as the ``accel=None`` fallback/oracle).  Rays
    are coherence-sorted ONCE before entering the ring (the sort key uses
    global scene bounds, so it is shard-invariant and travels with the
    block)."""
    axis = RAYS_AXIS

    def _local_geom(indices, face_shape, face_valid, face_attrs, positions,
                    normals, uvs):
        return Geometry(
            positions=positions, normals=normals, uvs=uvs,
            indices=indices, face_shape=face_shape, face_valid=face_valid,
            face_attrs=face_attrs,
        )

    def _geom_specs():
        return (P(axis, None), P(axis), P(axis), P(axis, None),
                P(), P(), P())

    def _geom_args(geom):
        return (geom.indices, geom.face_shape, geom.face_valid,
                geom.face_attrs, geom.positions, geom.normals, geom.uvs)

    def _local_accel(tri, aabb, slot_prim):
        from ..accel.pallas_blocked import BlockedAccel

        return BlockedAccel(
            tri=tri[0], aabb=aabb[0], slot_prim=slot_prim[0],
            bounds=accel.bounds, num_blocks=accel.num_blocks,
        )

    _ray_spec = jax.tree.map(
        lambda _: P(axis), Rays(o=0, d=0, tmin=0, tmax=0, active=0)
    )

    def ring_intersect(geom: Geometry, rays: Rays) -> Hit:
        def spmd(*args) -> Hit:
            if accel is not None:
                tri, aabb, slot_prim = args[:3]
                geo_args, rays_local = args[3:-1], args[-1]
                local_accel = _local_accel(tri, aabb, slot_prim)
            else:
                geo_args, rays_local = args[:-1], args[-1]
                local_accel = None
            local_geom = _local_geom(*geo_args)
            me = jax.lax.axis_index(axis)
            nd = jax.lax.axis_size(axis)
            n = rays_local.o.shape[0]

            if accel is not None:
                from ..accel.pallas_blocked import (
                    _coherence_order, intersect_blocked,
                )

                order = _coherence_order(rays_local, accel.bounds)
                rays_s = jax.tree.map(
                    lambda a: jnp.take(a, order, axis=0), rays_local
                )
            else:
                order = None
                rays_s = rays_local

            best0 = Hit(
                t=jnp.full((n,), F32_MAX),
                prim=jnp.full((n,), -1, jnp.int32),
                shape=jnp.full((n,), -1, jnp.int32),
                u=jnp.zeros((n,)),
                v=jnp.zeros((n,)),
                valid=jnp.zeros((n,), bool),
            )
            perm = [(i, (i + 1) % nd) for i in range(nd)]

            def step(k, carry):
                rays_c, best = carry
                # the resident ray block's prim ids must index THIS
                # device's shard rows in the stacked face tables
                base = me * fpad
                if accel is not None:
                    h = intersect_blocked(local_geom, local_accel, rays_c,
                                          sort=False)
                else:
                    from ..accel.brute import intersect_brute

                    h = intersect_brute(local_geom, rays_c)
                best = _merge_best(h, best, base)
                return jax.lax.ppermute((rays_c, best), axis, perm)

            _, best_f = jax.lax.fori_loop(0, nd, step, (rays_s, best0))
            # nd permutes = full cycle: every block is home again
            if order is not None:
                inv = jnp.zeros((n,), jnp.int32).at[order].set(
                    jnp.arange(n, dtype=jnp.int32)
                )
                best_f = jax.tree.map(
                    lambda a: jnp.take(a, inv, axis=0), best_f
                )
            return best_f

        out_spec = jax.tree.map(
            lambda _: P(axis), Hit(t=0, prim=0, shape=0, u=0, v=0, valid=0)
        )
        if accel is not None:
            fn = jax.shard_map(
                spmd, mesh=mesh,
                in_specs=(P(axis, None, None), P(axis, None, None),
                          P(axis, None), *_geom_specs(), _ray_spec),
                out_specs=out_spec, check_vma=False,
            )
            return fn(accel.tri, accel.aabb, accel.slot_prim,
                      *_geom_args(geom), rays)
        fn = jax.shard_map(
            spmd, mesh=mesh,
            in_specs=(*_geom_specs(), _ray_spec),
            out_specs=out_spec, check_vma=False,
        )
        return fn(*_geom_args(geom), rays)

    def ring_occluded(geom: Geometry, rays: Rays) -> jax.Array:
        def spmd(*args) -> jax.Array:
            if accel is not None:
                tri, aabb, slot_prim = args[:3]
                geo_args, rays_local = args[3:-1], args[-1]
                local_accel = _local_accel(tri, aabb, slot_prim)
            else:
                geo_args, rays_local = args[:-1], args[-1]
                local_accel = None
            local_geom = _local_geom(*geo_args)
            nd = jax.lax.axis_size(axis)
            n = rays_local.o.shape[0]
            perm = [(i, (i + 1) % nd) for i in range(nd)]

            if accel is not None:
                from ..accel.pallas_blocked import (
                    _coherence_order, occluded_blocked,
                )

                order = _coherence_order(rays_local, accel.bounds)
                rays_s = jax.tree.map(
                    lambda a: jnp.take(a, order, axis=0), rays_local
                )
            else:
                order = None
                rays_s = rays_local

            def step(k, carry):
                rays_c, blocked = carry
                if accel is not None:
                    b = occluded_blocked(local_geom, local_accel, rays_c,
                                         sort=False)
                else:
                    from ..accel.brute import occluded_brute

                    b = occluded_brute(local_geom, rays_c)
                # stop testing already-blocked lanes on later shards
                rays_c = rays_c.replace(active=rays_c.active & ~b)
                return jax.lax.ppermute((rays_c, blocked | b), axis, perm)

            _, blocked = jax.lax.fori_loop(
                0, nd, step, (rays_s, jnp.zeros((n,), bool))
            )
            if order is not None:
                inv = jnp.zeros((n,), jnp.int32).at[order].set(
                    jnp.arange(n, dtype=jnp.int32)
                )
                blocked = jnp.take(blocked, inv, axis=0)
            return blocked

        if accel is not None:
            fn = jax.shard_map(
                spmd, mesh=mesh,
                in_specs=(P(axis, None, None), P(axis, None, None),
                          P(axis, None), *_geom_specs(), _ray_spec),
                out_specs=P(axis), check_vma=False,
            )
            return fn(accel.tri, accel.aabb, accel.slot_prim,
                      *_geom_args(geom), rays)
        fn = jax.shard_map(
            spmd, mesh=mesh,
            in_specs=(*_geom_specs(), _ray_spec),
            out_specs=P(axis), check_vma=False,
        )
        return fn(*_geom_args(geom), rays)

    return ring_intersect, ring_occluded


def build_sharded_scene(scene, mesh: Mesh, use_blocked: bool = True):
    """Shard a scene's face tables over the mesh's rays axis and return
    (sharded_scene, ring_intersector) — the San-Miguel-scale path
    (BASELINE config 4).  ``use_blocked`` selects the production Pallas
    accel per shard; ``False`` keeps the O(N) brute oracle (tests)."""
    if scene.instances is not None:
        raise ValueError(
            "scene sharding does not support instanced scenes yet: shard "
            "faces reference world-space geometry; bake instances "
            "(SceneBuffers.add_instance) before sharding")
    n_shards = mesh.shape[RAYS_AXIS]
    geom, face_map = shard_faces(scene.geometry, n_shards,
                                 return_face_map=True)
    fpad = geom.indices.shape[0] // n_shards
    # remap face-indexed side tables to the sharded face order: mesh-light
    # triangle CDFs reference prim ids (lights.tri_index -> face_vertices),
    # which would otherwise read the WRONG triangles after the reorder
    lights = scene.lights
    if lights.tri_index.shape[0] > 0:
        old = np.asarray(lights.tri_index)
        lights = lights.replace(
            tri_index=jnp.asarray(
                np.where(old >= 0, face_map[np.maximum(old, 0)], -1)
                .astype(np.int32)))
    scene = scene.replace(geometry=geom, lights=lights)
    accel = (_build_shard_accels(geom, n_shards, fpad)
             if use_blocked else None)
    intersect, occluded = make_ring_intersector(mesh, n_shards, fpad, accel)

    from ..accel import Intersector

    return scene, Intersector(
        intersect=lambda s, r: intersect(s.geometry, r),
        occluded=lambda s, r: occluded(s.geometry, r),
        accel=accel,
    )
