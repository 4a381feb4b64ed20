"""Two-level (instanced) intersection: shared object-space BLAS + per-
instance transforms, traversed by ONE list-driven Pallas kernel.

Role of the reference's two-level intersector
(``src/intersector/intersector_2level.cpp``; instances created via
``IntersectionApi::CreateInstance``, ``radeon_rays.h:214-227``): N instances
of a mesh share ONE geometry/BVH allocation; traversal transforms each ray
into instance object space and intersects the shared structure, returning
(shape id, prim id) like the flat path.  This is the memory-scalable
alternative to ``SceneBuffers.add_instance``'s world-space bake-out, which
costs a full vertex+face copy per instance.

Shape: the TLAS×BLAS product is flattened into a table of **(instance,
block) pairs**, each carrying the world-space AABB of that instance's
transformed block.  The flat engine's cull → sort machinery runs
unchanged over pair AABBs (pairs are just boxes), producing per-tile
front-to-back pair visit lists — so cull cost and traversal cost scale
with pairs *entered*, not instances *existing*.  The traversal kernel is
the flat one (``pallas_blocked.traverse``) with one step more per visit:
it decodes (block, instance) from the visit's pair code and transforms the
block's p0/e1/e2 triangle rows to world space by the instance's to_world
(affine and linear in the stored rows) before the Möller-Trumbore test
against the untransformed world rays.  Everything stays in world space, so
entry distances, early exit, and the returned t are exact
(``intersector_2level.cpp`` instead relies on the affine-t invariant of
unnormalized object-space rays).

Integration contract (mirrors the reference): the query returns the
instance's SHAPE id; shading resolves per-shape transforms/materials from
the shape table (``RTShape`` carries the world transform,
``kernel_data.h:36-52``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

from ..core.types import Hit, Rays
from ..scene.scene import Geometry
from .pallas_blocked import (
    BIG, INST_BITS, MAX_INSTANCES, BlockedAccel, _coherence_order,
    _pack_table, _ray_table, build_blocked, intersect_blocked,
    occluded_blocked, traverse,
)

F32_MAX = float(jnp.finfo(jnp.float32).max)


class TwoLevelAccel(PyTreeNode):
    """Shared BLAS + instance table + flattened (instance, block) pairs."""

    blas: BlockedAccel  # object-space blocked accel of the shared mesh
    world_to_object: jax.Array  # (I, 4, 4)
    tw_rows: jax.Array  # (I*12,) to_world row-major 3x4 (the kernels
    #   transform visited triangle blocks into world space)
    shape_id: jax.Array  # (I,) i32 shape id reported for hits
    pair_aabb: jax.Array  # (Ppad, 8) world AABB per (instance, block) pair
    pair_code: jax.Array  # (Ppad,) i32 (block << INST_BITS) | instance
    bounds: jax.Array  # (2, 3) world scene bounds (ray coherence key)
    num_instances: int = field(pytree_node=False)
    num_pairs: int = field(pytree_node=False)


def build_two_level(source: Geometry, to_world: np.ndarray,
                    shape_ids: np.ndarray, cfg=None) -> TwoLevelAccel:
    """Build from one object-space source mesh + (I, 4, 4) instance
    transforms (``CreateInstance`` + ``Commit``)."""
    blas = build_blocked(source, cfg)
    tw = np.asarray(to_world, np.float32)
    n_inst = tw.shape[0]
    if n_inst > MAX_INSTANCES:
        raise ValueError(f"two-level supports <= {MAX_INSTANCES} instances")
    w2o = np.linalg.inv(tw).astype(np.float32)

    # world AABB per (instance, real block): transform the 8 corners of the
    # object-space block box by the instance's to_world
    aabb = np.asarray(blas.aabb)  # (NBpad, 8), NaN-poisoned empties
    nb = blas.num_blocks
    real = ~np.isnan(aabb[:nb, 0])
    rb = np.nonzero(real)[0]  # real block ids
    lo, hi = aabb[rb, 0:3], aabb[rb, 3:6]  # (B, 3)
    corners = np.stack([
        np.where(np.asarray(m)[None, :], hi, lo)
        for m in np.ndindex(2, 2, 2)
    ], axis=1)  # (B, 8, 3)
    # (I, B, 8, 3) world corners
    wc = np.einsum("iab,kcb->ikca", tw[:, :3, :3], corners) \
        + tw[:, None, None, :3, 3]
    plo = wc.min(axis=2).reshape(-1, 3)  # (I*B, 3)
    phi = wc.max(axis=2).reshape(-1, 3)
    code = ((rb[None, :].astype(np.int64) << INST_BITS)
            | np.arange(n_inst, dtype=np.int64)[:, None]).reshape(-1)

    p = plo.shape[0]
    ppad = max(128, -(-p // 128) * 128)
    pair_aabb = np.full((ppad, 8), np.nan, np.float32)
    pair_aabb[:, 6:8] = 0.0
    pair_aabb[:p, 0:3] = plo
    pair_aabb[:p, 3:6] = phi
    pair_code = np.zeros((ppad,), np.int32)
    pair_code[:p] = code.astype(np.int32)

    bounds = np.stack([plo.min(0), phi.max(0)]).astype(np.float32)
    return TwoLevelAccel(
        blas=blas,
        world_to_object=jnp.asarray(w2o),
        tw_rows=jnp.asarray(tw[:, :3, :4].reshape(-1)),
        shape_id=jnp.asarray(np.asarray(shape_ids, np.int32)),
        pair_aabb=jnp.asarray(pair_aabb),
        pair_code=jnp.asarray(pair_code),
        bounds=jnp.asarray(bounds),
        num_instances=n_inst,
        num_pairs=p,
    )


def _pair_boxes(aabb: np.ndarray, block_ids: np.ndarray,
                tw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World (lo, hi) of object-space block boxes under one transform."""
    lo, hi = aabb[block_ids, 0:3], aabb[block_ids, 3:6]
    corners = np.stack([
        np.where(np.asarray(m)[None, :], hi, lo)
        for m in np.ndindex(2, 2, 2)
    ], axis=1)  # (B, 8, 3)
    wc = np.einsum("ab,kcb->kca", tw[:3, :3], corners) + tw[:3, 3]
    return wc.min(axis=1), wc.max(axis=1)


def build_two_level_scene(geom: Geometry, shape_to_world, instances,
                          cfg=None) -> TwoLevelAccel:
    """Multi-BLAS two-level build from a production scene (VERDICT r4
    item 3) — the full ``intersector_2level.cpp`` shape: several distinct
    instanced meshes AND free (non-instanced) geometry coexist.

    Layout: one blocked BLAS per instanced SOURCE mesh (its face range of
    the global table) plus one BLAS for all free faces; the BLAS triangle
    tables are CONCATENATED into one (16, NT) table, so a pair code's block
    id implicitly identifies its BLAS — the pair-list kernels run unchanged.
    Instances: one identity instance per BLAS (free geometry renders as-is;
    each source renders at its authored pose) + one instance per
    ``add_instanced`` shape.  Identity/free instances report shape -1 and
    hits fall back to ``face_shape[prim]``; real instances report their
    shape id (``RTShape`` contract, ``kernel_data.h:36-52``)."""
    from ..scene.scene import Instances  # noqa: F401  (type reference)

    tw_all = np.asarray(shape_to_world, np.float32)  # (S, 4, 4)
    inst_shape_np = np.asarray(instances.shape, np.int32)
    ranges = list(zip(instances.face_lo, instances.face_hi))
    n_faces = int(geom.indices.shape[0])
    face_valid = np.asarray(geom.face_valid)

    # group instances by source face range
    by_src: dict[tuple[int, int], list[int]] = {}
    for k, r in enumerate(ranges):
        by_src.setdefault(r, []).append(k)

    src_mask = np.zeros((n_faces,), bool)
    for lo, hi in by_src:
        src_mask[lo:hi] = True
    free_mask = face_valid & ~src_mask

    # build each BLAS on a face_valid-masked view of the FULL geometry, so
    # slot_prim stays a global primitive id
    blas_list = []
    if free_mask.any():
        blas_list.append(("free", build_blocked(
            geom.replace(face_valid=jnp.asarray(free_mask)), cfg)))
    src_blas: dict[tuple[int, int], int] = {}
    for r in by_src:
        mask = np.zeros((n_faces,), bool)
        mask[r[0]:r[1]] = True
        mask &= face_valid
        src_blas[r] = len(blas_list)
        blas_list.append((r, build_blocked(
            geom.replace(face_valid=jnp.asarray(mask)), cfg)))

    # concatenate the BLAS tables; block offsets identify the BLAS
    tris, slots, aabbs, offsets = [], [], [], []
    off = 0
    for _, b in blas_list:
        offsets.append(off)
        tris.append(np.asarray(b.tri))
        slots.append(np.asarray(b.slot_prim))
        aabbs.append(np.asarray(b.aabb)[:b.num_blocks])
        off += b.num_blocks
    tri = np.concatenate(tris, axis=1)
    slot_prim = np.concatenate(slots)
    nb_tot = off
    nbpad = max(128, -(-nb_tot // 128) * 128)
    aabb = np.full((nbpad, 8), np.nan, np.float32)
    aabb[:, 6:8] = 0.0
    aabb[:nb_tot] = np.concatenate(aabbs, axis=0)

    # instance table: identity per BLAS (shape -1), then real instances
    ident = np.eye(4, dtype=np.float32)
    inst_tw: list[np.ndarray] = [ident] * len(blas_list)
    inst_sid: list[int] = [-1] * len(blas_list)
    inst_blas: list[int] = list(range(len(blas_list)))
    for k, r in enumerate(ranges):
        inst_tw.append(tw_all[int(inst_shape_np[k])])
        inst_sid.append(int(inst_shape_np[k]))
        inst_blas.append(src_blas[r])
    n_inst = len(inst_tw)
    if n_inst > MAX_INSTANCES:
        raise ValueError(f"two-level supports <= {MAX_INSTANCES} instances")
    tw_inst = np.stack(inst_tw)
    w2o = np.linalg.inv(tw_inst).astype(np.float32)

    # pairs: every instance x the REAL blocks of its BLAS
    plos, phis, codes = [], [], []
    for i in range(n_inst):
        b = blas_list[inst_blas[i]][1]
        ba = np.asarray(b.aabb)[:b.num_blocks]
        real = np.nonzero(~np.isnan(ba[:, 0]))[0]
        gids = real + offsets[inst_blas[i]]
        lo, hi = _pair_boxes(aabb, gids, tw_inst[i])
        plos.append(lo)
        phis.append(hi)
        codes.append((gids.astype(np.int64) << INST_BITS) | i)
    plo = np.concatenate(plos)
    phi = np.concatenate(phis)
    code = np.concatenate(codes)

    p = plo.shape[0]
    ppad = max(128, -(-p // 128) * 128)
    pair_aabb = np.full((ppad, 8), np.nan, np.float32)
    pair_aabb[:, 6:8] = 0.0
    pair_aabb[:p, 0:3] = plo
    pair_aabb[:p, 3:6] = phi
    pair_code = np.zeros((ppad,), np.int32)
    pair_code[:p] = code.astype(np.int32)

    merged = BlockedAccel(
        tri=jnp.asarray(tri),
        aabb=jnp.asarray(aabb),
        slot_prim=jnp.asarray(slot_prim),
        bounds=jnp.asarray(np.stack([plo.min(0), phi.max(0)])),
        num_blocks=nb_tot,
    )
    return TwoLevelAccel(
        blas=merged,
        world_to_object=jnp.asarray(w2o),
        tw_rows=jnp.asarray(tw_inst[:, :3, :4].reshape(-1)),
        shape_id=jnp.asarray(np.asarray(inst_sid, np.int32)),
        pair_aabb=jnp.asarray(pair_aabb),
        pair_code=jnp.asarray(pair_code),
        bounds=jnp.asarray(np.stack([plo.min(0), phi.max(0)]).astype(np.float32)),
        num_instances=n_inst,
        num_pairs=p,
    )


def refit_two_level_scene(accel: TwoLevelAccel, scene) -> TwoLevelAccel:
    """In-jit refit for instance-transform edits on a production scene:
    gathers each instance's live transform from ``scene.shapes.to_world``
    (identity instances stay fixed) and recomputes the pair boxes."""
    ident = jnp.eye(4, dtype=jnp.float32)
    sid = accel.shape_id  # (I,)
    tw = jnp.where(
        (sid >= 0)[:, None, None],
        jnp.take(scene.shapes.to_world, jnp.maximum(sid, 0), axis=0,
                 mode="clip"),
        ident[None],
    )
    return refit_two_level(accel, tw)


def refit_two_level(accel: TwoLevelAccel,
                    to_world: jax.Array) -> TwoLevelAccel:
    """In-jit instance-transform refit: recompute world→object matrices and
    pair AABBs from new (I, 4, 4) transforms while keeping the BLAS and the
    pair decomposition — the ``Shape::SetTransform`` + ``Commit`` path for
    instanced dynamic scenes (``RTScene.cpp:327-359``).  Fully jittable, so
    an animation step fuses transform + refit + render."""
    tw = jnp.asarray(to_world, jnp.float32)
    w2o = jnp.linalg.inv(tw)
    # object-space block corners are static; re-transform per instance
    code = accel.pair_code
    ppad = code.shape[0]
    valid = jnp.arange(ppad) < accel.num_pairs
    b = code >> INST_BITS
    inst = code & (MAX_INSTANCES - 1)
    ob = jnp.take(accel.blas.aabb, b, axis=0)  # (P, 8) object boxes
    lo, hi = ob[:, 0:3], ob[:, 3:6]
    m = jnp.take(tw, inst, axis=0)  # (P, 4, 4)
    corners = jnp.stack([
        jnp.where(jnp.asarray(msk, bool)[None, :], hi, lo)
        for msk in np.ndindex(2, 2, 2)
    ], axis=1)  # (P, 8, 3)
    wc = jnp.einsum("pab,pcb->pca", m[:, :3, :3], corners) \
        + m[:, None, :3, 3]
    plo = wc.min(axis=1)
    phi = wc.max(axis=1)
    nan = jnp.float32(jnp.nan)
    pair_aabb = jnp.concatenate([
        jnp.where(valid[:, None], plo, nan),
        jnp.where(valid[:, None], phi, nan),
        jnp.zeros((ppad, 2), jnp.float32),
    ], axis=1)
    vlo = jnp.min(jnp.where(valid[:, None], plo, BIG), axis=0)
    vhi = jnp.max(jnp.where(valid[:, None], phi, -BIG), axis=0)
    return accel.replace(
        world_to_object=w2o,
        tw_rows=tw[:, :3, :4].reshape(-1),
        pair_aabb=pair_aabb,
        bounds=jnp.stack([vlo, vhi]),
    )


def _transform_rays(rays: Rays, m: jax.Array) -> Rays:
    """Affine ray transform into object space.  Directions are NOT
    normalized, so the object-space t equals the world-space t."""
    o = rays.o @ m[:3, :3].T + m[:3, 3]
    d = rays.d @ m[:3, :3].T
    return rays.replace(o=o, d=d)


def _resolve_uv2(accel: TwoLevelAccel, slot, inst, rays: Rays):
    """Recompute barycentrics for each ray's winning (slot, instance) with
    object-space rays — ordinary XLA gathers."""
    m = jnp.take(accel.world_to_object, jnp.maximum(inst, 0), axis=0,
                 mode="clip")  # (N, 4, 4)
    o = jnp.einsum("nij,nj->ni", m[:, :3, :3], rays.o) + m[:, :3, 3]
    d = jnp.einsum("nij,nj->ni", m[:, :3, :3], rays.d)
    s = jnp.maximum(slot, 0)
    cols = jnp.take(accel.blas.tri, s, axis=1)  # (16, N)
    p0 = cols[0:3].T
    e1 = cols[3:6].T
    e2 = cols[6:9].T
    pv = jnp.cross(d, e2)
    det = jnp.sum(e1 * pv, axis=1)
    inv = jnp.where(jnp.abs(det) > 1e-12,
                    1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    u = jnp.sum(tv * pv, axis=1) * inv
    qv = jnp.cross(tv, e1)
    v = jnp.sum(d * qv, axis=1) * inv
    return jnp.clip(u, 0.0, 1.0), jnp.clip(v, 0.0, 1.0)


def intersect_two_level(source: Geometry, accel: TwoLevelAccel,
                        rays: Rays, sort: bool = True) -> Hit:
    """Closest hit over all instances; ``shape`` is the instance's shape id,
    ``prim`` indexes the SHARED source mesh faces."""
    n = rays.n
    table = _ray_table(rays)
    if sort:
        order = _coherence_order(rays, accel.bounds)
        table = jnp.take(table, order, axis=0)
    packed = _pack_table(table)
    t, slot, inst = traverse(
        packed, accel.blas.tri, accel.pair_aabb, closest=True,
        code=accel.pair_code, tw=accel.tw_rows)
    if sort:
        inv = jnp.zeros((n,), jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32))
        flat = lambda a: jnp.take(a.reshape(-1)[:n], inv, axis=0)
    else:
        flat = lambda a: a.reshape(-1)[:n]
    t, slot, inst = flat(t), flat(slot), flat(inst)
    found = slot >= 0
    u, v = _resolve_uv2(accel, slot, inst, rays)
    u = jnp.where(found, u, 0.0)
    v = jnp.where(found, v, 0.0)
    prim = jnp.where(
        found,
        jnp.take(accel.blas.slot_prim, jnp.maximum(slot, 0), axis=0), -1)
    valid = found & rays.active
    inst_shape = jnp.take(accel.shape_id, jnp.maximum(inst, 0), axis=0,
                          mode="clip")
    # identity/free instances report -1: resolve through the face table
    # like the flat path (multi-BLAS scenes mix both)
    face_sh = jnp.take(source.face_shape, jnp.maximum(prim, 0), axis=0,
                       mode="clip")
    shape = jnp.where(valid, jnp.where(inst_shape >= 0, inst_shape, face_sh),
                      -1)
    return Hit(
        t=jnp.where(valid, t, F32_MAX),
        prim=prim.astype(jnp.int32),
        shape=shape.astype(jnp.int32),
        u=u,
        v=v,
        valid=valid,
    )


def occluded_two_level(source: Geometry, accel: TwoLevelAccel,
                       rays: Rays, sort: bool = True) -> jax.Array:
    n = rays.n
    table = _ray_table(rays)
    if sort:
        order = _coherence_order(rays, accel.bounds)
        table = jnp.take(table, order, axis=0)
    packed = _pack_table(table)
    out = traverse(
        packed, accel.blas.tri, accel.pair_aabb, closest=False,
        code=accel.pair_code, tw=accel.tw_rows)
    blocked = out.reshape(-1)[:n] > 0.0
    if sort:
        inv = jnp.zeros((n,), jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32))
        blocked = jnp.take(blocked, inv, axis=0)
    return blocked & rays.active


# --------------------------------------------------------------------------
# Reference implementation: sequential per-instance loop over the flat
# blocked query (round-3 design).  Kept as the conformance oracle for the
# pair-list kernels and as a fallback for > MAX_INSTANCES scenes.
# --------------------------------------------------------------------------


def intersect_two_level_loop(source: Geometry, accel: TwoLevelAccel,
                             rays: Rays) -> Hit:
    n = rays.n
    best = Hit(
        t=jnp.full((n,), F32_MAX),
        prim=jnp.full((n,), -1, jnp.int32),
        shape=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
        valid=jnp.zeros((n,), bool),
    )

    def body(i, best):
        m = accel.world_to_object[i]
        r_obj = _transform_rays(rays, m)
        # clip tmax to the current best so already-beaten instances
        # terminate their traversal early
        r_obj = r_obj.replace(tmax=jnp.minimum(r_obj.tmax, best.t))
        h = intersect_blocked(source, accel.blas, r_obj)
        better = h.valid & (h.t < best.t)
        sid = jnp.where(accel.shape_id[i] >= 0, accel.shape_id[i], h.shape)
        return Hit(
            t=jnp.where(better, h.t, best.t),
            prim=jnp.where(better, h.prim, best.prim),
            shape=jnp.where(better, sid, best.shape),
            u=jnp.where(better, h.u, best.u),
            v=jnp.where(better, h.v, best.v),
            valid=best.valid | better,
        )

    return jax.lax.fori_loop(0, accel.num_instances, body, best)


def occluded_two_level_loop(source: Geometry, accel: TwoLevelAccel,
                            rays: Rays) -> jax.Array:
    def body(i, carry):
        rays_c, blocked = carry
        m = accel.world_to_object[i]
        r_obj = _transform_rays(rays_c, m)
        b = occluded_blocked(source, accel.blas, r_obj)
        # deactivate blocked lanes for the remaining instances
        return rays_c.replace(active=rays_c.active & ~b), blocked | b

    n = rays.n
    _, blocked = jax.lax.fori_loop(
        0, accel.num_instances, body, (rays, jnp.zeros((n,), bool))
    )
    return blocked
