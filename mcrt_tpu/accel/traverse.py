"""BVH traversal in pure JAX (XLA-compiled), vectorized over rays.

Role of the reference's traversal drivers + kernels
(``src/intersector/intersector_skip_links.cpp`` driving
``kernels/CL/intersect_bvh2_skiplinks.cl``): closest-hit and any-hit queries
against the LBVH.  One lockstep masked ``while_loop`` over the wavefront:
each iteration, every ray processes one node — both children slab-tested
unconditionally and selected, near child continued, far child pushed onto
a transposed (S, N) stack updated with one-hot select/reduce.  Optional
coherence chunking sorts rays by a direction Morton key and traverses them
in chunks (``lax.map``), so each chunk's loop exits at its own max depth.

Must agree exactly with the brute-force oracle (reference conformance
pattern, SURVEY §4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import BVHConfig
from ..core.types import Hit, Rays
from ..scene.scene import Geometry
from .lbvh import LBVH, morton3d

F32_MAX = jnp.finfo(jnp.float32).max
DONE = jnp.int32(-1)


def _traverse(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool,
              fixed_iters: int | None = None):
    """Core lockstep loop over one (chunk of) rays.

    Returns (best_t, best_slot, best_u, best_v, blocked) where best_slot is
    an index into bvh.prim (= leaf*leaf_size + slot), -1 if miss."""
    n_rays = rays.o.shape[0]
    n_leaves = bvh.num_leaves
    internal_count = n_leaves - 1
    leaf_size = bvh.leaf_size

    ox, oy, oz = rays.o[:, 0], rays.o[:, 1], rays.o[:, 2]
    dx, dy, dz = rays.d[:, 0], rays.d[:, 1], rays.d[:, 2]
    sd = lambda c: jnp.where(jnp.abs(c) > 1e-12, c, 1e-12)
    ix, iy, iz = 1.0 / sd(dx), 1.0 / sd(dy), 1.0 / sd(dz)
    tmin = rays.tmin

    srange = jnp.arange(stack_depth, dtype=jnp.int32)[:, None]  # (S, 1)

    def slab(c0, c1, best_t):
        # c0/c1: tuples of 3 (N,) min/max components
        tnx0 = (c0[0] - ox) * ix
        tnx1 = (c1[0] - ox) * ix
        tny0 = (c0[1] - oy) * iy
        tny1 = (c1[1] - oy) * iy
        tnz0 = (c0[2] - oz) * iz
        tnz1 = (c1[2] - oz) * iz
        t_near = jnp.maximum(
            jnp.maximum(jnp.minimum(tnx0, tnx1), jnp.minimum(tny0, tny1)),
            jnp.maximum(jnp.minimum(tnz0, tnz1), tmin),
        )
        t_far = jnp.minimum(
            jnp.minimum(jnp.maximum(tnx0, tnx1), jnp.maximum(tny0, tny1)),
            jnp.minimum(jnp.maximum(tnz0, tnz1), best_t),
        )
        return t_near <= t_far, t_near

    def body(state):
        cur, stack, sp, best_t, best_slot, best_u, best_v, blocked = state
        lane_on = cur >= 0
        is_leaf = cur >= internal_count

        # ---- internal node: transposed gathers -> (12, N), (2, N)
        inode = jnp.clip(cur, 0, internal_count - 1)
        rows = jnp.take(bvh.packed_t, inode, axis=1)
        ch = jnp.take(bvh.children, inode, axis=1)
        lc, rc = ch[0], ch[1]
        hit_l, tn_l = slab((rows[0], rows[1], rows[2]),
                           (rows[3], rows[4], rows[5]), best_t)
        hit_r, tn_r = slab((rows[6], rows[7], rows[8]),
                           (rows[9], rows[10], rows[11]), best_t)

        # ---- leaf: transposed gather -> (9K, N), scalarized MT per slot
        leaf_idx = jnp.clip(cur - internal_count, 0, n_leaves - 1)
        lrow = jnp.take(bvh.leaf_t, leaf_idx, axis=1)
        leaf_on = lane_on & is_leaf
        for slot in range(leaf_size):
            b = slot * 9
            p0x, p0y, p0z = lrow[b], lrow[b + 1], lrow[b + 2]
            e1x, e1y, e1z = lrow[b + 3], lrow[b + 4], lrow[b + 5]
            e2x, e2y, e2z = lrow[b + 6], lrow[b + 7], lrow[b + 8]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            ok = jnp.abs(det) > 1e-9
            inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
            hit = (
                leaf_on & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > tmin) & (t < best_t)
            )
            best_slot = jnp.where(
                hit, leaf_idx * leaf_size + slot, best_slot
            )
            best_u = jnp.where(hit, u, best_u)
            best_v = jnp.where(hit, v, best_v)
            best_t = jnp.where(hit, t, best_t)
            if any_hit:
                blocked = blocked | hit

        # ---- next node
        proc_int = lane_on & ~is_leaf
        both = proc_int & hit_l & hit_r
        near_is_l = tn_l <= tn_r
        near = jnp.where(near_is_l, lc, rc)
        far = jnp.where(near_is_l, rc, lc)
        only_l = proc_int & hit_l & ~hit_r
        only_r = proc_int & hit_r & ~hit_l

        # transposed (S, N) stack: one-hot push
        can_push = both & (sp < stack_depth)
        stack = jnp.where(
            (srange == sp[None, :]) & can_push[None, :], far[None, :], stack
        )
        sp = jnp.where(can_push, sp + 1, sp)

        goto = jnp.where(
            both, near, jnp.where(only_l, lc, jnp.where(only_r, rc, DONE))
        )
        need_pop = lane_on & (goto == DONE)
        if any_hit:
            need_pop = need_pop | (lane_on & blocked)
        can_pop = need_pop & (sp > 0)
        sp = jnp.where(can_pop, sp - 1, sp)
        # one-hot pop (reduce over the small S axis, lanes = rays)
        popped = jnp.sum(
            jnp.where(srange == sp[None, :], stack, 0), axis=0
        )
        cur = jnp.where(
            lane_on,
            jnp.where(need_pop, jnp.where(can_pop, popped, DONE), goto),
            DONE,
        )
        if any_hit:
            cur = jnp.where(blocked, DONE, cur)
        return cur, stack, sp, best_t, best_slot, best_u, best_v, blocked

    def cond(state):
        return jnp.any(state[0] >= 0)

    state0 = (
        jnp.where(rays.active, 0, DONE),
        jnp.zeros((stack_depth, n_rays), jnp.int32),
        jnp.zeros((n_rays,), jnp.int32),
        jnp.minimum(rays.tmax, F32_MAX),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), jnp.float32),
        jnp.zeros((n_rays,), jnp.float32),
        jnp.zeros((n_rays,), bool),
    )
    if fixed_iters is not None:
        # perf instrumentation: run exactly fixed_iters body steps
        out = jax.lax.fori_loop(0, fixed_iters, lambda i, s: body(s), state0)
    else:
        out = jax.lax.while_loop(cond, body, state0)
    return out[3], out[4], out[5], out[6], out[7]


def _traverse_unified(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool):
    """Single-gather lockstep loop over the unified 24-row table
    (leaf_size == 2).  Per iteration: ONE (24, N) gather + ONE (2, N) child
    gather; internal lanes slab-test both children, leaf lanes run two
    precomputed-edge MT tests — selected by mask, no divergence."""
    n_rays = rays.o.shape[0]
    n_leaves = bvh.num_leaves
    internal_count = n_leaves - 1
    num_nodes = 2 * n_leaves - 1

    ox, oy, oz = rays.o[:, 0], rays.o[:, 1], rays.o[:, 2]
    dx, dy, dz = rays.d[:, 0], rays.d[:, 1], rays.d[:, 2]
    sd = lambda c: jnp.where(jnp.abs(c) > 1e-12, c, 1e-12)
    ix, iy, iz = 1.0 / sd(dx), 1.0 / sd(dy), 1.0 / sd(dz)
    tmin = rays.tmin
    srange = jnp.arange(stack_depth, dtype=jnp.int32)[:, None]

    def slab(c0x, c0y, c0z, c1x, c1y, c1z, best_t):
        tx0, tx1 = (c0x - ox) * ix, (c1x - ox) * ix
        ty0, ty1 = (c0y - oy) * iy, (c1y - oy) * iy
        tz0, tz1 = (c0z - oz) * iz, (c1z - oz) * iz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), tmin),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.minimum(jnp.maximum(tz0, tz1), best_t),
        )
        return tn <= tf, tn

    def mt(row, b, leaf_on, best_t):
        p0x, p0y, p0z = row[b], row[b + 1], row[b + 2]
        e1x, e1y, e1z = row[b + 3], row[b + 4], row[b + 5]
        e2x, e2y, e2z = row[b + 6], row[b + 7], row[b + 8]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok = jnp.abs(det) > 1e-9
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        hit = (
            leaf_on & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > tmin) & (t < best_t)
        )
        return t, u, v, hit

    def body(state):
        cur, stack, sp, best_t, best_slot, best_u, best_v, blocked = state
        lane_on = cur >= 0
        is_leaf = cur >= internal_count
        node = jnp.clip(cur, 0, num_nodes - 1)
        row = jnp.take(bvh.unified_t, node, axis=1)  # (24, N)
        ch = jnp.take(bvh.unified_ci, node, axis=1)  # (2, N)
        lc, rc = ch[0], ch[1]

        hit_l, tn_l = slab(row[0], row[1], row[2], row[3], row[4], row[5], best_t)
        hit_r, tn_r = slab(row[6], row[7], row[8], row[9], row[10], row[11], best_t)

        leaf_on = lane_on & is_leaf
        leaf_idx = jnp.clip(cur - internal_count, 0, n_leaves - 1)
        for slot in range(2):
            t, u, v, hit = mt(row, slot * 9, leaf_on, best_t)
            best_slot = jnp.where(hit, leaf_idx * 2 + slot, best_slot)
            best_u = jnp.where(hit, u, best_u)
            best_v = jnp.where(hit, v, best_v)
            best_t = jnp.where(hit, t, best_t)
            if any_hit:
                blocked = blocked | hit

        proc_int = lane_on & ~is_leaf
        both = proc_int & hit_l & hit_r
        near_is_l = tn_l <= tn_r
        near = jnp.where(near_is_l, lc, rc)
        far = jnp.where(near_is_l, rc, lc)
        only_l = proc_int & hit_l & ~hit_r
        only_r = proc_int & hit_r & ~hit_l

        can_push = both & (sp < stack_depth)
        stack = jnp.where(
            (srange == sp[None, :]) & can_push[None, :], far[None, :], stack
        )
        sp = jnp.where(can_push, sp + 1, sp)
        goto = jnp.where(
            both, near, jnp.where(only_l, lc, jnp.where(only_r, rc, DONE))
        )
        need_pop = lane_on & (goto == DONE)
        if any_hit:
            need_pop = need_pop | (lane_on & blocked)
        can_pop = need_pop & (sp > 0)
        sp = jnp.where(can_pop, sp - 1, sp)
        popped = jnp.sum(jnp.where(srange == sp[None, :], stack, 0), axis=0)
        cur = jnp.where(
            lane_on,
            jnp.where(need_pop, jnp.where(can_pop, popped, DONE), goto),
            DONE,
        )
        if any_hit:
            cur = jnp.where(blocked, DONE, cur)
        return cur, stack, sp, best_t, best_slot, best_u, best_v, blocked

    state0 = (
        jnp.where(rays.active, 0, DONE),
        jnp.zeros((stack_depth, n_rays), jnp.int32),
        jnp.zeros((n_rays,), jnp.int32),
        jnp.minimum(rays.tmax, F32_MAX),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), jnp.float32),
        jnp.zeros((n_rays,), jnp.float32),
        jnp.zeros((n_rays,), bool),
    )
    out = jax.lax.while_loop(lambda s: jnp.any(s[0] >= 0), body, state0)
    return out[3], out[4], out[5], out[6], out[7]


def traversal_iterations(bvh: LBVH, rays: Rays, stack_depth: int = 64):
    """Diagnostic: (lockstep iteration count, per-ray node-visit counts)."""
    n_rays = rays.o.shape[0]

    counter = [jnp.asarray(0, jnp.int32), jnp.zeros((n_rays,), jnp.int32)]

    # reuse _traverse by running it twice is wasteful; emulate by running the
    # while loop with an extended state via closure over mutable cells is not
    # traceable — so: run a lightweight copy that only tracks node pointers.
    internal_count = bvh.num_leaves - 1
    ox, oy, oz = rays.o[:, 0], rays.o[:, 1], rays.o[:, 2]
    dx, dy, dz = rays.d[:, 0], rays.d[:, 1], rays.d[:, 2]
    sd = lambda c: jnp.where(jnp.abs(c) > 1e-12, c, 1e-12)
    ix, iy, iz = 1.0 / sd(dx), 1.0 / sd(dy), 1.0 / sd(dz)
    srange = jnp.arange(stack_depth, dtype=jnp.int32)[:, None]

    def slab(lo, hi, tmax):
        tx0, tx1 = (lo[0] - ox) * ix, (hi[0] - ox) * ix
        ty0, ty1 = (lo[1] - oy) * iy, (hi[1] - oy) * iy
        tz0, tz1 = (lo[2] - oz) * iz, (hi[2] - oz) * iz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                         jnp.maximum(jnp.minimum(tz0, tz1), rays.tmin))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                         jnp.minimum(jnp.maximum(tz0, tz1), tmax))
        return tn <= tf, tn

    def body(state):
        cur, stack, sp, iters, visits = state
        lane_on = cur >= 0
        is_leaf = cur >= internal_count
        inode = jnp.clip(cur, 0, internal_count - 1)
        rows = jnp.take(bvh.packed_t, inode, axis=1)
        ch = jnp.take(bvh.children, inode, axis=1)
        lc, rc = ch[0], ch[1]
        hit_l, tn_l = slab((rows[0], rows[1], rows[2]), (rows[3], rows[4], rows[5]), rays.tmax)
        hit_r, tn_r = slab((rows[6], rows[7], rows[8]), (rows[9], rows[10], rows[11]), rays.tmax)
        proc_int = lane_on & ~is_leaf
        both = proc_int & hit_l & hit_r
        near_is_l = tn_l <= tn_r
        near = jnp.where(near_is_l, lc, rc)
        far = jnp.where(near_is_l, rc, lc)
        only_l = proc_int & hit_l & ~hit_r
        only_r = proc_int & hit_r & ~hit_l
        can_push = both & (sp < stack_depth)
        stack = jnp.where((srange == sp[None, :]) & can_push[None, :], far[None, :], stack)
        sp = jnp.where(can_push, sp + 1, sp)
        goto = jnp.where(both, near, jnp.where(only_l, lc, jnp.where(only_r, rc, DONE)))
        goto = jnp.where(is_leaf, DONE, goto)  # leaves just pop here
        need_pop = lane_on & (goto == DONE)
        can_pop = need_pop & (sp > 0)
        sp = jnp.where(can_pop, sp - 1, sp)
        popped = jnp.sum(jnp.where(srange == sp[None, :], stack, 0), axis=0)
        cur = jnp.where(lane_on, jnp.where(need_pop, jnp.where(can_pop, popped, DONE), goto), DONE)
        return cur, stack, sp, iters + 1, visits + lane_on.astype(jnp.int32)

    state0 = (
        jnp.where(rays.active, 0, DONE),
        jnp.zeros((stack_depth, n_rays), jnp.int32),
        jnp.zeros((n_rays,), jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.zeros((n_rays,), jnp.int32),
    )
    out = jax.lax.while_loop(lambda s: jnp.any(s[0] >= 0), body, state0)
    return out[3], out[4]


def _coherence_order(rays: Rays) -> jax.Array:
    """Sort key: direction Morton code — groups rays into coherent chunks so
    chunked while_loops exit early (the sorted-ray-batch mitigation from
    SURVEY §7 'hard parts')."""
    d01 = rays.d * 0.5 + 0.5
    code = morton3d(d01) >> 6  # 24 bits of direction locality
    return jnp.argsort(code).astype(jnp.int32)


def _run_chunked(bvh: LBVH, rays: Rays, stack_depth: int, any_hit: bool,
                 chunk: int):
    core = (
        _traverse_unified if bvh.unified_t is not None
        else lambda b, r, s, a: _traverse(b, r, s, a)
    )
    n = rays.n
    if chunk <= 0 or n <= chunk:
        return core(bvh, rays, stack_depth, any_hit)
    pad = (-n) % chunk
    order = _coherence_order(rays)

    def take_ray(arr):
        a = jnp.take(arr, order, axis=0)
        if pad:
            a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], 0)
        return a

    r = Rays(
        o=take_ray(rays.o), d=take_ray(rays.d), tmin=take_ray(rays.tmin),
        tmax=take_ray(rays.tmax), active=take_ray(rays.active),
    )
    num_chunks = (n + pad) // chunk
    chunked = jax.tree.map(
        lambda a: a.reshape((num_chunks, chunk) + a.shape[1:]), r
    )
    outs = jax.lax.map(
        lambda rc: core(bvh, rc, stack_depth, any_hit), chunked
    )
    flat = jax.tree.map(lambda a: a.reshape((num_chunks * chunk,) + a.shape[2:]), outs)
    # result[i] lives at sorted position pos[i]
    pos = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    return jax.tree.map(lambda a: jnp.take(a, pos, axis=0), flat)


def intersect_bvh(geom: Geometry, bvh: LBVH, rays: Rays,
                  cfg: BVHConfig | None = None, chunk: int = 0) -> Hit:
    """Closest-hit query (``QueryIntersection`` analogue)."""
    cfg = cfg or BVHConfig()
    best_t, best_slot, best_u, best_v, _ = _run_chunked(
        bvh, rays, cfg.stack_depth, any_hit=False, chunk=chunk
    )
    found = best_slot >= 0
    prim = jnp.where(found, jnp.take(bvh.prim, jnp.maximum(best_slot, 0)), -1)
    valid = found & rays.active
    shape = jnp.where(
        valid,
        jnp.take(geom.face_shape, jnp.maximum(prim, 0), axis=0, mode="clip"),
        -1,
    )
    return Hit(
        t=jnp.where(valid, best_t, F32_MAX),
        prim=prim.astype(jnp.int32),
        shape=shape.astype(jnp.int32),
        u=best_u,
        v=best_v,
        valid=valid,
    )


def occluded_bvh(geom: Geometry, bvh: LBVH, rays: Rays,
                 cfg: BVHConfig | None = None, chunk: int = 0) -> jax.Array:
    """Any-hit query (``QueryOcclusion`` analogue) with early-out per lane."""
    cfg = cfg or BVHConfig()
    _, _, _, _, blocked = _run_chunked(
        bvh, rays, cfg.stack_depth, any_hit=True, chunk=chunk
    )
    return blocked & rays.active
