"""Bidirectional path tracer (BDPT), fully fused into one XLA program.

Redesign of the reference's BDPT (``assets/kernels/BDPT.cl`` +
host driver ``RTBDPTPass.cpp``, SURVEY §3.3): the reference launches 4 kernels
per stage with host loops and splats via CAS-loop float atomics
(``BDPT.cl:654-669``); here both subpath walks, every (s,t) connection
strategy, the MIS pdf-ratio walk, and the t=1 film splats compile into a
single jitted program — splats use ``scatter-add`` (XLA segmented sum), not
atomics, per SURVEY §5.

The connection strategies are **batched over a strategy axis** (round-5
redesign): all (s,t) pairs of one family are evaluated as (S, N, ...) tensors
in ONE set of ops — the counterpart of the reference compiling TWO kernels
over *all* strategies (``PrepareConnections``/``ConnectVertices``,
``BDPT.cl:460-875``) instead of one program fragment per (s,t).  Because the
strategy table is static, endpoint data is assembled by static slices (no
dynamic gathers), and the MIS pdf-ratio walk runs as a masked fixed-trip loop
over the vertex axis shared by every strategy.  Four families:

- ``s=0`` (camera path hit a light) — no visibility ray;
- ``s=1`` (light resample / NEE inside BDPT) — one sampled light vertex per
  strategy, visibility-deferred;
- ``t=1`` (connect to camera) — film splats via scatter-add;
- ``s>=2, t>=2`` general G-term connections.

All families' shadow rays resolve through batched occlusion queries,
**chunked** to a ray budget (``MCRT_BDPT_OCC_RAYS``) so large films cannot
OOM the blocked accel's per-query tables (the reference stages all
connection rays then runs one ``QueryOcclusion``, ``RTBDPTPass.cpp:309-347``;
we keep that shape per chunk).

Structure follows the PBRT-v3 formulation the reference mirrors:

- camera subpath: ≤ maxDepth+2 vertices (``RTBDPTPass.cpp:456-457``);
- light subpath: ≤ maxDepth+1 vertices, transport-mode aware walk with the
  shading-normal correction factor (``BDPT.cl:23-36``).  Directional lights
  walk too (scene-radius disk origins), so they participate in every s
  strategy, not just s=1;
- MIS: the pdfRev/pdfFwd ratio walk with remap0 delta handling
  (``BDPT.cl:649-875``).  Where the reference temporarily *mutates* vertices
  to apply strategy-specific endpoint pdfs, this implementation computes the
  four override densities functionally and substitutes them positionally in
  the masked ratio walk — no mutation, no divergence.

Vertices are SoA arrays shaped (N, V, ...): fixed-size per-pixel vertex
storage exactly like the reference's preallocated vertex buffers; the
per-vertex BSDF parameters fetched during the walks are stored the same way
(one texture/material gather per vertex total, reused by every strategy).

Limitations: pinhole camera only (t=0 never contributes).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from ..core.pytree import PyTreeNode, field

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..bsdf.uber import UberBSDF
from ..camera.pinhole import PinholeCamera
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Interaction, Rays
from ..lights import lights as lt
from ..sampling import rng
from ..scene.interaction import compute_interaction, spawn_ray, spawn_shadow_ray
from ..scene.scene import (
    LIGHT_DIRECTIONAL,
    LIGHT_DISK,
    LIGHT_MESH,
    LIGHT_POINT,
    Scene,
)

VT_CAMERA = 0
VT_LIGHT = 1
VT_SURFACE = 2

# max rays per batched occlusion query (ADVICE r4: an uncapped all-strategy
# batch materializes multi-GB cull/visit tables in the blocked accel at
# large films); chunking keeps the deferred-visibility structure per chunk
OCC_CHUNK_RAYS = int(os.environ.get("MCRT_BDPT_OCC_RAYS", str(1 << 21)))


class Vertices(PyTreeNode):
    """SoA path-vertex storage, leading dims (N, V) — the functional
    analogue of ``RTBDPTVertex`` (``kernel_data.h:220-244``)."""

    vtype: jax.Array  # (N, V) i32
    p: jax.Array  # (N, V, 3)
    ng: jax.Array  # (N, V, 3)
    ns: jax.Array  # (N, V, 3)
    t: jax.Array  # (N, V, 3) shading tangent
    b: jax.Array  # (N, V, 3) shading bitangent
    uv: jax.Array  # (N, V, 2)
    wo: jax.Array  # (N, V, 3) toward previous vertex
    material: jax.Array  # (N, V) i32 (-1 none)
    light: jax.Array  # (N, V) i32 area light id at vertex (-1)
    light_idx: jax.Array  # (N, V) i32 light table id for VT_LIGHT vertices
    beta: jax.Array  # (N, V, 3) throughput up to (and incl. emission/We at) vertex
    pdf_fwd: jax.Array  # (N, V) area density from previous vertex
    pdf_rev: jax.Array  # (N, V) area density from next vertex
    delta: jax.Array  # (N, V) bool — vertex reached via delta sampling
    on_surface: jax.Array  # (N, V) bool — area-density conversions need cos
    valid: jax.Array  # (N, V) bool

    @classmethod
    def empty(cls, n: int, v: int):
        z3 = jnp.zeros((n, v, 3), jnp.float32)
        z = jnp.zeros((n, v), jnp.float32)
        zi = jnp.full((n, v), -1, jnp.int32)
        zb = jnp.zeros((n, v), bool)
        return cls(
            vtype=jnp.zeros((n, v), jnp.int32), p=z3, ng=z3, ns=z3, t=z3, b=z3,
            uv=jnp.zeros((n, v, 2), jnp.float32), wo=z3, material=zi, light=zi,
            light_idx=zi, beta=z3, pdf_fwd=z, pdf_rev=z, delta=zb,
            on_surface=zb, valid=zb,
        )

    def at(self, i: int):
        """Slice vertex i -> dict of (N, ...) arrays."""
        return jax.tree.map(lambda a: a[:, i], self)

    def gather(self, idxs: list[int]):
        """Static strategy-axis gather: vertex data at each (static) index
        in ``idxs`` stacked to (S, N, ...) — the batched-strategy view."""
        return jax.tree.map(
            lambda a: jnp.stack([a[:, i] for i in idxs], axis=0), self
        )

    def set_vertex(self, i: int, **fields):
        out = self
        for k, v in fields.items():
            arr = getattr(out, k)
            out = out.replace(**{k: arr.at[:, i].set(v)})
        return out


def _gather_bsdfs(bsdfs: UberBSDF, idxs: list[int]) -> UberBSDF:
    """Static strategy-axis gather of the stacked per-vertex BSDF SoA
    ((N, V, ...) -> (S, N, ...))."""
    return jax.tree.map(
        lambda a: jnp.stack([a[:, i] for i in idxs], axis=0), bsdfs
    )


def _convert_density(pdf_solid, from_p, to_p, to_ng, to_on_surface):
    """Solid-angle -> area density (``convertVertexDensity``,
    ``BDPT.cl:44-60``)."""
    d = to_p - from_p
    d2 = jnp.maximum(m.length_sq(d), 1e-12)
    w = d * jax.lax.rsqrt(d2)[..., None]
    cos = jnp.abs(m.dot(to_ng, w))
    factor = jnp.where(to_on_surface, cos, 1.0)
    return pdf_solid * factor / d2


def _remap0(x):
    """``remap0``: treat 0 pdfs as 1 in MIS ratios (delta handling)."""
    return jnp.where(x != 0.0, x, 1.0)


def _g_term(a_p, a_ns, b_p, b_ns):
    d = b_p - a_p
    d2 = jnp.maximum(m.length_sq(d), 1e-12)
    w = d * jax.lax.rsqrt(d2)[..., None]
    return jnp.abs(m.dot(a_ns, w)) * jnp.abs(m.dot(b_ns, w)) / d2


def _zero_bsdf(n: int, like: UberBSDF | None = None) -> UberBSDF:
    """Lobe-less BSDF placeholder for origin vertices (never evaluated; a
    zero lobe set yields f=0, pdf=0 if touched).  Static fields (dist,
    used-lobe mask) copy from ``like`` so stacking stays structurally
    uniform."""
    z3 = jnp.zeros((n, 3), jnp.float32)
    z = jnp.zeros((n,), jnp.float32)
    return UberBSDF(diffuse=z3, glossy=z3, kr=z3, kt=z3, passthrough=z3,
                    alpha=z, eta=z, conductor_eta=z3, conductor_k=z3,
                    rs_blend=z3,
                    dist=like.dist if like is not None else 0,
                    used=like.used if like is not None else (True,) * 7)


def random_walk(
    scene: Scene,
    rays: Rays,
    beta: jax.Array,
    pdf_dir: jax.Array,
    stream: rng.SampleStream,
    verts: Vertices,
    start_index: int,
    n_steps: int,
    importance_mode: bool,
    cfg: IntegratorConfig,
    intersect,
):
    """Extend a subpath by up to n_steps surface vertices (PBRT RandomWalk /
    ``GenerateSecondaryVertices``, ``BDPT.cl:317-458``).  Returns the
    vertices plus the per-vertex BSDF parameters stacked (N, V, ...) — each
    vertex's material/texture gather happens exactly once, here, and every
    connection strategy reuses it (the reference likewise pays one material
    fetch per kernel *stage*, not per strategy)."""
    active = rays.active
    step_bsdfs: dict[int, UberBSDF] = {}

    for step in range(n_steps):
        i = start_index + step
        hit = intersect(scene, rays)
        alive = active & hit.valid
        it = compute_interaction(scene, rays, hit)
        bsdf, it = fetch_bsdf(scene, it)
        step_bsdfs[i] = bsdf

        pv = verts.at(i - 1)
        pdf_fwd = _convert_density(pdf_dir, pv.p, it.p, it.ng, jnp.ones_like(hit.valid))

        verts = verts.set_vertex(
            i,
            vtype=jnp.full_like(hit.prim, VT_SURFACE),
            p=it.p, ng=it.ng, ns=it.ns, t=it.dpdu, b=it.dpdv, uv=it.uv,
            wo=it.wo, material=it.material, light=it.light,
            beta=jnp.where(alive[:, None], beta, 0.0),
            pdf_fwd=jnp.where(alive, pdf_fwd, 0.0),
            on_surface=alive,
            valid=alive,
        )

        u_bsdf, stream = rng.next_3d(stream)
        wo_l = m.to_local(it.dpdu, it.dpdv, it.ns, it.wo)
        bs = uber.sample(bsdf, wo_l, u_bsdf)
        wi_w = m.to_world(it.dpdu, it.dpdv, it.ns, bs.wi)

        # reverse pdf of the PREVIOUS vertex (direction wi -> wo swapped)
        wi_l = bs.wi
        pdf_rev_solid = uber.pdf(bsdf, wi_l, wo_l)
        pdf_rev_solid = jnp.where(bs.is_specular, 0.0, pdf_rev_solid)
        prev_rev = _convert_density(
            pdf_rev_solid, it.p, pv.p, pv.ng, pv.on_surface,
        )
        verts = verts.set_vertex(
            i - 1, pdf_rev=jnp.where(alive, prev_rev, verts.pdf_rev[:, i - 1])
        )

        cos_wi = jnp.abs(m.dot(it.ns, wi_w))
        w_mul = bs.f * m.safe_div(cos_wi, bs.pdf)[..., None]
        if importance_mode:
            # shading-normal correction (BDPT.cl:23-36)
            num = jnp.abs(m.dot(it.wo, it.ns)) * jnp.abs(m.dot(wi_w, it.ng))
            den = jnp.abs(m.dot(it.wo, it.ng)) * jnp.abs(m.dot(wi_w, it.ns))
            w_mul = w_mul * m.safe_div(num, den)[..., None]
        new_beta = beta * w_mul
        extend = alive & bs.valid & ~m.is_black(new_beta)
        rays = spawn_ray(it, wi_w, cfg.trace_offset, cfg.max_trace_distance, extend)
        pdf_dir = jnp.where(bs.is_specular, 0.0, bs.pdf)
        beta = jnp.where(extend[:, None], new_beta, 0.0)
        active = extend
        # a vertex's delta flag records how it was REACHED: mark vertex i+1
        if i + 1 < verts.delta.shape[1]:
            verts = verts.replace(
                delta=verts.delta.at[:, i + 1].set(
                    jnp.where(extend, bs.is_specular, False)
                )
            )

    n = verts.p.shape[0]
    n_verts = verts.p.shape[1]
    zero = _zero_bsdf(n, step_bsdfs.get(start_index))
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs, axis=1),
        *[step_bsdfs.get(i, zero) for i in range(n_verts)],
    )
    return verts, stream, stacked


def generate_camera_subpath(scene, camera, rays, stream, n_verts, cfg, intersect):
    n = rays.n
    verts = Vertices.empty(n, n_verts)
    _, pdf_dir = camera.pdf_we(rays.d)
    verts = verts.set_vertex(
        0,
        vtype=jnp.full((n,), VT_CAMERA, jnp.int32),
        p=jnp.broadcast_to(camera.position, (n, 3)),
        ng=jnp.broadcast_to(camera.forward, (n, 3)),
        ns=jnp.broadcast_to(camera.forward, (n, 3)),
        beta=jnp.ones((n, 3), jnp.float32),
        pdf_fwd=jnp.ones((n,), jnp.float32),
        valid=jnp.ones((n,), bool),
    )
    beta = jnp.ones((n, 3), jnp.float32)
    return random_walk(
        scene, rays, beta, pdf_dir, stream, verts, 1, n_verts - 1,
        importance_mode=False, cfg=cfg, intersect=intersect,
    )


def generate_light_subpath(scene, stream, n_verts, cfg, intersect, n):
    verts = Vertices.empty(n, n_verts)
    u_pick, stream = rng.next_1d(stream)
    u_pos, stream = rng.next_2d(stream)
    u_dir, stream = rng.next_2d(stream)
    l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
    le = lt.sample_le(scene, l_idx, u_pos, u_dir)
    ltype = jnp.take(scene.lights.type, jnp.maximum(l_idx, 0), axis=0, mode="clip")
    # directional lights walk too: origin sampled on a scene-radius disk
    # outside the scene with pdf_pos = 1/(pi r^2), delta direction
    # (``lights.cl:148-224`` walks them the same way)
    usable = le.valid & (scene.lights.num > 0)

    pdf_origin = le.pdf_pos * pdf_choice
    beta0 = le.le / jnp.maximum(pdf_origin, 1e-20)[:, None]
    tl, bl = m.build_orthonormal_basis(le.n)
    is_inf = ltype == LIGHT_DIRECTIONAL
    verts = verts.set_vertex(
        0,
        vtype=jnp.full((n,), VT_LIGHT, jnp.int32),
        p=le.p, ng=le.n, ns=le.n, t=tl, b=bl,
        light_idx=jnp.where(usable, l_idx, -1),
        beta=jnp.where(usable[:, None], beta0, 0.0),
        # infinite (delta-direction) lights: the origin's spatial density is
        # the directional density of re-sampling it, 0 for a delta light
        # (PBRT InfiniteLightDensity); remap0 turns it into 1 in MIS ratios
        pdf_fwd=jnp.where(usable & ~is_inf, pdf_origin, 0.0),
        # the delta FIELD records how a vertex was REACHED and is always
        # False for light origins (PBRT Vertex::CreateLight); whether the
        # LIGHT itself is delta is recovered from its type in the MIS walk
        delta=jnp.zeros((n,), bool),
        valid=usable,
    )
    on_surf0 = (ltype == LIGHT_DISK) | (ltype == LIGHT_MESH)
    verts = verts.set_vertex(0, on_surface=on_surf0 & usable)
    cos0 = jnp.abs(m.dot(le.n, le.d))
    cos0 = jnp.where(ltype == LIGHT_POINT, 1.0, cos0)
    beta1 = beta0 * m.safe_div(cos0, le.pdf_dir)[:, None]
    rays = Rays(
        o=le.p + le.n * jnp.where((ltype == LIGHT_POINT)[:, None], 0.0, cfg.trace_offset),
        d=le.d,
        tmin=jnp.zeros((n,), jnp.float32),
        tmax=jnp.full((n,), cfg.max_trace_distance, jnp.float32),
        active=usable,
    )
    verts, stream, bsdfs = random_walk(
        scene, rays, beta1, le.pdf_dir, stream, verts, 1, n_verts - 1,
        importance_mode=True, cfg=cfg, intersect=intersect,
    )
    # infinite (delta-direction) lights: the first surface vertex's forward
    # density is the planar disk density 1/(pi r^2) projected onto the
    # surface — not a solid-angle conversion of the delta direction pdf
    # (PBRT GenerateLightSubpath's infinite-light correction)
    if n_verts > 1:
        v1 = verts.at(1)
        pdf1_inf = le.pdf_pos * jnp.abs(m.dot(le.d, v1.ng))
        verts = verts.replace(
            pdf_fwd=verts.pdf_fwd.at[:, 1].set(
                jnp.where(is_inf & v1.valid, pdf1_inf, verts.pdf_fwd[:, 1])
            )
        )
    return verts, stream, bsdfs


# --------------------------------------------------------------------------
# Batched MIS ratio walk
# --------------------------------------------------------------------------


def _mis_weights(
    s_arr, t_arr, cam: Vertices, light: Vertices,
    pt_rev, pt_minus_rev, qs_rev, qs_minus_rev,
    light0_fwd, light0_rev, light0_delta, light0_valid, light0_is_delta,
):
    """Balance-heuristic MIS weights for a batch of strategies — the
    functional, strategy-vectorized version of the reference's
    temporary-mutation ratio walk (``BDPT.cl:649-875``).

    ``s_arr``/``t_arr``: static per-strategy (s, t).  The four ``*_rev``
    overrides are the endpoint-density rewrites, (S, N).  ``light0_*`` carry
    the light-path INDEX-0 fields per strategy — the walked light origin for
    s>=2 strategies, the resampled light vertex for s=1 strategies (whose
    1-vertex path never lives in ``light``).  Returns (S, N) weights.
    """
    S = len(s_arr)
    n = cam.p.shape[0]
    v_t = cam.p.shape[1]
    v_s = light.p.shape[1]
    s_col = jnp.asarray(s_arr, jnp.int32)[:, None]  # (S, 1)
    t_col = jnp.asarray(t_arr, jnp.int32)[:, None]
    f_ = jnp.zeros((1, n), bool)

    sum_ri = jnp.zeros((S, n), jnp.float32)

    # camera side: i = t-1 .. 1 (connection endpoints are never delta)
    ri = jnp.ones((S, n), jnp.float32)
    for j in range(v_t - 1, 0, -1):
        in_path = j <= t_col - 1  # (S, 1)
        rev = jnp.where(
            j == t_col - 1, pt_rev,
            jnp.where(j == t_col - 2, pt_minus_rev, cam.pdf_rev[None, :, j]),
        )
        r = _remap0(rev) / _remap0(cam.pdf_fwd[None, :, j])
        ri = jnp.where(in_path, ri * r, ri)
        d_j = jnp.where(j == t_col - 1, f_, cam.delta[None, :, j])
        use = in_path & ~(d_j | cam.delta[None, :, j - 1]) & cam.valid[None, :, j]
        sum_ri = sum_ri + jnp.where(use, ri, 0.0)

    # light side: i = s-1 .. 0.  The i=0 strategy ("connect to the light
    # origin") does not exist for delta lights: point lights (delta
    # position) and directional lights (delta direction) both exclude it —
    # PBRT's IsDeltaLight(), recovered from the light's type (light0_is_delta).
    ri = jnp.ones((S, n), jnp.float32)
    for j in range(v_s - 1, -1, -1):
        in_path = j <= s_col - 1
        stored_rev = light.pdf_rev[None, :, j] if j > 0 else light0_rev
        rev = jnp.where(
            j == s_col - 1, qs_rev,
            jnp.where(j == s_col - 2, qs_minus_rev, stored_rev),
        )
        fwd = light.pdf_fwd[None, :, j] if j > 0 else light0_fwd
        r = _remap0(rev) / _remap0(fwd)
        ri = jnp.where(in_path, ri * r, ri)
        d_j = jnp.where(
            j == s_col - 1, f_,
            light.delta[None, :, j] if j > 0 else light0_delta,
        )
        d_prev = (light0_is_delta if j == 0
                  else (light.delta[None, :, j - 1] if j > 1 else light0_delta))
        valid_j = light.valid[None, :, j] if j > 0 else light0_valid
        use = in_path & ~(d_j | d_prev) & valid_j
        sum_ri = sum_ri + jnp.where(use, ri, 0.0)

    w = 1.0 / (1.0 + sum_ri)
    return jnp.where(s_col + t_col == 2, 1.0, w)


def _light0_fields(scene, light: Vertices, S: int):
    """(S-broadcast) index-0 light-path fields for walked-subpath strategies
    (s=0 and s>=2): the walked light origin."""
    l_idx0 = light.light_idx[:, 0]
    ltype0 = jnp.take(scene.lights.type, jnp.maximum(l_idx0, 0), axis=0,
                      mode="clip")
    is_delta0 = (
        (ltype0 == LIGHT_POINT) | (ltype0 == LIGHT_DIRECTIONAL)
    ) & (l_idx0 >= 0)
    b = lambda a: jnp.broadcast_to(a[None, :], (S,) + a.shape)
    return (b(light.pdf_fwd[:, 0]), b(light.pdf_rev[:, 0]),
            b(light.delta[:, 0]), b(light.valid[:, 0]), b(is_delta0))


def _pdf_vertex(bsdf: UberBSDF, v, new_wo_p, next_p, next_ng, next_surf):
    """Area pdf of a surface vertex generating ``next`` with wo replaced by
    dir(v -> new_wo_p) — the functional form of the reference's temporary wo
    mutation (PBRT Vertex::Pdf).  All inputs batched (S, N, ...)."""
    wo = m.normalize(new_wo_p - v.p)
    wi = m.normalize(next_p - v.p)
    wo_l = m.to_local(v.t, v.b, v.ns, wo)
    wi_l = m.to_local(v.t, v.b, v.ns, wi)
    pdf_solid = uber.pdf(bsdf, wo_l, wi_l)
    return _convert_density(pdf_solid, v.p, next_p, next_ng, next_surf)


def _pdf_light_dir_v(scene, light_idx, light_p, light_ns, next_p, next_ng,
                     next_surf):
    """Area pdf of a light vertex emitting toward ``next`` (PBRT PdfLight).

    Infinite (delta-direction) lights use the planar disk density
    1/(pi r^2) projected onto the receiver — never a 1/d^2 conversion."""
    w = m.normalize(next_p - light_p)
    pdf_pos, pdf_dir = lt.pdf_le(scene, jnp.maximum(light_idx, 0), light_ns, w)
    ltype = jnp.take(scene.lights.type, jnp.maximum(light_idx, 0), axis=0,
                     mode="clip")
    is_inf = (ltype == LIGHT_DIRECTIONAL) & (light_idx >= 0)
    pdf_area = _convert_density(pdf_dir, light_p, next_p, next_ng, next_surf)
    cos_next = jnp.where(next_surf, jnp.abs(m.dot(next_ng, w)), 1.0)
    return jnp.where(is_inf, pdf_pos * cos_next, pdf_area)


def _eval_f(bsdf: UberBSDF, v, wi_world):
    """BSDF value at vertex batch v for world direction wi (wo stored)."""
    wo_l = m.to_local(v.t, v.b, v.ns, v.wo)
    wi_l = m.to_local(v.t, v.b, v.ns, wi_world)
    return uber.evaluate(bsdf, wo_l, wi_l)


def _shading_normal_correction(v, wi):
    """Importance-mode shading-normal correction at a light-subpath vertex
    (``BDPT.cl:23-36``)."""
    num = jnp.abs(m.dot(v.wo, v.ns)) * jnp.abs(m.dot(wi, v.ng))
    den = jnp.abs(m.dot(v.wo, v.ng)) * jnp.abs(m.dot(wi, v.ns))
    return m.safe_div(num, den)


def _interaction_of(v) -> Interaction:
    return Interaction(
        p=v.p, ng=v.ng, ns=v.ns, dpdu=v.t, dpdv=v.b, uv=v.uv, wo=v.wo,
        duvdx=jnp.zeros_like(v.uv), duvdy=jnp.zeros_like(v.uv),
        material=v.material, light=v.light, valid=v.valid,
    )


# --------------------------------------------------------------------------
# Strategy families (each evaluates ALL its (s,t) pairs as one batch)
# --------------------------------------------------------------------------


def _family_s0(scene, camera, cam, light, cam_bsdfs, pairs):
    """Camera subpath hit a light (``PrepareConnections`` s=0 branch): no
    visibility ray; returns the summed weighted contribution (N, 3)."""
    t_arr = [t for (_, t) in pairs]
    pt = cam.gather([t - 1 for t in t_arr])  # (S, N, ...)
    ptm = cam.gather([t - 2 for t in t_arr])
    n = cam.p.shape[0]
    S = len(pairs)
    surf = jnp.ones((S, n), bool)

    is_light = pt.valid & (pt.light >= 0)
    le = lt.eval_le(scene, pt.light, pt.ns, pt.wo)
    contrib = pt.beta * le

    # overrides: pt is a light -> origin-density + emission-direction pdfs
    num_l = jnp.maximum(scene.lights.num, 1).astype(jnp.float32)
    pdf_pos0, _ = lt.pdf_le(scene, jnp.maximum(pt.light, 0), pt.ns, pt.ns)
    pt_rev = jnp.where(pt.light >= 0, pdf_pos0 / num_l, 0.0)
    w_dir = m.normalize(ptm.p - pt.p)
    _, pdf_dir = lt.pdf_le(scene, jnp.maximum(pt.light, 0), pt.ns, w_dir)
    pdf_dir = jnp.where(pt.light >= 0, pdf_dir, 0.0)
    pt_minus_rev = _convert_density(pdf_dir, pt.p, ptm.p, ptm.ng,
                                    ptm.on_surface)

    zero = jnp.zeros((S, n), jnp.float32)
    fls = jnp.zeros((S, n), bool)
    w = _mis_weights(
        [0] * S, t_arr, cam, light, pt_rev, pt_minus_rev, zero, zero,
        zero, zero, fls, fls, fls,
    )
    out = jnp.where(is_light[..., None], contrib * w[..., None], 0.0)
    return jnp.sum(out, axis=0)


def _family_s1(scene, camera, cam, light, cam_bsdfs, pairs, stream, cfg,
               s1_only):
    """Resample a light for each camera vertex (NEE inside BDPT), batched
    over strategies.  Returns (srays (S,N), contrib (S,N,3), ok (S,N))."""
    t_arr = [t for (_, t) in pairs]
    S = len(pairs)
    n = cam.p.shape[0]
    pt = cam.gather([t - 1 for t in t_arr])
    ptm = cam.gather([t - 2 for t in t_arr])
    pt_bsdf = _gather_bsdfs(cam_bsdfs, [t - 1 for t in t_arr])

    # RNG: one (pick, light) draw per strategy, in ascending-t order — the
    # same stream consumption as a per-strategy enumeration
    u_picks, u_lights = [], []
    for _ in pairs:
        u_pick, stream = rng.next_1d(stream)
        u_light, stream = rng.next_2d(stream)
        u_picks.append(u_pick)
        u_lights.append(u_light)
    u_pick = jnp.stack(u_picks, axis=0)  # (S, N)
    u_light = jnp.stack(u_lights, axis=0)  # (S, N, 2)

    l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
    ls = lt.sample_li(scene, l_idx, pt.p, u_light)

    wo_l = m.to_local(pt.t, pt.b, pt.ns, pt.wo)
    wi_l = m.to_local(pt.t, pt.b, pt.ns, ls.wi)
    f = uber.evaluate(pt_bsdf, wo_l, wi_l)
    cos_i = jnp.abs(m.dot(pt.ns, ls.wi))
    ok = (
        pt.valid & (pt.vtype == VT_SURFACE) & ls.valid
        & ~m.is_black(f) & (scene.lights.num > 0)
    )
    # one-sided geometric check
    front = (m.dot(pt.ng, ls.wi) * m.dot(pt.ng, pt.wo)) > 0.0
    ok = ok & front

    srays = spawn_shadow_ray(_interaction_of(pt), ls.wi, ls.dist,
                             cfg.trace_offset, ok)
    contrib = pt.beta * f * ls.li * m.safe_div(
        cos_i, ls.pdf * pdf_choice)[..., None]

    if s1_only:
        return srays, contrib, ok, stream

    # MIS: the sampled light vertex forms each strategy's 1-vertex light path
    surf = jnp.ones((S, n), bool)
    pdf_pos, _ = lt.pdf_le(scene, l_idx, ls.n, ls.wi)
    pt_rev = _pdf_light_dir_v(scene, jnp.where(ok, l_idx, -1), ls.p, ls.n,
                              pt.p, pt.ng, surf)
    pt_minus_rev = _pdf_vertex(pt_bsdf, pt, ls.p, ptm.p, ptm.ng,
                               ptm.on_surface)
    qs_rev = _pdf_vertex(pt_bsdf, pt, ptm.p, ls.p, ls.n, surf)

    ltype = jnp.take(scene.lights.type, jnp.maximum(l_idx, 0), axis=0,
                     mode="clip")
    light0_is_delta = (
        (ltype == LIGHT_POINT) | (ltype == LIGHT_DIRECTIONAL)
    ) & (l_idx >= 0)
    zero = jnp.zeros((S, n), jnp.float32)
    w = _mis_weights(
        [1] * S, t_arr, cam, light, pt_rev, pt_minus_rev, qs_rev, zero,
        light0_fwd=pdf_pos * pdf_choice, light0_rev=zero,
        light0_delta=ls.is_delta, light0_valid=ok,
        light0_is_delta=light0_is_delta,
    )
    return srays, contrib * w[..., None], ok, stream


def _family_connect(scene, camera, cam, light, cam_bsdfs, light_bsdfs,
                    pairs, cfg):
    """General (s>=2, t>=2) connections with geometric term G, batched
    (``PrepareConnections``/``ConnectVertices`` s,t>=2 branch)."""
    s_arr = [s for (s, _) in pairs]
    t_arr = [t for (_, t) in pairs]
    S = len(pairs)
    n = cam.p.shape[0]
    pt = cam.gather([t - 1 for t in t_arr])
    ptm = cam.gather([t - 2 for t in t_arr])
    qs = light.gather([s - 1 for s in s_arr])
    qsm = light.gather([s - 2 for s in s_arr])
    pt_bsdf = _gather_bsdfs(cam_bsdfs, [t - 1 for t in t_arr])
    qs_bsdf = _gather_bsdfs(light_bsdfs, [s - 1 for s in s_arr])

    ok = (
        pt.valid & qs.valid
        & (pt.vtype == VT_SURFACE) & (qs.vtype == VT_SURFACE)
    )
    d = qs.p - pt.p
    d2 = jnp.maximum(m.length_sq(d), 1e-12)
    dist = jnp.sqrt(d2)
    w_pt_to_qs = d / dist[..., None]

    f_pt = _eval_f(pt_bsdf, pt, w_pt_to_qs)
    f_qs = _eval_f(qs_bsdf, qs, -w_pt_to_qs)
    f_qs = f_qs * _shading_normal_correction(qs, -w_pt_to_qs)[..., None]

    g = _g_term(pt.p, pt.ns, qs.p, qs.ns)
    contrib = pt.beta * f_pt * g[..., None] * f_qs * qs.beta
    ok = ok & ~m.is_black(contrib)

    srays = spawn_shadow_ray(_interaction_of(pt), w_pt_to_qs, dist,
                             cfg.trace_offset, ok)

    # endpoint overrides
    surf = jnp.ones((S, n), bool)
    pt_rev = _pdf_vertex(qs_bsdf, qs, qsm.p, pt.p, pt.ng, surf)
    pt_minus_rev = _pdf_vertex(pt_bsdf, pt, qs.p, ptm.p, ptm.ng,
                               ptm.on_surface)
    qs_rev = _pdf_vertex(pt_bsdf, pt, ptm.p, qs.p, qs.ng, surf)
    qs_minus_rev = _pdf_vertex(qs_bsdf, qs, pt.p, qsm.p, qsm.ng,
                               qsm.on_surface)

    l0 = _light0_fields(scene, light, S)
    w = _mis_weights(s_arr, t_arr, cam, light, pt_rev, pt_minus_rev,
                     qs_rev, qs_minus_rev, *l0)
    return srays, contrib * w[..., None], ok


def _family_t1(scene, camera, cam, light, light_bsdfs, pairs, cfg, n,
               film, slot_of_pixel):
    """Connect light vertices to the camera; splat at the projected pixel
    (``ConnectVertices`` t=1 + atomic splats -> scatter-add).  Returns
    (srays, contrib, ok, flat-splat-indices), all strategy-batched."""
    s_arr = [s for (s, _) in pairs]
    S = len(pairs)
    qs = light.gather([s - 1 for s in s_arr])
    qsm = light.gather([s - 2 for s in s_arr])
    qs_bsdf = _gather_bsdfs(light_bsdfs, [s - 1 for s in s_arr])

    wi, dist, we, pdf_cam, uv, inside = camera.sample_wi(qs.p)
    ok = qs.valid & (qs.vtype == VT_SURFACE) & inside & (we > 0.0)

    f = _eval_f(qs_bsdf, qs, wi)
    f = f * _shading_normal_correction(qs, wi)[..., None]
    cos_i = jnp.abs(m.dot(qs.ns, wi))
    ok = ok & ~m.is_black(f)

    srays = spawn_shadow_ray(_interaction_of(qs), wi, dist,
                             cfg.trace_offset, ok)
    contrib = qs.beta * f * (we * m.safe_div(cos_i, pdf_cam))[..., None]

    # MIS: camera side is the lone eye vertex (t=1); light side walks fully
    surf = jnp.ones((S, n), bool)
    cam_pos = jnp.broadcast_to(camera.position, (S, n, 3))
    w_dir = m.normalize(qs.p - cam_pos)
    _, pdf_dir = camera.pdf_we(w_dir)
    qs_rev = _convert_density(pdf_dir, cam_pos, qs.p, qs.ng, surf)
    qs_minus_rev = _pdf_vertex(qs_bsdf, qs, cam_pos, qsm.p, qsm.ng,
                               qsm.on_surface)

    zero = jnp.zeros((S, n), jnp.float32)
    l0 = _light0_fields(scene, light, S)
    w = _mis_weights(s_arr, [1] * S, cam, light, zero, zero,
                     qs_rev, qs_minus_rev, *l0)
    contrib = contrib * w[..., None]

    # splat routing: scatter-add into the flat pixel grid (v=0 bottom row).
    # pixel layout must match camera/pinhole.pixel_uv: idx = row*W + col
    # derived from uv; the film resolution comes from the caller (falls back
    # to a square sqrt(n) film for direct trace() users).
    if film is not None:
        w_img, h_img = film
    else:
        import math as pymath

        w_img = int(pymath.isqrt(n))
        h_img = n // w_img
    px = jnp.clip((uv[..., 0] * w_img).astype(jnp.int32), 0, w_img - 1)
    py = jnp.clip((uv[..., 1] * h_img).astype(jnp.int32), 0, h_img - 1)
    flat = py * w_img + px
    if slot_of_pixel is not None:
        # rays are a permutation of pixels: route the splat to the ray slot
        # that the caller's inverse permutation maps back to pixel `flat`
        flat = jnp.take(slot_of_pixel, flat, axis=0)
    return srays, contrib, ok, flat


def _chunked_occlusion(scene, occluded, srays: Rays, n: int) -> jax.Array:
    """Resolve an (S, N)-batched shadow-ray table with occlusion queries of
    at most OCC_CHUNK_RAYS rays each.  Returns blocked (S, N) bool."""
    S = srays.o.shape[0]
    per = max(1, OCC_CHUNK_RAYS // max(n, 1))
    outs = []
    for lo in range(0, S, per):
        hi = min(S, lo + per)
        chunk = jax.tree.map(
            lambda a: a[lo:hi].reshape((hi - lo) * n, *a.shape[2:]), srays
        )
        outs.append(occluded(scene, chunk).reshape(hi - lo, n))
    return jnp.concatenate(outs, axis=0)


def trace(
    scene: Scene,
    camera: PinholeCamera,
    rays: Rays,
    stream: rng.SampleStream,
    cfg: IntegratorConfig,
    intersect,
    occluded,
    s1_only: bool = False,
    film: tuple[int, int] | None = None,
    slot_of_pixel: jax.Array | None = None,
):
    """Full BDPT estimate for one wavefront. Returns (N, 3) radiance
    including splatted t=1 contributions (accumulated via scatter-add).

    s1_only reproduces the forward path tracer (the reference's
    ``SHOW_REGULAR_PATH_TRACER_RESULTS`` cross-check, ``BDPT.cl:18``).

    ``film`` is the (W, H) resolution used to address t=1 film splats
    (``ConnectVertices`` atomic splats, ``BDPT.cl:654-669``); defaults to a
    square film of sqrt(n) for direct callers.  ``slot_of_pixel`` maps a
    row-major pixel index to the ray slot carrying that pixel — the renderer
    traces rays in Morton order, so splats must land in the slot that the
    caller's inverse permutation will send back to the right pixel."""
    n = rays.n
    t_max = cfg.max_depth + 2
    s_max = cfg.max_depth + 1

    cam, stream, cam_bsdfs = generate_camera_subpath(
        scene, camera, rays, stream, t_max, cfg, intersect
    )
    light, stream, light_bsdfs = generate_light_subpath(
        scene, stream, s_max, cfg, intersect, n
    )

    # static strategy tables, one per family (enumeration order matches the
    # reference's per-pixel double loop, PrepareConnections BDPT.cl:460-646)
    def in_range(s, t):
        depth = s + t - 2
        return 0 <= depth <= cfg.max_depth

    s0_pairs = [(0, t) for t in range(2, t_max + 1) if in_range(0, t)]
    s1_pairs = [(1, t) for t in range(2, t_max + 1) if in_range(1, t)]
    conn_pairs = [
        (s, t)
        for t in range(2, t_max + 1)
        for s in range(2, s_max + 1)
        if in_range(s, t)
    ]
    t1_pairs = [(s, 1) for s in range(2, s_max + 1) if in_range(s, 1)]

    L = jnp.zeros((n, 3), jnp.float32)

    if not s1_only and s0_pairs:
        L = L + _family_s0(scene, camera, cam, light, cam_bsdfs, s0_pairs)

    # deferred visibility: every connecting family emits strategy-batched
    # (srays, weighted contrib, ok); occlusion queries resolve them in ray
    # chunks — the reference's PrepareConnections -> single QueryOcclusion
    # staging (RTBDPTPass.cpp:309-347), bounded per query.
    blocks: list[tuple[Rays, jax.Array, jax.Array, jax.Array | None]] = []

    if s1_pairs:
        srays, contrib, ok, stream = _family_s1(
            scene, camera, cam, light, cam_bsdfs, s1_pairs, stream, cfg,
            s1_only,
        )
        blocks.append((srays, contrib, ok, None))
    if not s1_only and conn_pairs:
        blocks.append(_family_connect(
            scene, camera, cam, light, cam_bsdfs, light_bsdfs, conn_pairs,
            cfg) + (None,))
    if not s1_only and t1_pairs:
        blocks.append(_family_t1(
            scene, camera, cam, light, light_bsdfs, t1_pairs, cfg, n,
            film, slot_of_pixel,
        ))

    if blocks:
        all_rays = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *[b[0] for b in blocks]
        )
        blocked = _chunked_occlusion(scene, occluded, all_rays, n)
        row = 0
        for srays, contrib, ok, flat in blocks:
            S = srays.o.shape[0]
            vis = ok & ~blocked[row:row + S]
            row += S
            masked = jnp.where(vis[..., None], contrib, 0.0)
            if flat is None:
                L = L + jnp.sum(masked, axis=0)
            else:
                L = L.at[flat.reshape(-1)].add(
                    masked.reshape(S * n, 3))
    return L
