"""Unidirectional wavefront path integrator — the hot loop.

Redesign of the reference's host-driven per-bounce pipeline
(``RTPathTracingPass.cpp:71-86`` driving ``PathTracing.cl``): where the
reference launches 2 kernels + 2 intersection queries per bounce with blocking
``Finish`` between each (SURVEY §3.2), here the *entire* bounce loop — shade,
NEE, occlusion, BSDF sampling, ray spawn — is one ``lax.fori_loop`` inside one
jitted XLA program.  No host round-trips, no launch overhead; XLA fuses the
shading math around the traversal kernels.

Per-bounce logic mirrors ``PathTracing`` + ``ShadowPass``
(``PathTracing.cl:52-217``):
  - emitter hits counted only at bounce 0 or after a specular bounce
    (:91-101) — or MIS-weighted when ``cfg.use_mis`` (an improvement the
    reference leaves unused, its heuristics sit in ``samplers.cl:233-246``);
  - NEE with uniform light pick, BSDF eval ÷ light pdf (:107-136);
  - BSDF sampling extends the path with a geometric-offset spawn and
    transmission sign flip (:139-175);
  - visibility applied to the NEE contribution afterwards (:186-217).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Rays, Throughput
from ..lights import lights as lt
from ..sampling import rng, samplers as smp
from ..scene.interaction import compute_interaction, spawn_ray, spawn_shadow_ray
from ..scene.scene import Scene

IntersectFn = Callable[[Scene, Rays], object]
OccludedFn = Callable[[Scene, Rays], jax.Array]


def _shade(scene, cfg, i, rays, hit, tp, stream, prev_pdf, prev_p,
           bounce_diff=None):
    """Shading stage of one wavefront bounce (``PathTracing.cl:52-184``):
    emitter-hit accounting, NEE sample, BSDF sampling + path extension.

    The NEE contribution is NOT yet added to radiance — the caller applies
    it once visibility is known (the reference likewise defers it to
    ``ShadowPass``, :186-217).  Returns ``(new_rays, tp, stream,
    new_prev_pdf, new_prev_p, srays, contrib, nee_ok)``.

    ``bounce_diff`` (static): camera-ray differentials — only the peeled
    primary bounce passes them, so the secondary-bounce loop compiles the
    cheaper bilinear texture path (the reference integrators likewise call
    the non-differential ``computeSurfaceInteraction``,
    ``PathTracing.cl:74``)."""
    alive = tp.active & hit.valid

    it = compute_interaction(scene, rays, hit, diff=bounce_diff)
    bsdf, it = fetch_bsdf(scene, it)

    t_f, b_f, n_f = it.dpdu, it.dpdv, it.ns
    wo_l = m.to_local(t_f, b_f, n_f, it.wo)

    # ---- emitter hit (PathTracing.cl:91-101)
    hit_light = alive & (it.light >= 0)
    le = lt.eval_le(scene, it.light, it.ns, it.wo)
    if cfg.use_mis:
        # light pdf of having sampled this direction via NEE from prev_p
        num_l = jnp.maximum(scene.lights.num, 1).astype(jnp.float32)
        pdf_light = lt.pdf_li(scene, it.light, prev_p, rays.d, it.p, it.ns) / num_l
        w_mis = jnp.where(
            (i == 0) | tp.specular_bounce,
            1.0,
            smp.power_heuristic(1.0, prev_pdf, 1.0, pdf_light),
        )
        emit_w = jnp.where(hit_light, w_mis, 0.0)
    else:
        count_emitter = (i == 0) | tp.specular_bounce
        emit_w = jnp.where(hit_light & count_emitter, 1.0, 0.0)
    radiance = tp.radiance + tp.beta * le * emit_w[..., None]

    # ---- NEE (PathTracing.cl:107-136)
    u_pick, stream = rng.next_1d(stream)
    u_light, stream = rng.next_2d(stream)
    u_bsdf, stream = rng.next_3d(stream)

    can_nee = alive & bsdf.has_non_delta() & (scene.lights.num > 0)
    l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
    ls = lt.sample_li(scene, l_idx, it.p, u_light)
    wi_l = m.to_local(t_f, b_f, n_f, ls.wi)
    f_nee = uber.evaluate(bsdf, wo_l, wi_l)
    cos_i = jnp.abs(m.dot(it.ns, ls.wi))
    # keep light on the same geometric side as the reflection lobe
    front_ok = (m.dot(it.ng, ls.wi) * m.dot(it.ng, it.wo)) > 0.0
    nee_ok = can_nee & ls.valid & front_ok & ~m.is_black(f_nee)
    contrib = tp.beta * f_nee * ls.li * m.safe_div(cos_i, ls.pdf * pdf_choice)[..., None]
    if cfg.use_mis:
        pdf_b = uber.pdf(bsdf, wo_l, wi_l)
        w_nee = jnp.where(
            ls.is_delta, 1.0, smp.power_heuristic(1.0, ls.pdf * pdf_choice, 1.0, pdf_b)
        )
        contrib = contrib * w_nee[..., None]
    srays = spawn_shadow_ray(it, ls.wi, ls.dist, cfg.trace_offset, nee_ok)

    # ---- extend path (PathTracing.cl:139-175)
    bs = uber.sample(bsdf, wo_l, u_bsdf)
    wi_w = m.to_world(t_f, b_f, n_f, bs.wi)
    cos_wi = jnp.abs(m.dot(it.ns, wi_w))
    beta_mul = bs.f * m.safe_div(cos_wi, bs.pdf)[..., None]
    new_beta = tp.beta * beta_mul
    extend = alive & bs.valid & ~m.is_black(new_beta)

    if cfg.rr_start_depth > 0:
        # Russian roulette (improvement over the reference's fixed-depth
        # cut, PBRT-style): from rr_start_depth on, continue with
        # probability q = clamp(max beta component) and reweight by 1/q —
        # unbiased path termination that thins deep wavefronts
        u_rr, stream = rng.next_1d(stream)
        q = jnp.clip(jnp.max(new_beta, axis=-1), 0.05, 1.0)
        apply_rr = i >= cfg.rr_start_depth
        survive = jnp.where(apply_rr, u_rr < q, True)
        new_beta = jnp.where(apply_rr, new_beta / q[..., None], new_beta)
        extend = extend & survive

    new_rays = spawn_ray(it, wi_w, cfg.trace_offset, cfg.max_trace_distance, extend)
    tp = Throughput(
        beta=jnp.where(extend[..., None], new_beta, tp.beta),
        radiance=radiance,
        specular_bounce=jnp.where(extend, bs.is_specular, tp.specular_bounce),
        active=extend,
    )
    new_prev_pdf = jnp.where(extend, bs.pdf, prev_pdf)
    return new_rays, tp, stream, new_prev_pdf, it.p, srays, contrib, nee_ok


def _apply_vis(tp, contrib, vis):
    return tp.replace(radiance=tp.radiance + jnp.where(vis[..., None], contrib, 0.0))


def trace(
    scene: Scene,
    rays: Rays,
    stream: rng.SampleStream,
    cfg: IntegratorConfig,
    intersect: IntersectFn,
    occluded: OccludedFn,
    diff=None,
) -> jax.Array:
    """Trace one camera-sample wavefront to completion; returns (N, 3) radiance.

    ``diff`` (optional ``RayDiff``) carries camera-ray differentials: texture
    LOD on the *primary* hit comes from the plane-transferred uv footprint
    (``geometry.cl:92-175``); secondary bounces sample the base mip, like the
    reference integrators (which call the non-differential
    ``computeSurfaceInteraction``, ``PathTracing.cl:74``)."""
    n = rays.n
    tp = Throughput.fresh(n)
    # pdf of the previous BSDF sampling event (for MIS emitter weighting)
    prev_pdf = jnp.ones((n,), jnp.float32)
    prev_p = rays.o

    def bounce(i, carry, bounce_diff=None):
        rays, tp, stream, prev_pdf, prev_p = carry
        hit = intersect(scene, rays)
        (new_rays, tp, stream, prev_pdf, prev_p,
         srays, contrib, nee_ok) = _shade(
            scene, cfg, i, rays, hit, tp, stream, prev_pdf, prev_p,
            bounce_diff)
        if cfg.enable_shadows:
            vis = nee_ok & ~occluded(scene, srays)
        else:
            vis = nee_ok
        tp = _apply_vis(tp, contrib, vis)
        return new_rays, tp, stream, prev_pdf, prev_p

    # peel the primary bounce: it alone carries ray differentials
    carry = (rays, tp, stream, prev_pdf, prev_p)
    carry = bounce(0, carry, bounce_diff=diff)
    if cfg.max_depth > 1:
        carry = jax.lax.fori_loop(1, cfg.max_depth, bounce, carry)
    return carry[1].radiance
