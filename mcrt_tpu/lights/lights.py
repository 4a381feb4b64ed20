"""Light library: NEE sampling, emission eval, BDPT emission sampling.

Vectorized, branch-free analogue of ``assets/kernels/lights.cl``:

- ``eval_le`` — area lights emit one-sided (``lights.cl:29-39``);
- ``sample_li`` — per type: directional (delta, scene-radius shadow ray),
  point (1/d^2), disk area (concentric sample, solid-angle pdf d^2/(cosθ A)),
  triangle-mesh area (area-weighted triangle pick + uniform barycentric,
  pdf 1/area -> solid angle) — each also produces the shadow ray
  (``lights.cl:45-146``);
- ``sample_le`` — emission sampling for BDPT light subpaths with
  (pdf_pos, pdf_dir) per type (``lights.cl:148-224``);
- ``pdf_le`` — (``lights.cl:226-252``).

All four variants are evaluated per-lane and selected by light type with
``jnp.where`` — lights are a few dozen flops, negligible next to traversal, so
uniform control flow is the simple choice over a ``lax.switch``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core.pytree import PyTreeNode, field

from ..core import math as m
from ..sampling import samplers as smp
from ..scene.scene import (
    LIGHT_DIRECTIONAL,
    LIGHT_DISK,
    LIGHT_MESH,
    LIGHT_POINT,
    Lights,
    Scene,
)


class LightSample(PyTreeNode):
    li: jax.Array  # (N, 3) incident radiance (already / d^2 for point)
    wi: jax.Array  # (N, 3) unit dir from ref point to light
    pdf: jax.Array  # (N,) solid-angle pdf at ref point (1 for delta lights)
    dist: jax.Array  # (N,) distance to light sample (for shadow tmax)
    p: jax.Array  # (N, 3) sampled point on light (directional: virtual)
    n: jax.Array  # (N, 3) light-surface normal at sample (area lights)
    is_delta: jax.Array  # (N,) bool
    valid: jax.Array  # (N,) bool


def pick_light(lights: Lights, u: jax.Array):
    """Uniform light pick + choice pdf (``RTScene::computeChoicePdfsForLights``
    uniform pdf, ``RTScene.cpp:412-476``; pick in ``PathTracing.cl:107-136``)."""
    if lights.capacity == 0:
        return jnp.zeros_like(u, jnp.int32), jnp.zeros_like(u)
    num = jnp.maximum(lights.num, 1)
    idx = jnp.clip((u * num).astype(jnp.int32), 0, num - 1)
    pdf = 1.0 / num.astype(jnp.float32)
    return idx, jnp.full_like(u, pdf)


def _sample_mesh_point(scene: Scene, light_idx: jax.Array, u2: jax.Array):
    """Area-weighted triangle pick via the global monotone CDF trick:
    tri_cdf holds light-local CDFs; target = light_id + u searches one global
    sorted array, no per-light dynamic slicing."""
    lights = scene.lights
    lt = lights.tri_cdf.shape[0]
    if lt == 0:
        z = jnp.zeros(light_idx.shape + (3,), jnp.float32)
        return z, z, jnp.zeros_like(light_idx)
    # global cdf: entry j of light l has value l + cdf_j in (l, l+1]
    # (precomputed layout: tri_cdf is light-local; add per-entry light id)
    gcdf = lights.tri_light.astype(jnp.float32) + lights.tri_cdf
    target = light_idx.astype(jnp.float32) + jnp.clip(u2[..., 0], 0.0, 1.0 - 1e-7)
    j = jnp.clip(jnp.searchsorted(gcdf, target, side="left"), 0, lt - 1)
    prim = jnp.take(lights.tri_index, j, axis=0)
    p0, p1, p2 = scene.geometry.face_vertices(prim)
    # re-derive a fresh uniform for barycentrics from u2 (u0 was consumed by
    # the discrete pick; remap within the chosen bin to stay stratified)
    lo = jnp.take(gcdf, jnp.maximum(j - 1, 0), axis=0)
    lo = jnp.where(j == 0, light_idx.astype(jnp.float32), lo)
    lo = jnp.maximum(lo, light_idx.astype(jnp.float32))
    hi = jnp.take(gcdf, j, axis=0)
    u0r = m.safe_div(target - lo, hi - lo)
    bary = smp.uniform_triangle(jnp.stack([u0r, u2[..., 1]], -1))
    p = p0 + (p1 - p0) * bary[..., 0:1] + (p2 - p0) * bary[..., 1:2]
    ng = m.normalize(jnp.cross(p1 - p0, p2 - p0))
    return p, ng, prim


def _empty_light_sample(n: int) -> LightSample:
    z3 = jnp.zeros((n, 3), jnp.float32)
    z = jnp.zeros((n,), jnp.float32)
    f = jnp.zeros((n,), bool)
    return LightSample(li=z3, wi=z3.at[..., 1].set(1.0), pdf=z, dist=z, p=z3,
                       n=z3, is_delta=f, valid=f)


def sample_li(scene: Scene, light_idx: jax.Array, ref_p: jax.Array,
              u2: jax.Array) -> LightSample:
    """Sample incident direction/radiance from light ``light_idx`` at
    ``ref_p`` — ``sampleLightLi`` (``lights.cl:45-146``)."""
    lights = scene.lights
    if lights.capacity == 0:
        return _empty_light_sample(light_idx.shape[0])
    ltype = jnp.take(lights.type, light_idx, axis=0, mode="clip")
    lpos = jnp.take(lights.position, light_idx, axis=0, mode="clip")
    ldir = jnp.take(lights.direction, light_idx, axis=0, mode="clip")
    lint = jnp.take(lights.intensity, light_idx, axis=0, mode="clip")
    lrad = jnp.take(lights.radius, light_idx, axis=0, mode="clip")
    larea = jnp.take(lights.area, light_idx, axis=0, mode="clip")

    scene_diam = 2.0 * scene.radius

    # --- directional (delta): wi = -dir, travel to scene boundary
    wi_dir = -ldir
    p_dir = ref_p + wi_dir * scene_diam

    # --- point (delta): Li = I / d^2
    to_p = lpos - ref_p
    d2_p = jnp.maximum(m.length_sq(to_p), 1e-12)
    wi_pt = to_p * jax.lax.rsqrt(d2_p)[..., None]

    # --- disk area: concentric sample in the disk plane
    t_disk, b_disk = m.build_orthonormal_basis(ldir)
    dxy = smp.concentric_disk(u2) * lrad[..., None]
    p_disk = lpos + t_disk * dxy[..., 0:1] + b_disk * dxy[..., 1:2]

    # --- mesh area
    p_mesh, n_mesh, _ = _sample_mesh_point(scene, light_idx, u2)

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    is_disk = ltype == LIGHT_DISK
    is_mesh = ltype == LIGHT_MESH
    is_delta = is_dir | is_pt
    is_area = is_disk | is_mesh

    p = jnp.where(
        is_dir[..., None], p_dir,
        jnp.where(is_pt[..., None], lpos, jnp.where(is_disk[..., None], p_disk, p_mesh)),
    )
    n = jnp.where(is_mesh[..., None], n_mesh, ldir)  # disk normal = direction

    to_l = p - ref_p
    d2 = jnp.maximum(m.length_sq(to_l), 1e-12)
    dist = jnp.sqrt(d2)
    wi = jnp.where(is_dir[..., None], wi_dir, to_l / dist[..., None])

    # emission cosine at the light (area lights emit one-sided)
    cos_l = m.dot(n, -wi)
    front = cos_l > 1e-6

    li = jnp.where(
        is_dir[..., None], lint,
        jnp.where(
            is_pt[..., None], lint / d2[..., None],
            jnp.where(front[..., None], lint, 0.0),
        ),
    )
    # solid-angle pdf: delta -> 1; area -> d^2 / (cosθ_l * A)
    pdf_area = m.safe_div(jnp.ones_like(d2), larea)
    pdf = jnp.where(is_delta, 1.0, m.safe_div(d2 * pdf_area, jnp.abs(cos_l)))

    valid = (is_delta | (is_area & front)) & (pdf > 0.0)
    dist = jnp.where(is_dir, scene_diam, dist)
    return LightSample(
        li=jnp.where(valid[..., None], li, 0.0),
        wi=wi, pdf=jnp.where(valid, pdf, 0.0), dist=dist, p=p, n=n,
        is_delta=is_delta, valid=valid,
    )


def pdf_li(scene: Scene, light_idx: jax.Array, ref_p: jax.Array, wi: jax.Array,
           hit_p: jax.Array, hit_n: jax.Array) -> jax.Array:
    """Solid-angle pdf of sample_li producing direction wi that hits the light
    at hit_p with normal hit_n (area lights; deltas return 0 — unpickable by
    direction). Used by MIS and BDPT."""
    lights = scene.lights
    if lights.capacity == 0:
        return jnp.zeros(light_idx.shape, jnp.float32)
    ltype = jnp.take(lights.type, light_idx, axis=0, mode="clip")
    larea = jnp.take(lights.area, light_idx, axis=0, mode="clip")
    is_area = (ltype == LIGHT_DISK) | (ltype == LIGHT_MESH)
    d2 = m.distance_sq(ref_p, hit_p)
    cos_l = jnp.abs(m.dot(hit_n, -wi))
    pdf = m.safe_div(d2, cos_l * larea)
    return jnp.where(is_area, pdf, 0.0)


def eval_le(scene: Scene, light_idx: jax.Array, n: jax.Array, wo: jax.Array):
    """Emitted radiance of area light toward wo (``evalLightLe``,
    ``lights.cl:29-39``): one-sided."""
    if scene.lights.capacity == 0:
        return jnp.zeros(light_idx.shape + (3,), jnp.float32)
    lint = jnp.take(scene.lights.intensity, light_idx, axis=0, mode="clip")
    front = m.dot(n, wo) > 0.0
    ok = (light_idx >= 0) & front
    return jnp.where(ok[..., None], lint, 0.0)


class LeSample(PyTreeNode):
    """Emission sample for BDPT light subpaths (``sampleLightLe``)."""

    le: jax.Array  # (N, 3)
    p: jax.Array  # (N, 3) origin on light
    n: jax.Array  # (N, 3) light normal at origin
    d: jax.Array  # (N, 3) emitted direction
    pdf_pos: jax.Array  # (N,)
    pdf_dir: jax.Array  # (N,)
    is_delta_pos: jax.Array  # (N,) point lights
    is_delta_dir: jax.Array  # (N,) directional lights
    valid: jax.Array


def sample_le(scene: Scene, light_idx: jax.Array, u_pos: jax.Array,
              u_dir: jax.Array) -> LeSample:
    """Sample a ray leaving the light — ``sampleLightLe``
    (``lights.cl:148-224``). Cosine-hemisphere directions for area lights."""
    lights = scene.lights
    ltype = jnp.take(lights.type, light_idx, axis=0, mode="clip")
    lpos = jnp.take(lights.position, light_idx, axis=0, mode="clip")
    ldir = jnp.take(lights.direction, light_idx, axis=0, mode="clip")
    lint = jnp.take(lights.intensity, light_idx, axis=0, mode="clip")
    lrad = jnp.take(lights.radius, light_idx, axis=0, mode="clip")
    larea = jnp.take(lights.area, light_idx, axis=0, mode="clip")

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    is_disk = ltype == LIGHT_DISK
    is_mesh = ltype == LIGHT_MESH

    # positions
    t_d, b_d = m.build_orthonormal_basis(ldir)
    dxy = smp.concentric_disk(u_pos) * lrad[..., None]
    p_disk = lpos + t_d * dxy[..., 0:1] + b_d * dxy[..., 1:2]
    p_mesh, n_mesh, _ = _sample_mesh_point(scene, light_idx, u_pos)
    # directional: sample a disk of scene radius perpendicular to dir,
    # offset back outside the scene (PBRT-style)
    disk2 = smp.concentric_disk(u_pos) * scene.radius
    p_inf = scene.center + (t_d * disk2[..., 0:1] + b_d * disk2[..., 1:2]) - ldir * (2.0 * scene.radius)

    p = jnp.where(
        is_dir[..., None], p_inf,
        jnp.where(is_pt[..., None], lpos, jnp.where(is_disk[..., None], p_disk, p_mesh)),
    )
    n = jnp.where(is_mesh[..., None], n_mesh, ldir)

    # directions: point -> uniform sphere; area -> cosine hemisphere about n
    d_sph = smp.uniform_sphere(u_dir)
    local = smp.cosine_hemisphere(u_dir)  # y-up local frame, y = normal
    t_n, b_n = m.build_orthonormal_basis(n)
    d_cos = m.to_world(t_n, b_n, n, local)
    d = jnp.where(
        is_dir[..., None], ldir,
        jnp.where(is_pt[..., None], d_sph, d_cos),
    )

    cos_d = m.dot(n, d)
    pdf_pos = jnp.where(
        is_dir, m.safe_div(jnp.ones_like(larea), jnp.pi * scene.radius ** 2),
        jnp.where(is_pt, 1.0, m.safe_div(jnp.ones_like(larea), larea)),
    )
    pdf_dir = jnp.where(
        is_dir, 1.0,
        jnp.where(is_pt, smp.uniform_sphere_pdf(),
                  smp.cosine_hemisphere_pdf(cos_d)),
    )
    le = jnp.where(
        is_dir[..., None] | is_pt[..., None], lint,
        jnp.where((cos_d > 0.0)[..., None], lint, 0.0),
    )
    valid = (light_idx >= 0) & (pdf_pos > 0.0) & (pdf_dir > 0.0)
    return LeSample(
        le=le, p=p, n=n, d=d, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
        is_delta_pos=is_pt, is_delta_dir=is_dir, valid=valid,
    )


def pdf_le(scene: Scene, light_idx: jax.Array, n: jax.Array, d: jax.Array):
    """(pdf_pos, pdf_dir) of sample_le for an emitted ray (p, d) —
    ``evalLightPdfLe`` (``lights.cl:226-252``).

    These are the MIS-evaluation densities, which zero the delta components
    exactly as the reference does: directional lights have pdf_dir = 0 (a
    connection can never re-generate the fixed direction) and point lights
    have pdf_pos = 0; ``remap0`` in the BDPT ratio walk turns those into 1.
    The *sampling* densities used for throughput live in ``sample_le``."""
    lights = scene.lights
    ltype = jnp.take(lights.type, light_idx, axis=0, mode="clip")
    larea = jnp.take(lights.area, light_idx, axis=0, mode="clip")
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    cos_d = m.dot(n, d)
    pdf_pos = jnp.where(
        is_dir, m.safe_div(jnp.ones_like(larea), jnp.pi * scene.radius ** 2),
        jnp.where(is_pt, 0.0, m.safe_div(jnp.ones_like(larea), larea)),
    )
    pdf_dir = jnp.where(
        is_dir, 0.0,
        jnp.where(is_pt, smp.uniform_sphere_pdf(), smp.cosine_hemisphere_pdf(cos_d)),
    )
    return pdf_pos, pdf_dir
