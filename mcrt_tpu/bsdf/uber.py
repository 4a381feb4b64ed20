"""Uber-BSDF: masked lobe mixture (eval / pdf / sample).

Re-formulation of the reference's uber material
(``evaluateUberBSDF`` ``bxdfs.cl:804-827``, ``evaluateUberBSDF_Pdf``
:829-880, ``sampleUberBSDF`` :892-1053): up to five lobes

  0. Lambertian reflection       (diffuse)
  1. Torrance-Sparrow reflection (glossy, Trowbridge-Reitz or Beckmann)
  2. specular reflection         (kr, dielectric Fresnel)
  3. specular transmission       (kt, radiance-mode eta^2 factor)
  4. opacity pass-through        ((1-opacity) as straight-through specular
                                  transmission, bxdfs.cl:1019-1035)

Where the reference dispatches per-thread on lobe flags, we evaluate *all*
lobes on every lane and mask — uniform control flow, no divergence.  Lobe selection during sampling follows the reference:
uniform choice among present lobes with u.x remapped back to [0,1)
(``bxdfs.cl:956-959``); the returned pdf is the lobe-count-averaged mixture
pdf over matching non-delta lobes (specular lobes contribute their discrete
1/num weight only), so throughput f·cos/pdf is unbiased.

Differentiability: sampling *decisions* (lobe choice, wh, directions) are made
on stop-gradient inputs downstream (see ``diff/``); eval is smooth in all
material parameters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core.pytree import PyTreeNode, field

from ..core import math as m
from ..sampling import samplers as smp
from . import bxdfs as bx

N_LOBES = 5
LOBE_DIFFUSE = 0
LOBE_GLOSSY = 1
LOBE_SPEC_REFL = 2
LOBE_SPEC_TRANS = 3
LOBE_PASSTHROUGH = 4
# indices into the STATIC scene-wide used-lobe mask (Materials.used_lobes):
# the five lobes above plus the conductor-Fresnel and Fresnel-blend variants
U_COND = 5
U_BLEND = 6


class UberBSDF(PyTreeNode):
    """Per-lane material properties after texture modulation
    (``getUberMaterialProperties``, ``materials.cl:67-91``)."""

    diffuse: jax.Array  # (N, 3)
    glossy: jax.Array  # (N, 3)
    kr: jax.Array  # (N, 3)
    kt: jax.Array  # (N, 3)
    passthrough: jax.Array  # (N, 3) = 1 - opacity
    alpha: jax.Array  # (N,) microfacet alpha (already remapped)
    eta: jax.Array  # (N,) interior IOR (exterior = 1)
    conductor_eta: jax.Array  # (N, 3) conductor Fresnel eta (kr lobe)
    conductor_k: jax.Array  # (N, 3) conductor absorption; any>0 => conductor
    rs_blend: jax.Array  # (N, 3) any>0 => Fresnel-blend replaces Lambertian
    dist: int = field(pytree_node=False, default=bx.TROWBRIDGE_REITZ)
    # STATIC scene-wide lobe mask (see Materials.used_lobes): lobes absent
    # from EVERY material compile away from eval/pdf/sample entirely
    used: tuple = field(pytree_node=False, default=(True,) * 7)

    def is_fresnel_blend(self):
        return jnp.any(self.rs_blend > 0.0, -1)

    def is_conductor(self):
        return jnp.any(self.conductor_k > 0.0, -1)

    def lobe_masks(self):
        """(N, 5) bool — which lobes are present (isNotBlack per color).
        Lobe 0 covers both Lambertian and its Fresnel-blend replacement.
        Statically-unused lobes fold to constant False columns."""
        f = jnp.zeros(self.alpha.shape, bool)
        u = self.used
        return jnp.stack(
            [
                jnp.any(self.diffuse > 0.0, -1) if u[LOBE_DIFFUSE] else f,
                jnp.any(self.glossy > 0.0, -1) if u[LOBE_GLOSSY] else f,
                jnp.any(self.kr > 0.0, -1) if u[LOBE_SPEC_REFL] else f,
                jnp.any(self.kt > 0.0, -1) if u[LOBE_SPEC_TRANS] else f,
                jnp.any(self.passthrough > 0.0, -1) if u[LOBE_PASSTHROUGH]
                else f,
            ],
            axis=-1,
        )

    def num_lobes(self):
        return jnp.sum(self.lobe_masks().astype(jnp.int32), axis=-1)

    def has_non_delta(self):
        msk = self.lobe_masks()
        return msk[..., LOBE_DIFFUSE] | msk[..., LOBE_GLOSSY]

    def is_pure_specular(self):
        return ~self.has_non_delta() & (self.num_lobes() > 0)


class BSDFSample(PyTreeNode):
    wi: jax.Array  # (N, 3) local (shading space)
    f: jax.Array  # (N, 3)
    pdf: jax.Array  # (N,)
    is_specular: jax.Array  # (N,) sampled lobe was delta
    is_transmission: jax.Array  # (N,) wi crosses the surface
    valid: jax.Array  # (N,)


def _eta_for(wo_y, eta):
    """(eta_i, eta_t) ordered by which side wo is on (exterior IOR 1)."""
    ones = jnp.ones_like(eta)
    entering = wo_y > 0.0
    return jnp.where(entering, ones, eta), jnp.where(entering, eta, ones)


def evaluate(bsdf: UberBSDF, wo: jax.Array, wi: jax.Array) -> jax.Array:
    """Sum of non-delta lobes (``evaluateUberBSDF``, bxdfs.cl:804-827).
    Reflection-only: the uber material's non-delta transmission is zero."""
    refl = bx.same_hemisphere(wo, wi)
    zero3 = jnp.zeros_like(bsdf.diffuse)
    if bsdf.used[LOBE_DIFFUSE]:
        f_diff = bx.lambertian_f(bsdf.diffuse)
        if bsdf.used[U_BLEND]:
            f_blend = bx.fresnel_blend_f(
                bsdf.diffuse, bsdf.rs_blend, bsdf.alpha, wo, wi, bsdf.dist
            )
            fb = bsdf.is_fresnel_blend()
            f_diff = jnp.where(fb[..., None], f_blend, f_diff)
    else:
        f_diff = zero3
    f_gloss = (bx.microfacet_reflection_f(
        bsdf.glossy, bsdf.alpha, jnp.ones_like(bsdf.eta), bsdf.eta, wo, wi,
        bsdf.dist) if bsdf.used[LOBE_GLOSSY] else zero3)
    msk = bsdf.lobe_masks()
    f = (
        jnp.where(msk[..., LOBE_DIFFUSE, None], f_diff, 0.0)
        + jnp.where(msk[..., LOBE_GLOSSY, None], f_gloss, 0.0)
    )
    return jnp.where(refl[..., None], f, 0.0)


def pdf(bsdf: UberBSDF, wo: jax.Array, wi: jax.Array) -> jax.Array:
    """Mixture pdf averaged over all present lobes; delta lobes contribute 0
    (``evaluateUberBSDF_Pdf``, bxdfs.cl:829-880)."""
    msk = bsdf.lobe_masks()
    num = jnp.maximum(bsdf.num_lobes(), 1).astype(jnp.float32)
    refl = bx.same_hemisphere(wo, wi)
    zero = jnp.zeros_like(bsdf.alpha)
    p_diff = (smp.cosine_hemisphere_pdf(bx.cos_theta(wi))
              if bsdf.used[LOBE_DIFFUSE] else zero)
    p_gloss = (bx.microfacet_reflection_pdf(wo, wi, bsdf.alpha, bsdf.dist)
               if bsdf.used[LOBE_GLOSSY] else zero)
    p = (
        jnp.where(msk[..., LOBE_DIFFUSE] & refl, p_diff, 0.0)
        + jnp.where(msk[..., LOBE_GLOSSY] & refl, p_gloss, 0.0)
    )
    return p / num


def sample(bsdf: UberBSDF, wo: jax.Array, u3: jax.Array,
           detach: bool = True) -> BSDFSample:
    """Sample the lobe mixture (``sampleUberBSDF``, bxdfs.cl:892-1053).

    u3: (N, 3) uniforms — u3[...,0] picks the lobe (and is remapped), the
    rest drive the per-lobe direction sample.

    detach=True applies the *detached* differentiable-sampling estimator
    (Zeltner et al. 2021 style): the sampled direction and the non-delta
    mixture pdf are wrapped in stop_gradient so that only the smooth BSDF
    value f carries parameter gradients — the unbiased choice when
    differentiating w.r.t. material parameters through BSDF importance
    sampling (SURVEY §7 phase 7).  Delta-lobe weights (Fresnel, kr/kt) stay
    attached; gradients through *refraction directions* (eta) are dropped.
    """
    msk = bsdf.lobe_masks()
    num_i = bsdf.num_lobes()
    num = jnp.maximum(num_i, 1).astype(jnp.float32)

    # uniform pick among present lobes: c-th present lobe
    c = jnp.minimum((u3[..., 0] * num).astype(jnp.int32), num_i - 1)
    rank = jnp.cumsum(msk.astype(jnp.int32), axis=-1) - msk.astype(jnp.int32)
    chosen_onehot = msk & (rank == c[..., None])  # (N, 5)
    lobe = jnp.argmax(chosen_onehot, axis=-1)  # (N,)
    # remap u.x to [0,1) within the chosen slot (bxdfs.cl:956-959)
    u0 = u3[..., 0] * num - c.astype(jnp.float32)
    u2 = jnp.stack([u0, u3[..., 1]], axis=-1)
    # a third independent uniform for lobes that need 2 fresh dims
    u2b = jnp.stack([u3[..., 1], u3[..., 2]], axis=-1)

    eta_i, eta_t = _eta_for(bx.cos_theta(wo), bsdf.eta)
    u = bsdf.used
    zero3 = jnp.zeros_like(wo)

    # statically-unused lobes produce placeholder directions; the selects
    # below never pick them (their lobe_masks column is constant False)

    # --- lobe 0: Lambertian (cosine hemisphere in wo's hemisphere)
    if u[LOBE_DIFFUSE]:
        wi_d = smp.cosine_hemisphere(u2b)
        wi_d = jnp.where((bx.cos_theta(wo) < 0.0)[..., None],
                         wi_d * jnp.asarray([1.0, -1.0, 1.0]), wi_d)
    else:
        wi_d = zero3

    # --- lobe 1: microfacet reflection
    if u[LOBE_GLOSSY]:
        wh = bx.mf_sample_wh(wo, u2b, bsdf.alpha, bsdf.dist)
        wi_g = m.normalize(-wo + 2.0 * m.dot3(wo, wh) * wh)
        gloss_ok = bx.same_hemisphere(wo, wi_g)
    else:
        wi_g = zero3
        gloss_ok = jnp.zeros(wo.shape[:-1], bool)

    # --- lobe 2: perfect mirror
    wi_r = bx.reflect_local(wo) if u[LOBE_SPEC_REFL] else zero3

    # --- lobe 3: specular transmission
    if u[LOBE_SPEC_TRANS]:
        wi_t, tir = bx.refract_local(wo, eta_i / eta_t)
    else:
        wi_t = zero3
        tir = jnp.zeros(wo.shape[:-1], bool)

    # --- lobe 4: opacity pass-through
    wi_p = -wo

    wi = jnp.where(
        (lobe == LOBE_DIFFUSE)[..., None], wi_d,
        jnp.where(
            (lobe == LOBE_GLOSSY)[..., None], wi_g,
            jnp.where(
                (lobe == LOBE_SPEC_REFL)[..., None], wi_r,
                jnp.where((lobe == LOBE_SPEC_TRANS)[..., None], wi_t, wi_p),
            ),
        ),
    )
    if detach:
        wi = jax.lax.stop_gradient(wi)

    is_spec = (lobe == LOBE_SPEC_REFL) | (lobe == LOBE_SPEC_TRANS) | (lobe == LOBE_PASSTHROUGH)
    abs_ci = jnp.maximum(bx.abs_cos_theta(wi), 1e-8)

    # delta-lobe f values (f includes the 1/|cos| so that f*cos/pdf is exact).
    # fresnel_dielectric swaps etas internally on signed cos, so pass (1, eta).
    if u[LOBE_SPEC_REFL] or u[LOBE_SPEC_TRANS]:
        fr_r = bx.fresnel_dielectric(
            bx.cos_theta(wo), jnp.ones_like(bsdf.eta), bsdf.eta)
    else:
        fr_r = jnp.zeros_like(bsdf.eta)
    if u[LOBE_SPEC_REFL]:
        fr_r3 = fr_r[..., None]
        if u[U_COND]:
            # conductor Fresnel for metallic kr (per-channel; any k>0
            # switches — sampleSpecularReflection_Conductor,
            # bxdfs.cl:272-281)
            fr_cond = bx.fresnel_conductor(
                bx.cos_theta(wo), bsdf.conductor_eta, bsdf.conductor_k
            )
            fr_r3 = jnp.where(
                bsdf.is_conductor()[..., None], fr_cond, fr_r3
            )
        f_specr = bsdf.kr * fr_r3 / abs_ci[..., None]
    else:
        f_specr = zero3
    if u[LOBE_SPEC_TRANS]:
        # radiance-transport eta^2 scaling for transmission (bxdfs.cl:288-307)
        eta_scale = (eta_i / eta_t) ** 2
        f_spect = bsdf.kt * ((1.0 - fr_r) * eta_scale / abs_ci)[..., None]
        f_spect = jnp.where(tir[..., None], 0.0, f_spect)
    else:
        f_spect = zero3
    f_pass = (bsdf.passthrough / abs_ci[..., None]
              if u[LOBE_PASSTHROUGH] else zero3)

    # non-delta mixture f and pdf at the sampled wi; detached estimator
    # stops gradients through the pdf (f stays attached)
    f_nd = evaluate(bsdf, wo, wi)
    pdf_nd = pdf(bsdf, wo, wi)
    if detach:
        pdf_nd = jax.lax.stop_gradient(pdf_nd)

    f = jnp.where(
        (lobe == LOBE_SPEC_REFL)[..., None], f_specr,
        jnp.where(
            (lobe == LOBE_SPEC_TRANS)[..., None], f_spect,
            jnp.where((lobe == LOBE_PASSTHROUGH)[..., None], f_pass, f_nd),
        ),
    )
    pdf_out = jnp.where(is_spec, 1.0 / num, pdf_nd)

    # validity: a glossy pick that refracted below the horizon, a TIR'd
    # transmission, a zero pdf, or an absent-lobe lane kills the path
    valid = (num_i > 0) & (pdf_out > 0.0)
    valid &= jnp.where(lobe == LOBE_GLOSSY, gloss_ok, True)
    valid &= jnp.where(lobe == LOBE_SPEC_TRANS, ~tir, True)

    is_trans = bx.cos_theta(wi) * bx.cos_theta(wo) < 0.0
    return BSDFSample(
        wi=wi,
        f=jnp.where(valid[..., None], f, 0.0),
        pdf=jnp.where(valid, pdf_out, 0.0),
        is_specular=is_spec,
        is_transmission=is_trans,
        valid=valid,
    )


def has_non_delta(bsdf: UberBSDF) -> jax.Array:
    """BDPT connectibility test (``hasMaterialNonDeltaComponents``,
    ``materials.cl:161-179``)."""
    return bsdf.has_non_delta()
