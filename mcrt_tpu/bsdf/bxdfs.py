"""BxDF lobe library (shading space, y-up), fully vectorized and branch-free.

Re-implementation of the *math* of ``assets/kernels/bxdfs.cl``:
shading-space trig (:22-59), Fresnel dielectric/conductor/Schlick (:154-220),
specular reflection/transmission (:259-307), Lambertian (:317-347),
Oren-Nayar (:352-383), roughness->alpha (:385-390), Beckmann and
Trowbridge-Reitz microfacet distributions D/Λ/G (:395-474), Torrance-Sparrow
reflection/transmission (:481-588), and the wh samplers (:611-790).

Every function maps (..., ) lane batches; there is no per-lane control flow —
invalid configurations produce zeros via masks, which is how the uber-BSDF
(``uber.py``) composes lobes without divergence.

Shading space convention (matches the reference): the shading normal is +y;
``cos_theta(w) == w[..., 1]``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m

INV_PI = 1.0 / jnp.pi


# ---------------------------------------------------------------------------
# shading-space trig (bxdfs.cl:22-59)
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 1]


def abs_cos_theta(w):
    return jnp.abs(w[..., 1])


TROWBRIDGE_REITZ = 0
BECKMANN = 1


def cos2_theta(w):
    return w[..., 1] * w[..., 1]


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def _dsqrt(x, eps: float = 1e-18):
    """sqrt with a bounded derivative at 0.  sqrt'(0) = inf poisons reverse
    mode even under jnp.where masking (0-cotangent x inf-partial = NaN); the
    eps shifts the value by <= 1e-9 and caps the derivative."""
    return jnp.sqrt(jnp.maximum(x, eps))


def sin_theta(w):
    return _dsqrt(sin2_theta(w))


def tan_theta(w):
    return m.safe_div(sin_theta(w), cos_theta(w))


def tan2_theta(w):
    return m.safe_div(sin2_theta(w), cos2_theta(w))


def cos_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.where(s == 0.0, 1.0, s), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 0.0, jnp.clip(w[..., 2] / jnp.where(s == 0.0, 1.0, s), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 1] * wp[..., 1] > 0.0


def reflect_local(wo):
    """Mirror about the +y shading normal."""
    return jnp.stack([-wo[..., 0], wo[..., 1], -wo[..., 2]], axis=-1)


def refract_local(wo, eta_i_over_t):
    """Refract wo about ±y; returns (wi, total_internal_reflection_mask).

    eta_i_over_t = eta_incident / eta_transmitted for the actual orientation.
    """
    cos_i = cos_theta(wo)
    n_y = jnp.where(cos_i >= 0.0, 1.0, -1.0)
    cos_i_abs = jnp.abs(cos_i)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i_abs * cos_i_abs)
    sin2_t = eta_i_over_t * eta_i_over_t * sin2_i
    tir = sin2_t >= 1.0
    cos_t = _dsqrt(1.0 - sin2_t)
    # wi = -eta*wo + (eta*cosi - cost) * n
    wi = -eta_i_over_t[..., None] * wo + (
        (eta_i_over_t * cos_i_abs - cos_t) * n_y
    )[..., None] * jnp.stack(
        [jnp.zeros_like(n_y), jnp.ones_like(n_y), jnp.zeros_like(n_y)], -1
    )
    return m.normalize(wi), tir


# ---------------------------------------------------------------------------
# Fresnel (bxdfs.cl:154-220)
# ---------------------------------------------------------------------------

def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact dielectric Fresnel. cos_theta_i may be signed: negative means the
    ray is inside the medium, in which case the etas swap (bxdfs.cl:154-186)."""
    entering = cos_theta_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(jnp.clip(cos_theta_i, -1.0, 1.0))
    sin_i = _dsqrt(1.0 - ci * ci)
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = _dsqrt(1.0 - sin_t * sin_t)
    r_parl = m.safe_div(et * ci - ei * ct, et * ci + ei * ct)
    r_perp = m.safe_div(ei * ci - et * ct, ei * ci + et * ct)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return jnp.where(tir, 1.0, f)


def fresnel_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel (per-channel eta/k, (..., 3)) — bxdfs.cl:188-207."""
    ci = jnp.clip(jnp.abs(cos_theta_i), 0.0, 1.0)[..., None]
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = _dsqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + cos2
    a = _dsqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = m.safe_div(t1 - t2, t1 + t2)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * m.safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, f0):
    c = jnp.clip(1.0 - jnp.abs(cos_theta_i), 0.0, 1.0)
    return f0 + (1.0 - f0) * (c ** 5)[..., None]


# ---------------------------------------------------------------------------
# Lambertian + Oren-Nayar (bxdfs.cl:317-383)
# ---------------------------------------------------------------------------

def lambertian_f(albedo):
    return albedo * INV_PI


def fresnel_blend_f(rd, rs, alpha, wo, wi, dist: int = TROWBRIDGE_REITZ):
    """Ashikhmin-Shirley coupled diffuse + Schlick-Fresnel specular blend
    (``evaluateFresnelBlend``, bxdfs.cl:590-605)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = (ci > 0) & (co > 0) & (wh_len > 1e-12) & same_hemisphere(wo, wi)
    wh_n = wh * m.safe_div(jnp.ones_like(wh_len), wh_len)[..., None]
    diff = (
        (28.0 / (23.0 * jnp.pi)) * rd * (1.0 - rs)
        * ((1.0 - (1.0 - 0.5 * ci) ** 5) * (1.0 - (1.0 - 0.5 * co) ** 5))[..., None]
    )
    d = mf_d(wh_n, alpha, dist)
    denom = 4.0 * jnp.abs(m.dot(wi, wh_n)) * jnp.maximum(ci, co)
    spec = m.safe_div(d, denom)[..., None] * fresnel_schlick(
        m.dot(wi, wh_n), rs
    )
    return jnp.where(ok[..., None], diff + spec, 0.0)


def oren_nayar_f(albedo, sigma_deg, wo, wi):
    """Oren-Nayar (bxdfs.cl:352-383); sigma in degrees like the reference."""
    sigma = jnp.deg2rad(sigma_deg)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    cos_diff = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = jnp.maximum(0.0, cos_diff)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    sin_a = jnp.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_b = jnp.where(
        abs_ci > abs_co, m.safe_div(sin_ti, abs_ci), m.safe_div(sin_to, abs_co)
    )
    return albedo * (INV_PI * (a + b * max_cos * sin_a * tan_b))[..., None]


def roughness_to_alpha(roughness):
    """PBRT-style remap (bxdfs.cl:385-390)."""
    r = jnp.maximum(roughness, 1e-3)
    x = jnp.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4


# ---------------------------------------------------------------------------
# Microfacet distributions (bxdfs.cl:395-474). Isotropic alpha.
# ---------------------------------------------------------------------------


def tr_d(wh, alpha):
    """Trowbridge-Reitz (GGX) NDF."""
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    a2 = alpha * alpha
    e = t2 / a2
    denom = jnp.pi * a2 * c4 * (1.0 + e) ** 2
    d = m.safe_div(jnp.ones_like(denom), denom)
    return jnp.where(jnp.isfinite(t2), d, 0.0)


def tr_lambda(w, alpha):
    t = jnp.abs(tan_theta(w))
    a2t2 = (alpha * t) ** 2
    lam = 0.5 * (-1.0 + jnp.sqrt(1.0 + a2t2))
    return jnp.where(jnp.isfinite(t), lam, 0.0)


def beckmann_d(wh, alpha):
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    a2 = alpha * alpha
    d = m.safe_div(jnp.exp(-t2 / a2), jnp.pi * a2 * c4)
    return jnp.where(jnp.isfinite(t2), d, 0.0)


def beckmann_lambda(w, alpha):
    t = jnp.abs(tan_theta(w))
    a = m.safe_div(jnp.ones_like(t), alpha * t)
    lam = jnp.where(
        a >= 1.6,
        0.0,
        m.safe_div(1.0 - 1.259 * a + 0.396 * a * a, 3.535 * a + 2.181 * a * a),
    )
    return jnp.where(jnp.isfinite(t), lam, 0.0)


def mf_d(wh, alpha, dist: int = TROWBRIDGE_REITZ):
    return tr_d(wh, alpha) if dist == TROWBRIDGE_REITZ else beckmann_d(wh, alpha)


def mf_lambda(w, alpha, dist: int = TROWBRIDGE_REITZ):
    return tr_lambda(w, alpha) if dist == TROWBRIDGE_REITZ else beckmann_lambda(w, alpha)


def mf_g1(w, alpha, dist: int = TROWBRIDGE_REITZ):
    return 1.0 / (1.0 + mf_lambda(w, alpha, dist))


def mf_g(wo, wi, alpha, dist: int = TROWBRIDGE_REITZ):
    return 1.0 / (1.0 + mf_lambda(wo, alpha, dist) + mf_lambda(wi, alpha, dist))


def mf_sample_wh(wo, u2, alpha, dist: int = TROWBRIDGE_REITZ):
    """Sample the full NDF (not VNDF) like the reference (bxdfs.cl:611-729)."""
    if dist == TROWBRIDGE_REITZ:
        phi = 2.0 * jnp.pi * u2[..., 1]
        t2 = alpha * alpha * m.safe_div(u2[..., 0], 1.0 - u2[..., 0])
        ct = 1.0 / jnp.sqrt(1.0 + t2)
    else:
        phi = 2.0 * jnp.pi * u2[..., 1]
        log_s = jnp.log(jnp.maximum(1.0 - u2[..., 0], 1e-20))
        t2 = -alpha * alpha * log_s
        ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    wh = m.spherical_direction(st, ct, phi)
    # flip into wo's hemisphere
    return jnp.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def mf_pdf_wh(wo, wh, alpha, dist: int = TROWBRIDGE_REITZ):
    """pdf of sample_wh in the half-vector measure: D(wh)|cosθ_h|."""
    return mf_d(wh, alpha, dist) * abs_cos_theta(wh)


# ---------------------------------------------------------------------------
# Torrance-Sparrow microfacet reflection / transmission (bxdfs.cl:481-588)
# ---------------------------------------------------------------------------

def microfacet_reflection_f(r, alpha, eta_a, eta_b, wo, wi, dist: int = TROWBRIDGE_REITZ):
    """Torrance-Sparrow reflection with dielectric Fresnel; returns (..., 3)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = (ci > 0) & (co > 0) & (wh_len > 1e-12) & same_hemisphere(wo, wi)
    wh_n = wh * m.safe_div(jnp.ones_like(wh_len), wh_len)[..., None]
    # Fresnel at the half-vector, oriented toward +y for the eta order
    f_cos = m.dot(wi, jnp.where(wh_n[..., 1:2] < 0.0, -wh_n, wh_n))
    fr = fresnel_dielectric(f_cos, eta_a, eta_b)
    val = (
        mf_d(wh_n, alpha, dist) * mf_g(wo, wi, alpha, dist) * fr
    ) * m.safe_div(jnp.ones_like(ci), 4.0 * ci * co)
    return jnp.where(ok[..., None], r * val[..., None], 0.0)


def microfacet_reflection_pdf(wo, wi, alpha, dist: int = TROWBRIDGE_REITZ):
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = same_hemisphere(wo, wi) & (wh_len > 1e-12)
    wh_n = wh * m.safe_div(jnp.ones_like(wh_len), wh_len)[..., None]
    pdf = m.safe_div(mf_pdf_wh(wo, wh_n, alpha, dist), 4.0 * jnp.abs(m.dot(wo, wh_n)))
    return jnp.where(ok, pdf, 0.0)


def microfacet_transmission_f(t_col, alpha, eta_a, eta_b, wo, wi,
                              radiance_mode: bool = True,
                              dist: int = TROWBRIDGE_REITZ):
    """Rough dielectric transmission (bxdfs.cl:558-588)."""
    ci = cos_theta(wi)
    co = cos_theta(wo)
    ok = (ci * co < 0.0) & (jnp.abs(ci) > 1e-8) & (jnp.abs(co) > 1e-8)
    eta = jnp.where(co > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = m.normalize(wo + wi * eta[..., None])
    wh = jnp.where(wh[..., 1:2] < 0.0, -wh, wh)
    sq_denom = m.dot(wo, wh) + eta * m.dot(wi, wh)
    fr = fresnel_dielectric(m.dot(wo, wh), eta_a, eta_b)
    factor = jnp.where(radiance_mode, 1.0 / eta, jnp.ones_like(eta))
    val = (
        (1.0 - fr)
        * mf_d(wh, alpha, dist)
        * mf_g(wo, wi, alpha, dist)
        * jnp.abs(
            m.safe_div(
                eta * eta * jnp.abs(m.dot(wi, wh)) * jnp.abs(m.dot(wo, wh)) * factor * factor,
                ci * co * sq_denom * sq_denom,
            )
        )
    )
    return jnp.where(ok[..., None], t_col * val[..., None], 0.0)


def microfacet_transmission_pdf(wo, wi, alpha, eta_a, eta_b,
                                dist: int = TROWBRIDGE_REITZ):
    ci = cos_theta(wi)
    co = cos_theta(wo)
    ok = ci * co < 0.0
    eta = jnp.where(co > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = m.normalize(wo + wi * eta[..., None])
    sq_denom = m.dot(wo, wh) + eta * m.dot(wi, wh)
    dwh_dwi = jnp.abs(m.safe_div(eta * eta * m.dot(wi, wh), sq_denom * sq_denom))
    pdf = mf_pdf_wh(wo, wh, alpha, dist) * dwh_dwi
    return jnp.where(ok, pdf, 0.0)
