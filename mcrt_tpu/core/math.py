"""Vector / geometry math helpers (pure jnp).

Analogue of the reference's device math utilities
(``assets/kernels/math.cl``, ``matrix.cl``): spherical directions, orthonormal
bases, corner-ray interpolation, 2x2 linear solve.  Everything here is
vectorized over a leading batch axis and branch-free.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-6
F32_MAX = jnp.finfo(jnp.float32).max


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched dot product over the last axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def dot3(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched dot product over the last axis, keepdims=True (broadcasts against vec3)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def length(v: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def length_sq(v: jax.Array) -> jax.Array:
    return jnp.sum(v * v, axis=-1)


def normalize(v: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Safe normalize: returns v/|v|; zero vectors stay finite."""
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def lerp(a: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    return a + (b - a) * t


def lerp_direction(c00, c10, c01, c11, uv):
    """Bilinear interpolation of 4 frustum corner directions, normalized.

    Mirrors the reference camera parametrization (``math.cl`` lerpDirection used
    by ``PathTracing.cl:22-33``): a pinhole camera is stored as its 4 corner
    rays; per-pixel directions are the normalized bilerp at the pixel's uv.
    """
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    bottom = lerp(c00, c10, u)
    top = lerp(c01, c11, u)
    return normalize(lerp(bottom, top, v))


def reflect(wo: jax.Array, n: jax.Array) -> jax.Array:
    """Mirror reflection of wo about n (both pointing away from surface)."""
    return -wo + 2.0 * dot3(wo, n) * n


def faceforward(n: jax.Array, v: jax.Array) -> jax.Array:
    """Flip n to lie in the same hemisphere as v."""
    return jnp.where(dot3(n, v) < 0.0, -n, n)


def orthogonal_vector(v: jax.Array) -> jax.Array:
    """A unit vector orthogonal to v (branch-free Hughes-Moller style pick).

    Analogue of the reference's ``computeOrthogonalVector`` (``math.cl``).
    """
    ax = jnp.abs(v[..., 0:1])
    ay = jnp.abs(v[..., 1:2])
    az = jnp.abs(v[..., 2:3])
    # pick the axis of smallest magnitude to cross with
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    zeros = jnp.zeros_like(v[..., 0])
    ones = jnp.ones_like(v[..., 0])
    axis = jnp.where(
        use_x,
        jnp.stack([ones, zeros, zeros], -1),
        jnp.where(use_y, jnp.stack([zeros, ones, zeros], -1), jnp.stack([zeros, zeros, ones], -1)),
    )
    return normalize(jnp.cross(v, axis))


def build_orthonormal_basis(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branch-free ONB from a unit normal (Duff et al. 2017, public method).

    Returns (t, b) with [t, b, n] right-handed orthonormal.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def spherical_direction(sin_theta, cos_theta, phi):
    """Direction from spherical coords in a local y-up frame — the reference's
    shading space is y-up (``bxdfs.cl:22-59``)."""
    return jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )


def to_local(t: jax.Array, b: jax.Array, n: jax.Array, v: jax.Array) -> jax.Array:
    """World -> shading space. Shading space is y-up: local = (t·v, n·v, b·v)."""
    return jnp.stack([dot(t, v), dot(n, v), dot(b, v)], axis=-1)


def to_world(t: jax.Array, b: jax.Array, n: jax.Array, v: jax.Array) -> jax.Array:
    """Shading space (y-up) -> world."""
    return (
        v[..., 0:1] * t + v[..., 1:2] * n + v[..., 2:3] * b
    )


def solve_2x2(a00, a01, a10, a11, b0, b1):
    """Batched 2x2 linear solve; returns (x0, x1, ok).

    Analogue of ``solveLinearSystem2x2`` (``geometry.cl``) used for ray
    differential uv-footprint computation.
    """
    det = a00 * a11 - a01 * a10
    ok = jnp.abs(det) >= 1e-10
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    x0 = (a11 * b0 - a01 * b1) * inv_det
    x1 = (a00 * b1 - a10 * b0) * inv_det
    return x0, x1, ok


def transform_point(m: jax.Array, p: jax.Array) -> jax.Array:
    """Apply a 4x4 (or batched) transform to points (..., 3)."""
    ph = p @ m[..., :3, :3].swapaxes(-1, -2) + m[..., :3, 3]
    return ph


def transform_vector(m: jax.Array, v: jax.Array) -> jax.Array:
    return v @ m[..., :3, :3].swapaxes(-1, -2)


def transform_normal(m_inv: jax.Array, n: jax.Array) -> jax.Array:
    """Normals transform by the inverse-transpose."""
    return n @ m_inv[..., :3, :3]


def luminance(rgb: jax.Array) -> jax.Array:
    """Rec.709 luminance — matches the reference's ``colors.cl`` weights."""
    w = jnp.asarray([0.2126, 0.7152, 0.0722], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def is_black(rgb: jax.Array) -> jax.Array:
    return jnp.all(rgb == 0.0, axis=-1)


def safe_div(a: jax.Array, b: jax.Array, eps: float = 0.0) -> jax.Array:
    """a/b with 0 where |b| is (near-)zero."""
    ok = jnp.abs(b) > eps
    return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)


def safe_sqrt(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.maximum(x, 0.0))


def distance_sq(a: jax.Array, b: jax.Array) -> jax.Array:
    d = a - b
    return jnp.sum(d * d, axis=-1)
