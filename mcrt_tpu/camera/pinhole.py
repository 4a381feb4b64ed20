"""Pinhole camera with frustum-corner-ray parametrization.

Analogue of ``RTPinholeCamera`` (``kernel_data.h:246-264``) and the
camera kernels: per-pixel directions are the normalized bilinear interpolation
of the 4 frustum corner directions (``PathTracing.cl:13-35``), and the BDPT
importance functions ``We``/``PdfWe``/``SampleWi`` follow ``cameras.cl:8-71``.
The corner rays are produced from a standard look-at + vertical FOV, matching
``RTUtil::screenToRay`` (``util/RTUtil.cpp:9-41``) with optional sub-pixel
jitter applied in uv space.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

from ..core import math as m


class PinholeCamera(PyTreeNode):
    position: jax.Array  # (3,)
    c00: jax.Array  # (3,) bottom-left corner dir (unit)
    c10: jax.Array  # (3,) bottom-right
    c01: jax.Array  # (3,) top-left
    c11: jax.Array  # (3,) top-right
    forward: jax.Array  # (3,) unit view dir
    # film physical description for importance transport (cameras.cl:8-32)
    area: jax.Array  # () film area on the z=1 plane
    tan_half_fov: jax.Array  # ()
    aspect: jax.Array  # () width/height
    # full frames for world<->camera mapping
    right: jax.Array  # (3,)
    up: jax.Array  # (3,)

    @classmethod
    def look_at(cls, eye, target, up=(0.0, 1.0, 0.0), fov_deg: float = 45.0,
                aspect: float = 1.0):
        eye = jnp.asarray(eye, jnp.float32)
        target = jnp.asarray(target, jnp.float32)
        up = jnp.asarray(up, jnp.float32)
        fwd = m.normalize(target - eye)
        right = m.normalize(jnp.cross(fwd, up))
        true_up = jnp.cross(right, fwd)
        t = jnp.tan(jnp.deg2rad(fov_deg) * 0.5)
        hx = t * aspect
        hy = t
        c00 = m.normalize(fwd - right * hx - true_up * hy)
        c10 = m.normalize(fwd + right * hx - true_up * hy)
        c01 = m.normalize(fwd - right * hx + true_up * hy)
        c11 = m.normalize(fwd + right * hx + true_up * hy)
        # film area at unit distance along forward: (2hx)*(2hy)
        area = 4.0 * hx * hy
        return cls(
            position=eye, c00=c00, c10=c10, c01=c01, c11=c11, forward=fwd,
            area=jnp.asarray(area, jnp.float32),
            tan_half_fov=jnp.asarray(t, jnp.float32),
            aspect=jnp.asarray(aspect, jnp.float32),
            right=right, up=true_up,
        )

    def generate_rays(self, uv: jax.Array):
        """Per-pixel camera rays from film uv in [0,1]^2 ((N,2)) —
        ``GeneratePerspectiveRays`` (``PathTracing.cl:13-35``)."""
        d = m.lerp_direction(self.c00, self.c10, self.c01, self.c11, uv)
        o = jnp.broadcast_to(self.position, d.shape)
        return o, d

    def generate_ray_differentials(self, uv: jax.Array, width: int,
                                   height: int):
        """Directions of the rays through the +1-pixel neighbors in x and y
        (``GeneratePerspectiveRays`` differential setup,
        ``PathTracing.cl:22-35``; stored as ``RTRayDifferentials``,
        ``kernel_data.h:266-272``)."""
        from ..core.types import RayDiff

        du = jnp.asarray([1.0 / width, 0.0], jnp.float32)
        dv = jnp.asarray([0.0, 1.0 / height], jnp.float32)
        dddx = m.lerp_direction(self.c00, self.c10, self.c01, self.c11, uv + du)
        dddy = m.lerp_direction(self.c00, self.c10, self.c01, self.c11, uv + dv)
        return RayDiff(dddx=dddx, dddy=dddy)

    # ------------------------------------------------------------------
    # Importance transport (BDPT t=1 strategies), cf. cameras.cl
    # ------------------------------------------------------------------

    def world_to_uv(self, d: jax.Array):
        """Project a world direction from the eye onto film uv; returns
        (uv, in_frustum)."""
        dz = m.dot(d, self.forward)
        ok = dz > 1e-6
        inv = jnp.where(ok, 1.0 / jnp.where(ok, dz, 1.0), 0.0)
        x = m.dot(d, self.right) * inv
        y = m.dot(d, self.up) * inv
        hx = self.tan_half_fov * self.aspect
        hy = self.tan_half_fov
        u = (x / hx) * 0.5 + 0.5
        v = (y / hy) * 0.5 + 0.5
        inside = ok & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        return jnp.stack([u, v], -1), inside

    def eval_we(self, d: jax.Array):
        """Importance We(d) for a ray leaving the eye in unit direction d —
        1/(A * cos^4θ) on the z=1 film plane restricted to the frustum
        (``evalPinholeCameraWe``, ``cameras.cl:8-32``).

        cos^4: one cos for the direction->film-plane Jacobian measure change
        (1/cos^3) times the camera-facing cosine.
        """
        _, inside = self.world_to_uv(d)
        cos_t = m.dot(d, self.forward)
        w = m.safe_div(jnp.ones_like(cos_t), self.area * cos_t ** 4)
        return jnp.where(inside, w, 0.0)

    def pdf_we(self, d: jax.Array):
        """(pdf_pos, pdf_dir) of emitting a ray in direction d
        (``evalPinholeCameraPdfWe``, ``cameras.cl:34-61``): pinhole ->
        pdf_pos is a delta (returned 1), pdf_dir = 1/(A cos^3θ)."""
        _, inside = self.world_to_uv(d)
        cos_t = m.dot(d, self.forward)
        pdf_dir = m.safe_div(jnp.ones_like(cos_t), self.area * cos_t ** 3)
        return jnp.ones_like(cos_t), jnp.where(inside, pdf_dir, 0.0)

    def sample_wi(self, ref_p: jax.Array):
        """Sample the (delta) direction from a scene point to the eye for the
        BDPT t=1 connection (``samplePinholeCameraWi``, ``cameras.cl:63-71``).

        Returns (wi, distance, We, pdf, uv, valid): pdf is 1/ d^2-converted
        delta pdf = dist^2 / cosθ (solid-angle measure at ref point).
        """
        to_cam = self.position - ref_p
        dist2 = m.length_sq(to_cam)
        dist = jnp.sqrt(dist2)
        wi = to_cam / jnp.maximum(dist[..., None], 1e-20)
        uv, inside = self.world_to_uv(-wi)
        we = self.eval_we(-wi)
        cos_t = m.dot(-wi, self.forward)
        pdf = m.safe_div(dist2, jnp.maximum(cos_t, 1e-8))
        return wi, dist, we, pdf, uv, inside


def pixel_uv(width: int, height: int, jitter: jax.Array | None = None):
    """uv at pixel centers (+ optional per-pixel jitter in pixel units),
    flattened row-major to (W*H, 2). v=0 is the bottom row."""
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    u, v = jnp.meshgrid(xs, ys, indexing="xy")
    uv = jnp.stack([u.reshape(-1), v.reshape(-1)], axis=-1)
    if jitter is not None:
        uv = uv + jitter / jnp.asarray([width, height], jnp.float32)
    return uv
