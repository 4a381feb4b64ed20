"""Device-mesh construction and canonical shardings.

The reference has no distributed layer at all (single OpenCL device, SURVEY
§2e); this module is new design.  The renderer's two data axes map onto a 2-D
``jax.sharding.Mesh``:

- ``"spp"`` — samples-per-pixel sharded across devices; the reference
  accumulates spp *temporally* (``reconstruction.cl:45-57``); here the same
  sum runs spatially across the mesh and XLA reduces it with ``psum``.
- ``"rays"`` — image tiles / flat ray batches sharded across devices, the
  renderer's data-parallel axis (the reference's ``Launch2D`` SIMT analogue).

Scene and BVH are replicated (``P()``); for San-Miguel-scale scenes the scene
axis is sharded instead (``shard_scene``) with ray ring exchange — see
``parallel/render.py``.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SPP_AXIS = "spp"
RAYS_AXIS = "rays"


def make_mesh(n_spp: int | None = None, n_rays: int | None = None,
              devices=None) -> Mesh:
    """Build an (spp, rays) mesh over the given (default: all) devices.

    With no explicit shape, all devices go to the rays axis — the right
    default for progressive rendering where spp accumulates over time.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_spp is None and n_rays is None:
        n_spp, n_rays = 1, n
    elif n_spp is None:
        n_spp = n // n_rays
    elif n_rays is None:
        n_rays = n // n_spp
    assert n_spp * n_rays == n, (n_spp, n_rays, n)
    return Mesh(devices.reshape(n_spp, n_rays), (SPP_AXIS, RAYS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def rays_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (flat pixel/ray) axis over the rays axis."""
    return NamedSharding(mesh, P(RAYS_AXIS, *([None] * (ndim - 1))))


def spp_rays_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Shard (S, N, ...) arrays over (spp, rays)."""
    return NamedSharding(mesh, P(SPP_AXIS, RAYS_AXIS, *([None] * (ndim - 2))))
