"""Acceleration-structure registry.

Role of the reference's strategy selection (``calc_intersection_device.cpp``
mapping ``acc.type`` options to intersector instances, :73-150): a config
enum picks the builder + traversal pair; every pair exposes the same
(closest-hit, any-hit) query API as ``IntersectionApi``
(``radeon_rays.h:267-277``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax

from ..config import AccelType, BVHConfig, RenderConfig
from ..core.types import Hit, Rays
from ..scene.scene import Scene
from .brute import intersect_brute, occluded_brute

# AUTO sends scenes of at most this many faces to the brute oracle and
# larger ones to the blocked engine.  On an H100 at 262,144 primary rays the
# brute oracle won at 1,280 faces and the blocked engine at 5,120 (PERF.md).
BRUTE_MAX_FACES = 4096


class Intersector(NamedTuple):
    """Bound query functions: (scene, rays) -> Hit / blocked mask."""

    intersect: Callable[[Scene, Rays], Hit]
    occluded: Callable[[Scene, Rays], jax.Array]
    accel: object  # accel pytree (donated into jit along with the scene)


def blocked_intersector(acc, sort: bool | None = None) -> Intersector:
    """Bind blocked-accel query closures around an accel pytree.  The accel
    may be a build-time constant OR a traced value (e.g. the output of
    ``refit_blocked`` inside a fused animate+render program)."""
    from .pallas_blocked import intersect_blocked, occluded_blocked

    if sort is None:
        # the per-query ray coherence sort only pays off when culling can
        # actually skip blocks; for near-single-block scenes it is pure
        # overhead (2 argsorts + 4 permutation gathers per bounce)
        sort = acc.num_blocks >= 8
    return Intersector(
        intersect=lambda s, r: intersect_blocked(s.geometry, acc, r,
                                                 sort=sort),
        occluded=lambda s, r: occluded_blocked(s.geometry, acc, r,
                                               sort=sort),
        accel=acc,
    )


def two_level_intersector(acc) -> Intersector:
    """Bind pair-list two-level query closures (instanced scenes)."""
    from .two_level import intersect_two_level, occluded_two_level

    return Intersector(
        intersect=lambda s, r: intersect_two_level(s.geometry, acc, r),
        occluded=lambda s, r: occluded_two_level(s.geometry, acc, r),
        accel=acc,
    )


def build_intersector(scene: Scene, cfg: RenderConfig) -> Intersector:
    """Build the accel for `scene` and bind query closures — the analogue of
    ``IntersectionApi::Commit`` (``radeon_rays.h:231-241``)."""
    accel_type = cfg.accel
    if scene.instances is not None:
        # instanced scenes REQUIRE the two-level engine: every other accel
        # sees only the source meshes' object-space faces.  AUTO selects it
        # from world content exactly like the reference's device preprocess
        # (calc_intersection_device.cpp:73-150 picks the 2-level intersector
        # when the world carries instances).
        if accel_type not in (AccelType.AUTO, AccelType.TWO_LEVEL):
            raise ValueError(
                f"scene has instanced shapes; accel={accel_type.value!r} "
                "cannot render them — use AccelType.AUTO or TWO_LEVEL")
        from .two_level import build_two_level_scene

        acc = build_two_level_scene(
            scene.geometry, scene.shapes.to_world, scene.instances, cfg.bvh)
        return two_level_intersector(acc)
    if accel_type == AccelType.TWO_LEVEL:
        # no instances: the whole scene is one free BLAS under an identity
        # instance — valid, just not faster than BLOCKED
        from ..scene.scene import Instances
        import jax.numpy as jnp

        from .two_level import build_two_level_scene

        empty = Instances(shape=jnp.zeros((0,), jnp.int32),
                          src_shape=jnp.zeros((0,), jnp.int32))
        acc = build_two_level_scene(
            scene.geometry, scene.shapes.to_world, empty, cfg.bvh)
        return two_level_intersector(acc)
    if accel_type == AccelType.AUTO:
        # strategy selection by scene size alone (the reference picks
        # intersectors from scene shape at Preprocess,
        # calc_intersection_device.cpp:73-150)
        accel_type = (AccelType.BRUTE
                      if scene.geometry.num_faces <= BRUTE_MAX_FACES
                      else AccelType.BLOCKED)
    if accel_type == AccelType.BRUTE:
        return Intersector(
            intersect=lambda s, r: intersect_brute(s.geometry, r),
            occluded=lambda s, r: occluded_brute(s.geometry, r),
            accel=None,
        )
    if accel_type == AccelType.BLOCKED:
        from .pallas_blocked import build_blocked

        acc = build_blocked(scene.geometry, cfg.bvh)
        return blocked_intersector(acc)
    if accel_type == AccelType.LBVH:
        from .lbvh import build_lbvh
        from .traverse import intersect_bvh, occluded_bvh

        bvh = build_lbvh(scene.geometry, cfg.bvh)
        return Intersector(
            intersect=lambda s, r: intersect_bvh(s.geometry, bvh, r, cfg.bvh),
            occluded=lambda s, r: occluded_bvh(s.geometry, bvh, r, cfg.bvh),
            accel=bvh,
        )
    raise ValueError(f"unknown accel {cfg.accel}")
