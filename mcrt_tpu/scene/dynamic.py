"""Dynamic scene updates — transforms, instances, accumulation reset.

Re-design of the reference's dynamic-update path (SURVEY §3.4):
``RTScene::updateDynamicEntities`` rewrites per-shape transforms, calls
``shape->SetTransform`` + ``IntersectionApi::Commit`` to refit the BVH, and
notifies the integrators to reset accumulation
(``source/.../raytracing/scene/RTScene.cpp:317-391``); instances of a shared
mesh come from ``IntersectionApi::CreateInstance``
(``RadeonRays/include/radeon_rays.h:214-227``, used by ``RTScene::attachMesh``,
``RTScene.cpp:564-678``).

The formulation is functional: a :class:`SceneAnimator` snapshots the
base (build-time) geometry, and :meth:`SceneAnimator.transformed` is a pure,
jittable map ``(S,4,4) transforms -> new Scene`` — a batched gather + matmul
over all vertices (MXU-friendly), followed by an in-jit refresh of mesh-light
areas/CDFs and the scene bounding sphere.  Because the whole update is a JAX
function, an animation step can fuse transform + accel rebuild + render into
one XLA program instead of the reference's host round-trips per frame.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

from .scene import LIGHT_MESH, Geometry, Lights, Scene, pack_face_attrs


def vertex_shape_ids(scene: Scene) -> jax.Array:
    """Derive the owning shape id per vertex ((V,) i32) from the face table.

    Vertices are never shared across shapes (``SceneBuffers.add_mesh``
    concatenates per-shape vertex blocks), so a scatter from faces is exact.
    """
    geom = scene.geometry
    v = geom.positions.shape[0]
    vs = jnp.zeros((v,), jnp.int32)
    fs = jnp.where(geom.face_valid, geom.face_shape, 0)
    for k in range(3):
        vs = vs.at[geom.indices[:, k]].max(jnp.where(geom.face_valid, fs, 0))
    return vs


def _tri_areas(positions: jax.Array, indices: jax.Array,
               tri_ids: jax.Array) -> jax.Array:
    idx = jnp.take(indices, tri_ids, axis=0, mode="clip")
    p0 = jnp.take(positions, idx[:, 0], axis=0, mode="clip")
    p1 = jnp.take(positions, idx[:, 1], axis=0, mode="clip")
    p2 = jnp.take(positions, idx[:, 2], axis=0, mode="clip")
    return 0.5 * jnp.linalg.norm(jnp.cross(p1 - p0, p2 - p0), axis=-1)


def _refresh_mesh_lights(lights: Lights, positions: jax.Array,
                         indices: jax.Array) -> Lights:
    """Recompute mesh-light areas + per-light area CDFs after a transform
    (the reference re-uploads lights after scene edits, RTScene.cpp:356-391)."""
    if lights.tri_index.shape[0] == 0:
        return lights
    areas = _tri_areas(positions, indices, lights.tri_index)  # (LT,)
    n_lights = lights.capacity
    total = jax.ops.segment_sum(areas, lights.tri_light, num_segments=n_lights)
    cum = jnp.cumsum(areas)
    prev = jnp.concatenate([jnp.zeros((1,), areas.dtype), jnp.cumsum(total)[:-1]])
    safe = jnp.maximum(total, 1e-20)
    cdf = (cum - prev[lights.tri_light]) / safe[lights.tri_light]
    new_area = jnp.where(lights.type == LIGHT_MESH, total, lights.area)
    return lights.replace(area=new_area, tri_cdf=cdf)


class SceneAnimator(PyTreeNode):
    """Base-geometry snapshot + per-vertex shape ids; maps per-shape
    transforms to a fresh world-space :class:`Scene` (jittable)."""

    base: Scene
    vertex_shape: jax.Array  # (V,) i32

    @classmethod
    def create(cls, scene: Scene) -> "SceneAnimator":
        return cls(base=scene, vertex_shape=vertex_shape_ids(scene))

    def transformed(self, to_world: jax.Array) -> Scene:
        """Pure function of ``to_world`` ((S, 4, 4) f32): re-transform all
        vertices and normals from the base snapshot (idempotent — repeated
        calls never accumulate floating-point drift) and refresh light CDFs
        and the scene bounding sphere."""
        geom = self.base.geometry
        m = jnp.asarray(to_world, jnp.float32)  # (S, 4, 4)
        rot = m[:, :3, :3]
        # normal matrix = inverse-transpose of the upper 3x3 per shape
        nmat = jnp.swapaxes(jnp.linalg.inv(rot), -1, -2)  # (S, 3, 3)

        mv = jnp.take(m, self.vertex_shape, axis=0, mode="clip")  # (V, 4, 4)
        nv = jnp.take(nmat, self.vertex_shape, axis=0, mode="clip")
        p = jnp.einsum("vij,vj->vi", mv[:, :3, :3], geom.positions) + mv[:, :3, 3]
        n = jnp.einsum("vij,vj->vi", nv, geom.normals)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

        lo, hi = p.min(0), p.max(0)
        center = (lo + hi) * 0.5
        radius = jnp.linalg.norm(hi - center) + 1e-6

        shapes = self.base.shapes
        new_geom = geom.replace(
            positions=p,
            normals=n,
            face_attrs=pack_face_attrs(
                p, n, geom.uvs, geom.indices, geom.face_shape,
                geom.face_valid, shapes.material, shapes.light,
            ),
        )
        lights = _refresh_mesh_lights(self.base.lights, p, new_geom.indices)
        return self.base.replace(
            geometry=new_geom,
            shapes=self.base.shapes.replace(to_world=m, normal_mat=nmat),
            lights=lights,
            center=center,
            radius=radius,
        )

    def identity_transforms(self) -> np.ndarray:
        s = self.base.shapes.material.shape[0]
        return np.broadcast_to(np.eye(4, dtype=np.float32), (s, 4, 4)).copy()

    def set_transform(self, shape_idx: int, matrix: np.ndarray,
                      transforms: np.ndarray | None = None) -> Scene:
        """Host convenience mirroring ``Shape::SetTransform`` + ``Commit``:
        update one shape's transform and return the re-built Scene."""
        t = self.identity_transforms() if transforms is None else np.array(transforms)
        t[shape_idx] = np.asarray(matrix, np.float32)
        return self.transformed(jnp.asarray(t))


def set_shape_transform(scene: Scene, shape_id: int, matrix) -> Scene:
    """Pure transform edit for an INSTANCED shape: updates
    ``shapes.to_world`` (and its normal matrix) without touching geometry —
    the ``Shape::SetTransform`` analogue for no-bake instances
    (``radeon_rays.h:231-241``); pair ``Renderer.update_scene`` then takes
    the in-jit two-level refit.  For baked shapes use
    :class:`SceneAnimator` (vertices must actually move)."""
    m = jnp.asarray(matrix, jnp.float32)
    nm = jnp.swapaxes(jnp.linalg.inv(m[:3, :3]), -1, -2)
    shapes = scene.shapes
    return scene.replace(shapes=shapes.replace(
        to_world=shapes.to_world.at[shape_id].set(m),
        normal_mat=shapes.normal_mat.at[shape_id].set(nm),
    ))


def make_animated_frame(animator: SceneAnimator, camera, cfg,
                        base_accel=None):
    """Fused transform + accel REFIT + render, one XLA program per frame —
    the dynamic-scene path (VERDICT r3 item 6).

    The reference refits its BVH via ``Commit`` for per-frame transform
    edits (``RTScene.cpp:317-391``); here the block decomposition from the
    build-time accel is kept and ``refit_blocked`` recomputes triangle rows
    + block/chunk AABBs in-jit from the transformed vertices, so an
    animation step never leaves the device.  Returns
    ``frame_fn(to_world, accum, frame) -> (scene, accum')`` (jit it once;
    transform edits are data, not new programs).
    """
    from ..accel import blocked_intersector
    from ..accel.pallas_blocked import build_blocked, refit_blocked
    from ..renderer import render_frame_fn

    if base_accel is None:
        base_accel = build_blocked(animator.base.geometry, cfg.bvh)

    def frame_fn(to_world, accum, frame):
        scene = animator.transformed(to_world)
        acc = refit_blocked(base_accel, scene.geometry)
        inter = blocked_intersector(acc, sort=base_accel.num_blocks >= 8)
        return scene, render_frame_fn(scene, camera, accum, frame, cfg,
                                      inter)

    return frame_fn


def translation(offset) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(offset, np.float32)
    return t


def scale(factors) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[1, 1], t[2, 2] = np.broadcast_to(
        np.asarray(factors, np.float32), (3,)
    )
    return t


def rotation_y(angle_rad: float) -> np.ndarray:
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[0, 2], t[2, 0], t[2, 2] = c, s, -s, c
    return t
