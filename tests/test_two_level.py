"""Two-level (instanced) intersection vs the baked-out oracle.

The reference's two-level conformance contract: instanced traversal must
return the same hits as intersecting the flattened world-space copies
(``intersector_2level.cpp`` vs the single-level path), reporting the
instance's shape id and the SHARED mesh's prim id.
"""
import jax
import jax.numpy as jnp
import numpy as np

from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu.accel.two_level import (
    build_two_level, intersect_two_level, occluded_two_level,
)
from mcrt_tpu.core.types import Rays
from mcrt_tpu.scene.builders import SceneBuffers, icosphere
from mcrt_tpu.scene.dynamic import rotation_y, scale, translation
from mcrt_tpu.scene.scene import UberMaterial, build_scene


def _setup():
    pos, idx, _ = icosphere((0.0, 0.0, 0.0), 0.5, subdiv=2)
    # source geometry (object space) as a Geometry via build_scene
    sb = SceneBuffers()
    sb.add_mesh(pos, idx, 0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    src_scene = build_scene(positions, normals, uvs, indices, face_shape,
                            shape_mat, [UberMaterial(diffuse=(0.5,) * 3)])
    source = src_scene.geometry

    t0 = translation((-0.8, 0.0, 0.0))
    t1 = translation((0.9, 0.2, -0.3)) @ rotation_y(0.7) @ scale(0.6)
    t2 = translation((0.0, -0.6, 0.5)) @ scale((1.4, 0.5, 0.9))
    to_world = np.stack([t0, t1, t2])
    accel = build_two_level(source, to_world, np.asarray([3, 7, 9]))

    # baked oracle: world-space copies in one soup
    sb2 = SceneBuffers()
    for t in (t0, t1, t2):
        p = pos @ t[:3, :3].T + t[:3, 3]
        sb2.add_mesh(p, idx, 0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb2.concat()
    baked = build_scene(positions, normals, uvs, indices, face_shape,
                        shape_mat, [UberMaterial(diffuse=(0.5,) * 3)])
    return source, accel, baked


def _random_rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays.make(jnp.asarray(o), jnp.asarray(d))


def test_two_level_closest_matches_baked():
    source, accel, baked = _setup()
    rays = _random_rays(2048)
    h2 = jax.jit(lambda r: intersect_two_level(source, accel, r))(rays)
    hb = intersect_brute(baked.geometry, rays)
    assert bool((h2.valid == hb.valid).all())
    m = np.asarray(h2.valid)
    np.testing.assert_allclose(
        np.asarray(h2.t)[m], np.asarray(hb.t)[m], rtol=2e-4, atol=2e-4
    )
    # shape ids = the instance table's ids; baked soup numbers shapes 0..2
    inst_of = {3: 0, 7: 1, 9: 2}
    s2 = np.asarray(h2.shape)[m]
    sb = np.asarray(hb.shape)[m]
    agree = np.asarray([inst_of[s] for s in s2]) == sb
    # coplanar/overlapping-instance ties may pick either copy at equal t
    assert agree.mean() > 0.99
    # prim indexes the SHARED source mesh: same face count per instance
    f_src = int(np.asarray(source.face_valid).sum())
    assert (np.asarray(h2.prim)[m] < f_src).all()
    # and the baked prim modulo the per-instance face block must agree
    # where the shape agrees (the soup concatenates f_src faces per
    # instance, padding only at the very end)
    np.testing.assert_array_equal(
        np.asarray(h2.prim)[m][agree], (np.asarray(hb.prim)[m] % f_src)[agree]
    )


def test_two_level_occlusion_matches_baked():
    source, accel, baked = _setup()
    rays = _random_rays(1024, seed=3)
    b2 = jax.jit(lambda r: occluded_two_level(source, accel, r))(rays)
    bb = occluded_brute(baked.geometry, rays)
    assert bool((b2 == bb).all())


def test_two_level_memory_sharing():
    """The point of instancing: accel memory is one BLAS regardless of
    instance count (vs the bake-out's linear growth)."""
    source, accel, baked = _setup()
    blas_bytes = sum(
        np.asarray(x).nbytes
        for x in (accel.blas.tri, accel.blas.aabb, accel.blas.slot_prim)
    )
    baked_face_bytes = np.asarray(baked.geometry.face_attrs).nbytes
    # 3 instances: baked face table alone already outweighs the shared BLAS
    assert baked_face_bytes > 2 * blas_bytes / 3
    assert accel.world_to_object.shape == (3, 4, 4)


def _grid_setup(nx=10, nz=10):
    pos, idx, _ = icosphere((0.0, 0.0, 0.0), 0.4, subdiv=1)
    sb = SceneBuffers()
    sb.add_mesh(pos, idx, 0)
    positions, normals, uvs, indices, face_shape, shape_mat, _ = sb.concat()
    src = build_scene(positions, normals, uvs, indices, face_shape,
                      shape_mat, [UberMaterial(diffuse=(0.5,) * 3)])
    tws = []
    for ix in range(nx):
        for iz in range(nz):
            tws.append(translation((ix * 1.2, 0.0, iz * 1.2)))
    to_world = np.stack(tws)
    accel = build_two_level(src.geometry, to_world,
                            np.arange(len(tws), dtype=np.int32))
    return src.geometry, accel


def test_pair_kernel_matches_loop_100_instances():
    """The pair-list kernel vs the sequential per-instance loop oracle at
    100 instances (VERDICT r3 item 4 conformance)."""
    from mcrt_tpu.accel.two_level import (
        intersect_two_level_loop, occluded_two_level_loop,
    )

    source, accel = _grid_setup()
    assert accel.num_instances == 100
    rays = _random_rays(1024, seed=7)
    # spread rays across the grid extent
    rays = rays.replace(o=rays.o * jnp.asarray([3.0, 1.0, 3.0]) +
                        jnp.asarray([5.0, 0.0, 5.0]))
    h_new = jax.jit(lambda r: intersect_two_level(source, accel, r))(rays)
    h_ref = jax.jit(lambda r: intersect_two_level_loop(source, accel, r))(rays)
    assert bool((h_new.valid == h_ref.valid).all())
    m = np.asarray(h_new.valid)
    np.testing.assert_allclose(np.asarray(h_new.t)[m],
                               np.asarray(h_ref.t)[m], rtol=1e-5, atol=1e-5)
    b_new = jax.jit(lambda r: occluded_two_level(source, accel, r))(rays)
    b_ref = jax.jit(lambda r: occluded_two_level_loop(source, accel, r))(rays)
    assert bool((b_new == b_ref).all())


def test_pair_cull_scales_with_instances_entered():
    """Localized rays must visit only nearby (instance, block) pairs —
    the whole point of the pair-level cull (cost ∝ pairs ENTERED)."""
    from mcrt_tpu.accel.pallas_blocked import (
        _coherence_order, _pack_table, _ray_table, _visit_lists,
    )

    source, accel = _grid_setup()
    # rays confined to one corner instance's neighborhood, pointing down
    rng = np.random.RandomState(5)
    n = 512
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) + (0.0, 2.0, 0.0)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    rays = Rays.make(jnp.asarray(o), jnp.asarray(d))
    table = _ray_table(rays)
    order = _coherence_order(rays, accel.bounds)
    packed = _pack_table(jnp.take(table, order, axis=0))
    counts, _, _ = _visit_lists(packed, accel.pair_aabb)
    mean_visits = float(np.asarray(counts).mean())
    # each ray column can enter at most the ~2 instances under it; with
    # ~2 blocks per instance the per-tile visit count must be tiny
    # compared to the total pair count
    assert mean_visits < accel.num_pairs * 0.05, (
        f"mean visits {mean_visits} vs {accel.num_pairs} pairs")


def test_refit_two_level_matches_rebuild():
    """In-jit instance refit must match a from-scratch build on the new
    transforms (instancing composes with dynamics, VERDICT r3 item 5/6)."""
    from mcrt_tpu.accel.two_level import refit_two_level

    source, accel, baked = _setup()
    # move instance 1, scale instance 2
    t0 = translation((-0.8, 0.0, 0.0))
    t1 = translation((0.4, 0.5, 0.2)) @ rotation_y(1.3) @ scale(0.8)
    t2 = translation((0.1, -0.4, 0.6)) @ scale((0.7, 1.1, 0.9))
    new_tw = np.stack([t0, t1, t2])
    refit = jax.jit(lambda tw: refit_two_level(accel, tw))(
        jnp.asarray(new_tw))
    rebuilt = build_two_level(source, new_tw, np.asarray([3, 7, 9]))

    rays = _random_rays(1024, seed=9)
    h_r = jax.jit(lambda r: intersect_two_level(source, refit, r))(rays)
    h_b = jax.jit(lambda r: intersect_two_level(source, rebuilt, r))(rays)
    assert bool((h_r.valid == h_b.valid).all())
    m = np.asarray(h_r.valid)
    np.testing.assert_allclose(np.asarray(h_r.t)[m], np.asarray(h_b.t)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h_r.shape)[m],
                                  np.asarray(h_b.shape)[m])


# --------------------------------------------------------------------------
# Production-path instancing (VERDICT r4 item 3): scenes built with
# SceneBuffers.add_instanced route through AccelType.AUTO -> the multi-BLAS
# two-level engine, shade with per-shape transforms, and match the baked
# oracle exactly.
# --------------------------------------------------------------------------


def _render(scene, camera, accel, w=32, spp=4, depth=2):
    from mcrt_tpu import RenderConfig, Renderer
    from mcrt_tpu.config import AccelType, IntegratorConfig

    cfg = RenderConfig(width=w, height=w, spp=spp, samples_per_pass=spp,
                       accel=accel,
                       integrator=IntegratorConfig(max_depth=depth))
    return Renderer(scene, camera, cfg), np.asarray(
        Renderer(scene, camera, cfg).render())


def test_instanced_scene_matches_baked_render():
    """End-to-end: instanced scene through Renderer+AUTO (two-level) equals
    the identical baked scene through the brute oracle."""
    from mcrt_tpu.config import AccelType
    from mcrt_tpu.scene.builders import instanced_boxes

    si, cam = instanced_boxes(3)
    sb, _ = instanced_boxes(3, bake=True)
    assert si.geometry.instanced and si.instances.num == 8
    assert sb.instances is None
    r, img_i = _render(si, cam, AccelType.AUTO)
    from mcrt_tpu.accel.two_level import TwoLevelAccel

    assert isinstance(r.intersector.accel, TwoLevelAccel)  # AUTO dispatch
    _, img_b = _render(sb, cam, AccelType.BRUTE)
    np.testing.assert_allclose(img_i, img_b, atol=1e-4)
    assert img_i.mean() > 0.02


def test_instanced_rejects_flat_accels():
    from mcrt_tpu import RenderConfig, Renderer
    from mcrt_tpu.config import AccelType
    from mcrt_tpu.scene.builders import instanced_boxes
    import pytest

    si, cam = instanced_boxes(2)
    cfg = RenderConfig(width=8, height=8, accel=AccelType.BRUTE)
    with pytest.raises(ValueError, match="instanced"):
        Renderer(si, cam, cfg)


def test_instanced_memory_sublinear():
    """Accel + geometry memory must grow O(1)-ish with instance count —
    the point of CreateInstance (``radeon_rays.h:223-227``): doubling the
    instance count grows the instanced representation by only the per-pair
    metadata, while the baked scene doubles its geometry."""
    from mcrt_tpu.accel.two_level import build_two_level_scene
    from mcrt_tpu.accel.pallas_blocked import build_blocked
    from mcrt_tpu.runtime.platform import _nbytes
    from mcrt_tpu.scene.builders import instanced_boxes

    def inst_bytes(grid):
        s, _ = instanced_boxes(grid)
        acc = build_two_level_scene(s.geometry, s.shapes.to_world,
                                    s.instances)
        return _nbytes(acc) + _nbytes(s.geometry)

    def baked_bytes(grid):
        s, _ = instanced_boxes(grid, bake=True)
        return _nbytes(build_blocked(s.geometry)) + _nbytes(s.geometry)

    i4, i6 = inst_bytes(4), inst_bytes(6)   # 15 -> 35 instances (2.3x)
    b4, b6 = baked_bytes(4), baked_bytes(6)
    # baked grows with instance count; instanced barely moves
    assert (i6 - i4) < 0.25 * (b6 - b4), (i4, i6, b4, b6)
    assert i6 < b6  # and is absolutely smaller at scale


def test_instanced_transform_edit_refits_through_renderer(monkeypatch):
    """Editing an instance transform via Renderer.update_scene must take the
    in-jit refit path (no build_two_level_scene host rebuild) and match a
    full rebuild — the dynamic-instance path (``RTScene.cpp:317-359``)."""
    from mcrt_tpu import RenderConfig, Renderer
    from mcrt_tpu.config import AccelType, IntegratorConfig
    from mcrt_tpu.scene.builders import instanced_boxes
    from mcrt_tpu.scene.dynamic import set_shape_transform, translation

    si, cam = instanced_boxes(3)
    cfg = RenderConfig(width=24, height=24, spp=2, samples_per_pass=2,
                       integrator=IntegratorConfig(max_depth=2))
    r = Renderer(si, cam, cfg)
    shape_id = int(np.asarray(si.instances.shape)[0])
    edited = set_shape_transform(si, shape_id, translation((0.5, 0.3, 0.0)))

    from mcrt_tpu.accel import two_level

    def _boom(*a, **k):  # pragma: no cover
        raise AssertionError("host rebuild on a transform-only edit")

    monkeypatch.setattr(two_level, "build_two_level_scene", _boom)
    r.update_scene(edited)
    img_refit = np.asarray(r.render())

    monkeypatch.undo()
    _, img_rebuild = _render(edited, cam, AccelType.AUTO, w=24, spp=2)
    np.testing.assert_allclose(img_refit, img_rebuild, atol=1e-5)
    _, img_orig = _render(si, cam, AccelType.AUTO, w=24, spp=2)
    assert np.abs(img_refit - img_orig).max() > 1e-3  # edit visible


def test_instanced_scene_gradients_flow():
    """Inverse rendering works on instanced scenes: material gradients flow
    through the two-level query's zero-cotangent custom_vjp and the
    per-shape transform applied at vertex fetch."""
    import jax
    import jax.numpy as jnp

    from mcrt_tpu import RenderConfig, Renderer
    from mcrt_tpu.config import IntegratorConfig
    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.renderer import render_sample
    from mcrt_tpu.scene.builders import instanced_boxes

    scene, camera = instanced_boxes(2)
    cfg = RenderConfig(width=16, height=16, spp=1,
                       integrator=IntegratorConfig(max_depth=2))
    intersector = build_intersector(scene, cfg)

    def loss(diffuse):
        s = scene.replace(materials=scene.materials.replace(diffuse=diffuse))
        img, _ = render_sample(s, camera, jnp.asarray(0, jnp.int32), cfg,
                               intersector)
        return jnp.sum(img)

    g = jax.jit(jax.grad(loss))(scene.materials.diffuse)
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.abs(g).sum()) > 0
