"""Engine selection and the blocked engine's plain-JAX pieces.

- ``AUTO`` picks an engine from the scene's face count alone, whatever
  platform JAX reports;
- the traversal kernels are interpreted on the CPU, compiled on the GPU and
  refused elsewhere;
- the block cull kernel and its plain-XLA reference equal a NumPy slab
  test;
- the compiled kernels themselves run on the GPU only (``gpu`` marker;
  ``chip_smoke.py`` phase (b) covers them at full size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcrt_tpu.accel import BRUTE_MAX_FACES, build_intersector
from mcrt_tpu.accel import pallas_blocked as pb
from mcrt_tpu.config import RenderConfig
from mcrt_tpu.scene.builders import SceneBuffers, icosphere
from mcrt_tpu.scene.scene import UberMaterial, build_scene


def _sphere_scene(subdiv: int):
    sb = SceneBuffers()
    p, i, n = icosphere((0.0, 0.5, 0.0), 0.5, subdiv=subdiv)
    sb.add_mesh(p, i, 0, normals=n)
    a = sb.concat()
    return build_scene(*a[:6], [UberMaterial(diffuse=(0.5,) * 3)],
                       shape_light=a[6])


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_auto_chooses_by_face_count_only(monkeypatch, backend):
    """subdiv 3 = 1,280 faces (brute); subdiv 5 = 20,480 (blocked) — the
    same answer whichever platform JAX claims."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    small, big = _sphere_scene(3), _sphere_scene(5)
    assert small.geometry.num_faces <= BRUTE_MAX_FACES < big.geometry.num_faces
    assert build_intersector(small, RenderConfig()).accel is None
    assert isinstance(build_intersector(big, RenderConfig()).accel,
                      pb.BlockedAccel)


@pytest.mark.parametrize("backend,interpret", [("cpu", True),
                                               ("gpu", False)])
def test_interpret_only_on_cpu(monkeypatch, backend, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pb._interpret() is interpret


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_interpret_refuses_other_backends(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match=backend):
        pb._interpret()


def _numpy_cull(rays_packed, aabb, tile):
    """Reference slab test, one (tile, block) pair at a time."""
    r = np.asarray(rays_packed, np.float64)
    a = np.asarray(aabb, np.float64)
    n_tiles = r.shape[1] // tile
    key = np.full((n_tiles, a.shape[0]), pb.BIG)
    with np.errstate(invalid="ignore", divide="ignore"):
        for t in range(n_tiles):
            o = r[0:3, t * tile:(t + 1) * tile].T
            d = r[3:6, t * tile:(t + 1) * tile].T
            d = np.where(np.abs(d) > 1e-12, d, 1e-12)
            tmn, tmx = r[6, t * tile:(t + 1) * tile], r[7, t * tile:(t + 1) * tile]
            for b in range(a.shape[0]):
                if not a[b, 0] <= a[b, 3]:  # empty: NaN or inverted
                    continue
                t0 = (a[b, 0:3] - o) / d
                t1 = (a[b, 3:6] - o) / d
                tn = np.maximum(np.minimum(t0, t1).max(1), tmn)
                tf = np.minimum(np.maximum(t0, t1).min(1), tmx)
                enter = tn <= tf
                if enter.any():
                    key[t, b] = tn[enter].min()
    return key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_matches_numpy_slab_test(seed):
    rng = np.random.RandomState(seed)
    n, nb = 4 * pb.TILE, 2 * pb.CULL_BLOCKS
    lo = rng.uniform(-2, 2, (nb, 3))
    hi = lo + rng.uniform(0.05, 1.0, (nb, 3))
    aabb = np.zeros((nb, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = lo, hi
    aabb[-3:, 0:6] = np.nan  # empty blocks are never entered, whether
    aabb[-5:-3, 0:3] = 1e30  # NaN-poisoned or inverted (lo > hi)
    aabb[-5:-3, 3:6] = -1e30
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.rand(n) < 0.1, -pb.BIG, 1e30)  # some dead rays
    packed = np.concatenate([o, d, np.full((n, 1), 1e-4), tmax[:, None]],
                            axis=1).T.astype(np.float32)
    want = _numpy_cull(packed, aabb, pb.TILE)
    entered = want < 0.5 * pb.BIG
    for cull in (pb._cull, pb._cull_reference):
        got = np.asarray(cull(jnp.asarray(packed), jnp.asarray(aabb)))
        assert ((got < 0.5 * pb.BIG) == entered).all()
        np.testing.assert_allclose(got[entered], want[entered], rtol=1e-5,
                                   atol=1e-5)
        assert (got[:, -5:] >= 0.5 * pb.BIG).all()


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels have no CPU "
                    "form (chip_smoke.py phase (b) runs them)")


@pytest.mark.gpu
def test_compiled_kernels_match_brute(gpu):
    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from tests.test_lbvh import _random_rays, _random_soup_scene

    scene = _random_soup_scene(n_tris=20000, seed=11)
    acc = pb.build_blocked(scene.geometry)
    rays = _random_rays(4096, seed=3, radius=1.6)
    hb = intersect_brute(scene.geometry, rays)
    hp = pb.intersect_blocked(scene.geometry, acc, rays)
    np.testing.assert_array_equal(np.asarray(hp.valid), np.asarray(hb.valid))
    np.testing.assert_array_equal(
        np.asarray(occluded_brute(scene.geometry, rays)),
        np.asarray(pb.occluded_blocked(scene.geometry, acc, rays)))
