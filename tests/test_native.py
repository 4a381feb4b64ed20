"""Tests for the native runtime library (OBJ parser + SAH partitioner).

The library is built with ``make -C native`` on first use; these tests skip
where no toolchain is available.  The mesh tests write an icosphere OBJ.
"""
import numpy as np
import pytest

from mcrt_tpu.runtime import native


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library does not build here (no g++/make?)")


@pytest.fixture
def sphere_obj(tmp_path):
    """A 5,120-triangle icosphere written as OBJ (``v`` + ``f`` lines)."""
    from mcrt_tpu.scene.builders import icosphere

    pos, idx, _ = icosphere((0.0, 0.0, 0.0), 1.0, subdiv=4)
    path = tmp_path / "sphere.obj"
    lines = [f"v {x:.7g} {y:.7g} {z:.7g}" for x, y, z in np.asarray(pos)]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in np.asarray(idx)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_obj_parse_matches_python(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "usemtl red\n"
        "f 1/1/1 2/2/1 3/3/1\n"
        "f 2 4 3\n"  # no vt/vn
        "f -4 -3 -2\n"  # negative indices
    )
    g = native.parse_obj_native(str(obj))
    assert g is not None
    assert g.v.shape == (4, 3)
    assert g.vt.shape == (3, 2)
    assert g.vn.shape == (1, 3)
    assert g.f_v.shape == (3, 3)
    np.testing.assert_array_equal(g.f_v[0], [0, 1, 2])
    np.testing.assert_array_equal(g.f_v[1], [1, 3, 2])
    np.testing.assert_array_equal(g.f_v[2], [0, 1, 2])
    np.testing.assert_array_equal(g.f_vn[0], [0, 0, 0])
    np.testing.assert_array_equal(g.f_vn[1], [-1, -1, -1])
    assert g.mat_names == ["red"]
    assert g.mtl_libs == ["m.mtl"]


def test_obj_quad_fan_triangulation(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    g = native.parse_obj_native(str(obj))
    assert g.f_v.shape == (2, 3)
    np.testing.assert_array_equal(g.f_v, [[0, 1, 2], [0, 2, 3]])


def test_native_loader_equals_python_loader(sphere_obj):
    from mcrt_tpu.scene import objloader

    m_native = objloader._load_obj_native(sphere_obj)
    assert m_native is not None
    saved = objloader._load_obj_native
    try:
        objloader._load_obj_native = lambda p: None
        m_py = objloader.load_obj(sphere_obj)
    finally:
        objloader._load_obj_native = saved
    assert m_native.indices.shape == m_py.indices.shape
    tn = np.sort(
        m_native.positions[m_native.indices].reshape(len(m_native.indices), -1),
        axis=1,
    )
    tp = np.sort(
        m_py.positions[m_py.indices].reshape(len(m_py.indices), -1), axis=1
    )
    np.testing.assert_allclose(tn, tp, atol=1e-6)


def test_sah_block_order_is_partition(sphere_obj):
    from mcrt_tpu.scene.objloader import load_obj

    mesh = load_obj(sphere_obj)
    out = native.sah_block_order(mesh.positions, mesh.indices, 128, 16)
    assert out is not None
    order, bstart = out
    n = len(mesh.indices)
    assert np.array_equal(np.sort(order), np.arange(n))
    assert bstart[0] == 0 and bstart[-1] == n
    sizes = np.diff(bstart)
    assert (sizes >= 1).all() and (sizes <= 128).all()


def test_sah_blocked_accel_conformance():
    """SAH-blocked accel must agree with the brute oracle (CPU interpret)."""
    import jax.numpy as jnp

    from mcrt_tpu.accel.brute import intersect_brute
    from mcrt_tpu.accel.pallas_blocked import build_blocked, intersect_blocked
    from mcrt_tpu.config import BVHConfig, BuilderType
    from mcrt_tpu.core.types import Rays
    from mcrt_tpu.scene.builders import cornell_box

    scene, _ = cornell_box()
    acc = build_blocked(scene.geometry, BVHConfig(builder=BuilderType.SAH))
    rng = np.random.RandomState(3)
    n = 300
    pos = np.asarray(scene.geometry.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.8 + (lo + hi) / 2
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))
    hb = intersect_brute(scene.geometry, rays)
    hp = intersect_blocked(scene.geometry, acc, rays)
    assert bool((hb.valid == hp.valid).all())
    tb = jnp.where(hb.valid, hb.t, 0.0)
    tp = jnp.where(hp.valid, hp.t, 0.0)
    assert bool(jnp.allclose(tb, tp, rtol=1e-5, atol=1e-6))


def test_sbvh_blocked_accel_conformance():
    """SBVH (spatial splits, split_bvh.h:30-45 analogue) must agree with
    the brute oracle on a multi-block scene; straddling triangles may be
    referenced from several blocks, which must not change any hit."""
    import jax.numpy as jnp

    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu.accel.pallas_blocked import (
        build_blocked, intersect_blocked, occluded_blocked,
    )
    from mcrt_tpu.config import BVHConfig, BuilderType
    from mcrt_tpu.scene.builders import glass_gallery
    from mcrt_tpu.core.types import Rays

    scene, _ = glass_gallery()
    nfaces = int(np.asarray(scene.geometry.face_valid).sum())
    acc = build_blocked(scene.geometry, BVHConfig(builder=BuilderType.SBVH))
    n_refs = int((np.asarray(acc.slot_prim) >= 0).sum())
    assert n_refs >= nfaces  # duplicated references allowed, none lost
    assert len(np.unique(np.asarray(acc.slot_prim)[
        np.asarray(acc.slot_prim) >= 0])) == nfaces

    rng = np.random.RandomState(11)
    n = 1024
    pos = np.asarray(scene.geometry.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.8 + (lo + hi) / 2
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))
    hb = intersect_brute(scene.geometry, rays)
    hp = intersect_blocked(scene.geometry, acc, rays)
    assert bool((hb.valid == hp.valid).all())
    tb = jnp.where(hb.valid, hb.t, 0.0)
    tp = jnp.where(hp.valid, hp.t, 0.0)
    assert bool(jnp.allclose(tb, tp, rtol=1e-4, atol=1e-5))
    ob = occluded_brute(scene.geometry, rays)
    op = occluded_blocked(scene.geometry, acc, rays)
    assert bool((ob == op).all())
