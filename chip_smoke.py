#!/usr/bin/env python3
"""Smoke run of the path tracer on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases (a)-(g)
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

Phases, in order; any failure exits non-zero, no phase carries on after
an error:

(a) device: a GPU or fail; print nvidia-smi's name and power limit, the JAX
    version, XLA_FLAGS and the compile cache directory.
(b) queries on a 250,880-triangle sphere field at 262,144 rays (primary and
    bounce-1): the compiled blocked (Triton) kernels against the brute
    oracle on a 16,384-ray subset and against the XLA LBVH on all rays;
    per-call synced timings of each engine and one ``render_spp_batch``
    call per engine; the two-level kernels on an instanced scene.
(c) the main path: ``Renderer(...).render()`` of the sphere field at 512²,
    8 bounces, 4 spp, Sobol, ``accel=AUTO``; the same frames with LBVH.
(d) the GPU against the CPU backend on the Cornell box.
(e) BDPT: finite at 128², and PT↔BDPT agreement on the Cornell box.
(f) gradients of ``render_loss_fn`` w.r.t. material parameters.
(g) per-call synced timings of the main-path render.

The last line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

WIDTH = 512  # film side: 262,144 rays per query
FIELD_GRID = 7  # 7 x 7 spheres of 5,120 triangles
INST_GRID = 92  # instanced_boxes grid: 8,463 instances, 101,556 triangles
N_SUBSET = 16384  # rays of the brute-oracle comparisons
TIE_FRACTION = 1e-4  # disagreements allowed at exact ties, per ray
T_RTOL = 1e-5


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def timed(fn, *args, reps: int = 5):
    """Median and per-call seconds of ``fn(*args)``, each call synced."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


# --------------------------------------------------------------------------
# scenes and rays
# --------------------------------------------------------------------------


def sphere_field(grid: int | None = None):
    """A grid x grid field of 5,120-triangle icospheres on a floor under an
    emissive quad, with diffuse, glossy and dielectric materials: 250,880
    sphere triangles at grid=7, the size of the repo's primary bench
    configuration."""
    from mcrt_tpu.camera.pinhole import PinholeCamera
    from mcrt_tpu.scene.builders import SceneBuffers, icosphere, quad
    from mcrt_tpu.scene.scene import (
        LIGHT_MESH, UberMaterial, build_scene, make_lights,
    )

    grid = grid or FIELD_GRID
    sb = SceneBuffers()
    ext = grid * 1.0
    for gx in range(grid):
        for gz in range(grid):
            c = ((gx - (grid - 1) / 2) * 1.5, 0.5,
                 (gz - (grid - 1) / 2) * 1.5)
            p, i, n = icosphere(c, 0.5, subdiv=4)
            sb.add_mesh(p, i, (gx + gz) % 3, normals=n)
    p, i = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext],
                [-ext, 0, -ext])
    sb.add_mesh(p, i, 0)
    h, s = ext * 0.9, ext * 0.25  # light quad wound to face down
    p, i = quad([-s, h, -s], [s, h, -s], [s, h, s], [-s, h, s])
    light = sb.add_mesh(p, i, 3, light_id=0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = \
        sb.concat()
    materials = [
        UberMaterial(diffuse=(0.7, 0.7, 0.7)),
        UberMaterial(diffuse=(0.1, 0.1, 0.1), glossy=(0.8, 0.6, 0.3),
                     roughness=0.15),
        UberMaterial(kt=(0.95, 0.95, 0.95), kr=(0.1, 0.1, 0.1),
                     roughness=0.0, ior=1.5),
        UberMaterial(),  # the light: a pure emitter
    ]
    lights = make_lights(
        [{"type": LIGHT_MESH, "intensity": (30.0, 28.0, 25.0),
          "shape": light}], positions, indices, face_shape)
    scene = build_scene(positions, normals, uvs, indices, face_shape,
                        shape_mat, materials, lights=lights,
                        shape_light=shape_light)
    camera = PinholeCamera.look_at(eye=(0.0, ext * 0.7, ext * 1.2),
                                   target=(0.0, 0.3, 0.0), fov_deg=50.0,
                                   aspect=1.0)
    return scene, camera


def primary_rays(camera, width: int):
    from mcrt_tpu.camera.pinhole import pixel_uv
    from mcrt_tpu.core.types import Rays

    o, d = camera.generate_rays(pixel_uv(width, width))
    return Rays.make(o, d)


def bounce_rays(geom, rays, hit, seed: int = 0):
    """Bounce-1 rays: cosine-weighted directions about the geometric normal
    at each primary hit (facing the incoming ray); misses are inactive."""
    import jax.numpy as jnp

    from mcrt_tpu.core.types import Rays

    valid = np.asarray(hit.valid)
    prim = np.maximum(np.asarray(hit.prim), 0)
    idx = np.asarray(geom.indices)[prim]
    pos = np.asarray(geom.positions)
    n = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    d_in = np.asarray(rays.d)
    n = np.where((np.sum(n * d_in, 1) > 0)[:, None], -n, n)
    t = np.where(valid, np.asarray(hit.t), 0.0)
    p = np.asarray(rays.o) + t[:, None] * d_in + 1e-4 * n
    rng = np.random.default_rng(seed)
    u1, u2 = rng.random(len(t)), rng.random(len(t))
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    tx = np.cross(a, n)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(n, tx)
    d = (r * np.cos(phi))[:, None] * tx + (r * np.sin(phi))[:, None] * ty \
        + np.sqrt(np.maximum(1 - u1, 0))[:, None] * n
    return Rays.make(jnp.asarray(p, jnp.float32), jnp.asarray(d, jnp.float32),
                     active=jnp.asarray(valid))


def subset(x, n: int):
    """Every k-th of the leading axis of a pytree (rays, hits or masks)."""
    import jax

    stride = max(1, jax.tree.leaves(x)[0].shape[0] // n)
    return jax.tree.map(lambda a: a[::stride][:n], x)


# --------------------------------------------------------------------------
# conformance rules
# --------------------------------------------------------------------------


def compare_hits(name: str, ref, got) -> dict:
    """Hit equality up to ties.  A disagreement is a tie when both hit at
    the same t (coplanar or shared-edge triangles) or when the one hit lies
    on a triangle edge (the inclusive edge test flips with the rounding of
    u/v).  Möller-Trumbore is elementwise fp32 in every engine, so TF32
    never enters; the remaining differences come from FMA contraction in
    Triton compared with XLA."""
    rv, gv = np.asarray(ref.valid), np.asarray(got.valid)
    rp, gp = np.asarray(ref.prim), np.asarray(got.prim)
    rt, gt = np.asarray(ref.t), np.asarray(got.t)
    both = rv & gv
    same_t = both & (np.abs(rt - gt) <= T_RTOL * np.maximum(np.abs(rt), 1e-6))
    prim_diff = both & (rp != gp)
    t_bad = both & (rp == gp) & ~same_t
    edge = lambda h: np.minimum(np.minimum(np.asarray(h.u), np.asarray(h.v)),
                                1 - np.asarray(h.u) - np.asarray(h.v)) < 1e-4
    valid_diff = rv != gv
    on_edge = np.where(rv, edge(ref), edge(got))
    ties = (prim_diff & same_t) | (valid_diff & on_edge)
    hard = (prim_diff & ~same_t) | (valid_diff & ~on_edge) | t_bad
    n = rv.shape[0]
    out = {"rays": n, "ties": int(ties.sum()), "hard": int(hard.sum()),
           "max_t_rel": float(np.max(np.where(
               both & (rp == gp),
               np.abs(rt - gt) / np.maximum(np.abs(rt), 1e-6), 0.0)))}
    log(f"  {name}: {out}")
    check(out["hard"] == 0, f"{name}: {out['hard']} rays disagree off ties")
    check(out["ties"] <= TIE_FRACTION * n,
          f"{name}: {out['ties']} ties > {TIE_FRACTION} of {n} rays")
    return out


def compare_masks(name: str, ref, got) -> dict:
    r, g = np.asarray(ref), np.asarray(got)
    diff = int((r != g).sum())
    log(f"  {name}: {diff} of {r.shape[0]} masks differ "
        f"({int(r.sum())} blocked)")
    check(diff <= TIE_FRACTION * r.shape[0],
          f"{name}: {diff} occlusion masks differ")
    return {"rays": int(r.shape[0]), "differ": diff}


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(multi: bool):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform!r} devices")
    if multi:
        check(len(devs) >= 4, f"--multi needs 4 GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    cards = smi.stdout.strip().splitlines()
    log(f"{cards[0]} | cards {len(cards)} | jax {jax.__version__} | "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} | compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    return devs


def phase_queries(results: dict):
    import jax
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu.accel.lbvh import build_lbvh
    from mcrt_tpu.accel import pallas_blocked as pb
    from mcrt_tpu.accel.pallas_blocked import (
        build_blocked, intersect_blocked, occluded_blocked,
    )
    from mcrt_tpu.accel.traverse import intersect_bvh, occluded_bvh
    from mcrt_tpu.config import AccelType, BVHConfig
    from mcrt_tpu.parallel.render import render_spp_batch

    scene, camera = sphere_field()
    geom = scene.geometry
    log(f"(b) sphere field: {int(np.asarray(geom.face_valid).sum())} "
        "triangles")
    bvh_cfg = BVHConfig()
    t0 = time.perf_counter()
    blocked = build_blocked(geom, bvh_cfg)
    log(f"  blocked build {time.perf_counter() - t0:.2f} s, "
        f"{blocked.num_blocks} blocks")
    t0 = time.perf_counter()
    lbvh = build_lbvh(geom, bvh_cfg)
    log(f"  lbvh build {time.perf_counter() - t0:.2f} s")

    engines = {
        "blocked": (jax.jit(lambda g, a, r: intersect_blocked(g, a, r)),
                    jax.jit(lambda g, a, r: occluded_blocked(g, a, r)),
                    blocked),
        "lbvh": (jax.jit(lambda g, a, r: intersect_bvh(g, a, r, bvh_cfg)),
                 jax.jit(lambda g, a, r: occluded_bvh(g, a, r, bvh_cfg)),
                 lbvh),
    }
    with jax.default_matmul_precision("highest"):
        brute_c = jax.jit(lambda g, r: intersect_brute(g, r))
        brute_o = jax.jit(lambda g, r: occluded_brute(g, r))

    prim = primary_rays(camera, WIDTH)
    hit0 = engines["blocked"][0](geom, blocked, prim)
    packed = pb._pack_table(pb._ray_table(prim))
    timing = {}
    key = np.asarray(pb._cull(packed, blocked.aabb))
    check(bool((key[:, blocked.num_blocks:] >= 0.5 * pb.BIG).all()),
          "the cull entered padding (empty) blocks")
    for name, fn in (("cull", pb._cull), ("cull+sort", pb._visit_lists)):
        med, _ = timed(jax.jit(fn), packed, blocked.aabb)
        timing[f"blocked/primary/{name}"] = med
        log(f"  blocked {name} kernel alone (primary rays, unsorted): "
            f"{med * 1e3:.3f} ms")
    sets = {"primary": prim, "bounce1": bounce_rays(geom, prim, hit0)}
    for set_name, rays in sets.items():
        sub = subset(rays, N_SUBSET)
        with jax.default_matmul_precision("highest"):
            ref_c_sub = brute_c(geom, sub)
            ref_o_sub = brute_o(geom, sub)
        tb_c, _ = timed(brute_c, geom, sub)
        tb_o, _ = timed(brute_o, geom, sub)
        timing[f"brute/{set_name}/closest_16k"] = tb_c
        timing[f"brute/{set_name}/any_16k"] = tb_o
        lb_c = engines["lbvh"][0](geom, lbvh, rays)
        lb_o = engines["lbvh"][1](geom, lbvh, rays)
        for eng, (fc, fo, acc) in engines.items():
            h = fc(geom, acc, rays)
            o = fo(geom, acc, rays)
            compare_hits(f"{eng}/{set_name} closest vs brute",
                         ref_c_sub, subset(h, N_SUBSET))
            compare_masks(f"{eng}/{set_name} any vs brute",
                          ref_o_sub, subset(o, N_SUBSET))
            if eng != "lbvh":
                compare_hits(f"{eng}/{set_name} closest vs lbvh", lb_c, h)
                compare_masks(f"{eng}/{set_name} any vs lbvh", lb_o, o)
            t_c, ts_c = timed(fc, geom, acc, rays)
            t_o, ts_o = timed(fo, geom, acc, rays)
            timing[f"{eng}/{set_name}/closest"] = t_c
            timing[f"{eng}/{set_name}/any"] = t_o
            log(f"  {eng}/{set_name} ({rays.n} rays): closest "
                f"{t_c * 1e3:.3f} ms {[round(t * 1e3, 3) for t in ts_c]}, "
                f"any {t_o * 1e3:.3f} ms {[round(t * 1e3, 3) for t in ts_o]}")
        log(f"  brute/{set_name} ({N_SUBSET} rays): closest {tb_c * 1e3:.3f}"
            f" ms, any {tb_o * 1e3:.3f} ms")

    # one whole render_spp_batch call (512², 8 bounces, 4 spp) per engine
    for accel in (AccelType.BLOCKED, AccelType.LBVH):
        cfg = main_path_cfg(accel)
        isect = build_intersector(scene, cfg)
        fn = jax.jit(lambda s, f: render_spp_batch(s, camera, f, cfg, isect))
        frames = jnp.arange(4, dtype=jnp.int32)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene, frames))
        compile_s = time.perf_counter() - t0
        med, ts = timed(fn, scene, frames)
        timing[f"{accel.value}/render_spp_batch_4spp"] = med
        log(f"  render_spp_batch {WIDTH}² x8 4spp [{accel.value}]: "
            f"{med * 1e3:.1f} ms {[round(t * 1e3, 1) for t in ts]} "
            f"(first call {compile_s:.1f} s)")
    results["timing_s"] = timing
    phase_two_level(results)
    return scene, camera


def phase_two_level(results: dict):
    """Two-level kernels on an instanced scene of >= 100k world triangles
    against the same scene baked to world space."""
    import jax
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu.accel.lbvh import build_lbvh
    from mcrt_tpu.accel.traverse import intersect_bvh, occluded_bvh
    from mcrt_tpu.accel.two_level import (
        build_two_level_scene, intersect_two_level, occluded_two_level,
    )
    from mcrt_tpu.config import AccelType
    from mcrt_tpu.parallel.render import render_spp_batch
    from mcrt_tpu.scene.builders import instanced_boxes

    grid = INST_GRID
    inst, camera = instanced_boxes(grid=grid)
    baked, _ = instanced_boxes(grid=grid, bake=True)
    n_world = int(np.asarray(baked.geometry.face_valid).sum())
    log(f"(b) two-level: instanced_boxes(grid={grid}), {n_world} world "
        "triangles")
    check(n_world >= 100_000, f"instanced scene has {n_world} triangles")
    acc = build_two_level_scene(inst.geometry, inst.shapes.to_world,
                                inst.instances)
    lbvh = build_lbvh(baked.geometry)
    rays = primary_rays(camera, WIDTH)
    fc = jax.jit(lambda g, a, r: intersect_two_level(g, a, r))
    fo = jax.jit(lambda g, a, r: occluded_two_level(g, a, r))
    h, o = fc(inst.geometry, acc, rays), fo(inst.geometry, acc, rays)
    lc = jax.jit(lambda g, a, r: intersect_bvh(g, a, r))(baked.geometry,
                                                          lbvh, rays)
    lo = jax.jit(lambda g, a, r: occluded_bvh(g, a, r))(baked.geometry,
                                                        lbvh, rays)
    sub = subset(rays, N_SUBSET)
    with jax.default_matmul_precision("highest"):
        bc = jax.jit(lambda g, r: intersect_brute(g, r))(baked.geometry, sub)
        bo = jax.jit(lambda g, r: occluded_brute(g, r))(baked.geometry, sub)
    # prim ids differ between the instanced and baked tables: compare t and
    # validity (prim is replaced by the shape id, which both report)
    as_shape = lambda x: x.replace(prim=x.shape)
    compare_hits("two_level closest vs brute (baked)", as_shape(bc),
                 as_shape(subset(h, N_SUBSET)))
    compare_masks("two_level any vs brute (baked)", bo, subset(o, N_SUBSET))
    compare_hits("two_level closest vs lbvh (baked)", as_shape(lc),
                 as_shape(h))
    compare_masks("two_level any vs lbvh (baked)", lo, o)
    timing = results["timing_s"]
    for name, (c, o, g, a) in {
            "two_level": (fc, fo, inst.geometry, acc),
            "lbvh_baked": (jax.jit(lambda g, a, r: intersect_bvh(g, a, r)),
                           jax.jit(lambda g, a, r: occluded_bvh(g, a, r)),
                           baked.geometry, lbvh)}.items():
        t_c, _ = timed(c, g, a, rays)
        t_o, _ = timed(o, g, a, rays)
        timing[f"{name}/primary/closest"] = t_c
        timing[f"{name}/primary/any"] = t_o
        log(f"  {name}/primary: closest {t_c * 1e3:.3f} ms, any "
            f"{t_o * 1e3:.3f} ms")
    # one whole render_spp_batch call: instanced (AUTO -> two-level)
    # against the baked scene on the XLA LBVH
    for name, sc, accel in (("two_level", inst, AccelType.AUTO),
                            ("lbvh_baked", baked, AccelType.LBVH)):
        cfg = main_path_cfg(accel)
        isect = build_intersector(sc, cfg)
        fn = jax.jit(lambda s, f: render_spp_batch(s, camera, f, cfg, isect))
        med, ts = timed(fn, sc, jnp.arange(4, dtype=jnp.int32))
        timing[f"{name}/render_spp_batch_4spp"] = med
        log(f"  render_spp_batch {WIDTH}² x8 4spp instanced [{name}]: "
            f"{med * 1e3:.1f} ms {[round(t * 1e3, 1) for t in ts]}")


def main_path_cfg(accel):
    from mcrt_tpu.config import (
        IntegratorConfig, RenderConfig, SamplerConfig, SamplerType,
    )

    return RenderConfig(
        width=WIDTH, height=WIDTH, spp=4, samples_per_pass=4, accel=accel,
        sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=8))


def phase_main(scene, camera, results: dict):
    import jax

    from mcrt_tpu import Renderer
    from mcrt_tpu.accel.pallas_blocked import BlockedAccel
    from mcrt_tpu.config import AccelType

    log(f"(c) main path: Renderer {WIDTH}² x 8 bounces x 4 spp, accel=AUTO")
    r = Renderer(scene, camera, main_path_cfg(AccelType.AUTO))
    check(isinstance(r.intersector.accel, BlockedAccel),
          f"AUTO chose {type(r.intersector.accel).__name__}")
    t0 = time.perf_counter()
    img = np.asarray(r.render())
    log(f"  first render (with compile) {time.perf_counter() - t0:.1f} s")
    lin = np.asarray(r.accum.image)
    check(lin.shape == (WIDTH, WIDTH, 3), f"image shape {lin.shape}")
    check(bool(np.isfinite(lin).all()), "non-finite pixels")
    check(float(lin.mean()) > 1e-3, f"black image (mean {lin.mean()})")
    r_lbvh = Renderer(scene, camera, main_path_cfg(AccelType.LBVH))
    r_lbvh.render()
    ref = np.asarray(r_lbvh.accum.image)
    mad = float(np.abs(lin - ref).mean())
    log(f"  image mean {lin.mean():.6f}, LBVH mean {ref.mean():.6f}, "
        f"mean |diff| {mad:.3e} ({mad / ref.mean():.3e} of mean)")
    check(mad <= 1e-3 * float(ref.mean()), "AUTO and LBVH images differ")
    results["main_image_mean"] = float(lin.mean())
    return r


def phase_cpu_vs_gpu(results: dict):
    """Cornell box on the GPU and on the CPU backend, same process.  The
    tolerance covers sum order and paths that flip at triangle ties."""
    import jax

    from mcrt_tpu import Renderer
    from mcrt_tpu.config import IntegratorConfig, RenderConfig
    from mcrt_tpu.scene.builders import cornell_box

    cfg = RenderConfig(width=64, height=64, spp=16, samples_per_pass=16,
                       integrator=IntegratorConfig(max_depth=3))
    imgs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            scene, camera = cornell_box()
            r = Renderer(scene, camera, cfg)
            r.render()
            imgs.append(np.asarray(r.accum.image))
    g, c = imgs
    rel_mean = abs(g.mean() - c.mean()) / c.mean()
    close = float((np.abs(g - c).max(-1) <= 1e-3).mean())
    log(f"(d) cornell 64² 16spp GPU vs CPU: means {g.mean():.6f} / "
        f"{c.mean():.6f} (rel {rel_mean:.2e}), {close:.5f} of pixels "
        "within 1e-3")
    check(rel_mean <= 5e-3, "GPU and CPU image means differ")
    check(close >= 0.999, "GPU and CPU pixels differ")
    results["cpu_vs_gpu"] = {"rel_mean": float(rel_mean), "close": close}


def phase_bdpt(scene, camera, results: dict):
    from mcrt_tpu import Renderer
    from mcrt_tpu.config import (
        IntegratorConfig, IntegratorType, RenderConfig,
    )
    from mcrt_tpu.scene.builders import cornell_box

    w = WIDTH // 4
    cfg = RenderConfig(width=w, height=w, spp=1, samples_per_pass=1,
                       integrator=IntegratorConfig(type=IntegratorType.BDPT,
                                                   max_depth=3))
    r = Renderer(scene, camera, cfg)
    r.render()
    img = np.asarray(r.accum.image)
    check(bool(np.isfinite(img).all()), "BDPT image not finite")
    log(f"(e) BDPT {w}² depth 3 sphere field: mean {img.mean():.6f}")
    # PT <-> BDPT on the Cornell box: tests/test_bdpt.py's tolerances
    cb, cam = cornell_box()
    out = []
    for typ in (IntegratorType.PATH, IntegratorType.BDPT):
        c = RenderConfig(width=16, height=16, spp=1024, samples_per_pass=64,
                         integrator=IntegratorConfig(type=typ, max_depth=2))
        rr = Renderer(cb, cam, c)
        rr.render()
        out.append(np.asarray(rr.accum.image).reshape(-1, 3))
    a, b = out
    mask = a.max(-1) < 5.0
    rel = float(np.abs(a - b)[mask].mean() / a[mask].mean())
    rel_mean = float(abs(a.mean() - b.mean()) / a.mean())
    log(f"  cornell PT vs BDPT 16² 1024spp: rel {rel:.4f} (< 0.04), "
        f"mean rel {rel_mean:.4f} (< 0.02)")
    check(rel < 0.04 and rel_mean < 0.02, "PT and BDPT disagree")
    results["bdpt"] = {"rel": rel, "rel_mean": rel_mean}


def phase_grad(scene, camera, results: dict):
    import jax
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import IntegratorConfig, RenderConfig
    from mcrt_tpu.diff.estimators import material_params, render_loss_fn
    from mcrt_tpu.scene.builders import cornell_box

    def grads(scene, camera, width, spp, device=None):
        cfg = RenderConfig(width=width, height=width, spp=spp,
                           samples_per_pass=spp,
                           integrator=IntegratorConfig(max_depth=3))
        view = material_params()
        isect = build_intersector(scene, cfg)
        loss = render_loss_fn(camera, cfg, isect, view)
        frames = jnp.arange(spp, dtype=jnp.int32)
        target = jnp.zeros((width * width, 3), jnp.float32)
        fn = jax.jit(jax.value_and_grad(loss))
        val, g = fn(view.get(scene), scene, frames, target)
        return float(val), {k: np.asarray(v) for k, v in g.items()}

    val, g = grads(scene, camera, WIDTH // 4, 2)
    flat = np.concatenate([v.ravel() for v in g.values()])
    log(f"(f) sphere field {WIDTH // 4}² 2spp grad: loss {val:.6f}, |g| "
        f"{np.linalg.norm(flat):.4e}")
    check(bool(np.isfinite(flat).all()), "non-finite gradients")
    check(bool((flat != 0).any()), "all-zero gradients")
    out = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            cb, cam = cornell_box()
            out.append(grads(cb, cam, 32, 2))
    (lg, gg), (lc, gc) = out
    fg = np.concatenate([gg[k].ravel() for k in sorted(gg)])
    fc = np.concatenate([gc[k].ravel() for k in sorted(gc)])
    rel = float(np.linalg.norm(fg - fc) / np.linalg.norm(fc))
    log(f"  cornell 32² grad GPU vs CPU: rel {rel:.3e} (loss {lg:.6f} / "
        f"{lc:.6f})")
    check(rel <= 1e-3, "GPU and CPU gradients differ")
    results["grad_rel"] = rel


def phase_timing(renderer, results: dict):
    import jax

    ts = []
    for i in range(5):
        renderer.reset()
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render())
        ts.append(time.perf_counter() - t0)
        log(f"(g) render call {i}: {ts[-1] * 1e3:.1f} ms")
    med = float(np.median(ts))
    log(f"(g) main path {WIDTH}² x8 4spp: median {med * 1e3:.1f} ms per call "
        f"({med / 4 * 1e3:.1f} ms/spp)")
    results["render_median_s"] = med


def phase_multi(results: dict):
    """Sharded renderer, sharded training step and the sharded-scene ray
    ring on four GPUs, each compared with one GPU."""
    import jax
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import AccelType, IntegratorConfig, RenderConfig
    from mcrt_tpu.diff.estimators import material_params
    from mcrt_tpu.parallel.mesh import make_mesh
    from mcrt_tpu.parallel.render import (
        make_sharded_render, make_train_step, render_spp_batch,
    )
    from mcrt_tpu.parallel.ring import build_sharded_scene

    scene, camera = sphere_field()
    w = WIDTH // 2
    cfg = RenderConfig(width=w, height=w, spp=4, samples_per_pass=4,
                       integrator=IntegratorConfig(max_depth=4))
    isect = build_intersector(scene, cfg)
    frames = jnp.arange(4, dtype=jnp.int32)
    one = np.asarray(jax.jit(
        lambda s, f: render_spp_batch(s, camera, f, cfg, isect))(scene,
                                                                 frames))
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape)
        fn = make_sharded_render(scene, camera, cfg, isect, mesh)
        out = fn(scene, frames)
        used = {d.id for d in out.sharding.device_set}
        img = np.asarray(out)
        mad = float(np.abs(img - one).mean())
        med, ts = timed(fn, scene, frames, reps=3)
        log(f"sharded render {shape}: devices {sorted(used)}, mean |diff| "
            f"{mad:.3e} ({mad / one.mean():.3e} of mean), {med * 1e3:.1f} ms")
        check(len(used) == 4, f"sharded render used devices {used}")
        check(mad <= 1e-3 * float(one.mean()),
              f"sharded render {shape} differs from one GPU")
        results[f"render_{shape[0]}x{shape[1]}_ms"] = med * 1e3

    mesh = make_mesh(2, 2)
    view = material_params()
    step = make_train_step(camera, cfg, isect, mesh, view.get, view.set)
    loss, g = step(scene, frames, jnp.zeros((w * w, 3), jnp.float32))
    flat = np.concatenate([np.asarray(v).ravel() for v in g.values()])
    log(f"train step (2,2): loss {float(loss):.6f}, |g| "
        f"{np.linalg.norm(flat):.4e}")
    check(bool(np.isfinite(flat).all()) and bool((flat != 0).any()),
          "sharded gradients non-finite or zero")

    mesh = make_mesh(1, 4)
    sscene, ring = build_sharded_scene(scene, mesh)
    rays = primary_rays(camera, WIDTH)
    rep = build_intersector(scene, RenderConfig(accel=AccelType.BLOCKED))
    h_ring = jax.jit(ring.intersect)(sscene, rays)
    h_rep = jax.jit(rep.intersect)(scene, rays)
    # the ring's prim ids index the sharded face order: compare shape ids
    as_shape = lambda x: jax.tree.map(np.asarray, x.replace(prim=x.shape))
    compare_hits("ring closest vs replicated", as_shape(h_rep),
                 as_shape(h_ring))
    results["multi"] = "ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phases")
    args = ap.parse_args(argv)
    try:
        devs = phase_device(args.multi)
        results: dict = {}
        if args.multi:
            phase_multi(results)
        else:
            scene, camera = phase_queries(results)
            renderer = phase_main(scene, camera, results)
            phase_cpu_vs_gpu(results)
            phase_bdpt(scene, camera, results)
            phase_grad(scene, camera, results)
            phase_timing(renderer, results)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    os.makedirs("chiprun_out", exist_ok=True)
    name = "chip_smoke_multi.json" if args.multi else "chip_smoke.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
