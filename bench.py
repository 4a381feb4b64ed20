"""Benchmark harness: rays/sec/chip + grad overhead + scaling metrics.

Prints ONE JSON line to stdout:
  {"metric": "rays/sec/chip", "value": N, "unit": "...", ...}
Diagnostics (per-phase breakdown) go to stderr.

PRIMARY metric: `bunny_field` — 243,434 triangles, 512x512 @ 8 bounces,
Sobol — the scene that exercises the production traversal path (block
cull, visit-list sort, list-driven traversal).  The reference publishes no
numbers (BASELINE.md).

Secondary metrics (BASELINE.md):
- `secondary_textured_hall`: rays/s on the textured+normal-mapped uber
  material scene (feature coverage).
- grad-pass overhead: (forward+backward time) / (forward time) of the
  differentiable render loss at 128x128.
- `per_sample_throughput_ratio_8dev`: t1 / (t8 / 8) of the spp-sharded
  renderer on an 8-virtual-CPU-device mesh.  NOT a scaling efficiency —
  8 virtual devices share one host's cores, so this isolates collective +
  sharding overhead only.
- `ring_overhead_ratio`: sharded-scene ray-ring intersector cost vs the
  replicated blocked intersector on the same rays (8-CPU-device mesh) —
  the comm + re-query overhead of scene sharding (SURVEY §2e ray ring).

Both ratios run in subprocesses pinned to the CPU, so they never open the
GPU.  Ray counts come from a separate instrumented run that sums actual
active lanes per bounce (closest hits + NEE shadow rays), matching how the
reference's wavefront issues queries (SURVEY §3.2: (1 + maxDepth)
intersections + maxDepth occlusions).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def count_rays_per_sample(scene, camera, cfg, intersector):
    """Instrumented pass: actual rays traced for one spp (closest + shadow),
    jitted as one program."""
    return float(jax.jit(
        functools.partial(
            _count_rays_traced, camera=camera, cfg=cfg, intersector=intersector
        )
    )(scene))


def _count_rays_traced(scene, camera, cfg, intersector):
    from mcrt_tpu.bsdf import uber
    from mcrt_tpu.bsdf.materials import fetch_bsdf
    from mcrt_tpu.core import math as m
    from mcrt_tpu.core.types import Rays
    from mcrt_tpu.camera.pinhole import pixel_uv
    from mcrt_tpu.sampling import rng
    from mcrt_tpu.scene.interaction import compute_interaction, spawn_ray

    # trace with counting: emulate the integrator's activity masks
    n = cfg.width * cfg.height
    uv = pixel_uv(cfg.width, cfg.height)
    o, d = camera.generate_rays(uv)
    rays = Rays.make(o, d)
    stream = rng.make_stream(cfg.sampler, jnp.asarray(0), jnp.arange(n))

    count = jnp.asarray(0.0)
    tp_active = jnp.ones((n,), bool)
    icfg = cfg.integrator
    for bounce in range(icfg.max_depth):
        count = count + tp_active.sum(dtype=jnp.float32)  # closest-hit query
        hit = intersector.intersect(scene, rays)
        alive = tp_active & hit.valid
        it = compute_interaction(scene, rays, hit)
        bsdf, it = fetch_bsdf(scene, it)
        u_pick, stream = rng.next_1d(stream)
        u_light, stream = rng.next_2d(stream)
        u_bsdf, stream = rng.next_3d(stream)
        nee = alive & bsdf.has_non_delta() & (scene.lights.num > 0)
        count = count + nee.sum(dtype=jnp.float32)  # shadow query
        wo_l = m.to_local(it.dpdu, it.dpdv, it.ns, it.wo)
        bs = uber.sample(bsdf, wo_l, u_bsdf)
        wi_w = m.to_world(it.dpdu, it.dpdv, it.ns, bs.wi)
        extend = alive & bs.valid
        rays = spawn_ray(it, wi_w, icfg.trace_offset, icfg.max_trace_distance, extend)
        tp_active = extend
    return count


def measure_grad_overhead(scene, camera):
    """(forward+backward) / forward time of the render loss (BASELINE
    metric 2), at a size small enough to keep bench runtime sane."""
    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import IntegratorConfig, RenderConfig
    from mcrt_tpu.diff.estimators import material_params, render_loss_fn

    cfg = RenderConfig(width=128, height=128, spp=2,
                       integrator=IntegratorConfig(max_depth=3))
    intersector = build_intersector(scene, cfg)
    view = material_params()
    loss = render_loss_fn(camera, cfg, intersector, view)
    params = view.get(scene)
    frames = jnp.arange(2, dtype=jnp.int32)
    target = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)

    fwd = jax.jit(lambda p: loss(p, scene, frames, target))
    both = jax.jit(lambda p: jax.value_and_grad(loss)(p, scene, frames, target))

    float(fwd(params))  # compile + sync
    t0 = time.time()
    for _ in range(3):
        v = fwd(params)
    _ = float(v)
    t_fwd = (time.time() - t0) / 3

    v, g = both(params)
    _ = float(v)
    t0 = time.time()
    for _ in range(3):
        v, g = both(params)
    _ = float(v)
    t_both = (time.time() - t0) / 3
    log(f"grad overhead: fwd {t_fwd*1e3:.1f} ms, fwd+bwd {t_both*1e3:.1f} ms")
    return t_both / t_fwd


def measure_bdpt(scene, camera):
    """BDPT ms/spp at 128x128 (VERDICT r2 item 6: BDPT in the bench).
    Diagnostic scale — BDPT's per-sample cost is O(maxDepth^2) connection
    strategies (RTBDPTPass.cpp:442-488), so it runs small.

    Timing is per-iteration with a hard ``block_until_ready`` sync on EVERY
    call (VERDICT r4 item 1a: the round-4 artifact carried a 17x-understated
    figure from a run whose back-to-back dispatch loop did not see the real
    device time; per-iteration sync cannot drift).  Every iteration's wall
    time goes to stderr so the artifact is self-evidencing; the reported
    figure is the median."""
    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import IntegratorConfig, IntegratorType, RenderConfig
    from mcrt_tpu.renderer import render_sample

    cfg = RenderConfig(
        width=128, height=128, spp=1,
        integrator=IntegratorConfig(type=IntegratorType.BDPT, max_depth=3),
    )
    intersector = build_intersector(scene, cfg)
    fn = jax.jit(lambda s, f: jnp.sum(
        render_sample(s, camera, f, cfg, intersector)[0]))
    f0 = jnp.asarray(0, jnp.int32)
    jax.block_until_ready(fn(scene, f0))  # compile + sync
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(scene, f0 + i))
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    log(f"bdpt: {med*1e3:.1f} ms/spp at 128x128, depth 3 "
        f"(per-iter ms: {', '.join(f'{t*1e3:.1f}' for t in times)})")
    return med * 1e3


_SCALING_SNIPPET = r"""
import json, os, time
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from mcrt_tpu.config import IntegratorConfig, RenderConfig
from mcrt_tpu.accel import build_intersector
from mcrt_tpu.parallel.mesh import make_mesh
from mcrt_tpu.parallel.render import render_spp_batch
from mcrt_tpu.scene.builders import cornell_box

# weak scaling: spp == n_dev, one sample per device -> ideal time is flat
n_dev = int(os.environ["SCALE_NDEV"])
scene, camera = cornell_box()
cfg = RenderConfig(width=128, height=128, spp=n_dev,
                   integrator=IntegratorConfig(max_depth=2))
intersector = build_intersector(scene, cfg)
mesh = make_mesh(n_spp=8) if n_dev > 1 else None
frames = jnp.arange(n_dev, dtype=jnp.int32)
fn = jax.jit(lambda s, f: jnp.sum(
    render_spp_batch(s, camera, f, cfg, intersector, mesh)))
float(fn(scene, frames))
t0 = time.time()
for i in range(4):
    acc = fn(scene, frames + n_dev * i)
_ = float(acc)
print(json.dumps({"n_dev": n_dev, "dt": (time.time() - t0) / 4}))
"""


def measure_scaling() -> float:
    """1 -> 8 virtual-CPU-device scaling efficiency of the spp-sharded
    renderer (relative rays/s; BASELINE metric 3 on virtual devices)."""
    results = {}
    for n_dev in (1, 8):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": (env.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8").strip(),
            "SCALE_NDEV": str(n_dev),
            "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
        })
        out = subprocess.run([sys.executable, "-c", _SCALING_SNIPPET],
                             capture_output=True, text=True, env=env,
                             timeout=1200)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if not line:
            log(f"scaling run n_dev={n_dev} failed: {out.stderr[-500:]}")
            return float("nan")
        results[n_dev] = json.loads(line[-1])["dt"]
        log(f"scaling: {n_dev} dev -> {results[n_dev]*1e3:.1f} ms/call")
    # weak scaling (spp == n_dev): the 8-dev call renders 8x the samples.
    # The 8 virtual devices SHARE one physical CPU host, so even perfect
    # sharding cannot shrink wall-clock — the honest efficiency measure on
    # virtual devices is per-sample throughput: t1 / (t8 / 8).  It isolates
    # what virtual devices *can* measure (collective + sharding overhead);
    # real parallel speedup needs real devices.
    return results[1] / (results[8] / 8.0)


def measure_phases(scene, camera, cfg, intersector):
    """Per-phase breakdown of one closest-hit query on primary rays plus a
    scrambled (bounce-like incoherent) copy — the optimization map the
    VERDICT asked to ship with the bench (stderr only)."""
    from mcrt_tpu.accel.pallas_blocked import (
        BlockedAccel, _coherence_order, _pack_rays, _cull, _visit_lists,
    )
    from mcrt_tpu.camera.pinhole import pixel_uv
    from mcrt_tpu.core.types import Rays

    acc = intersector.accel
    if not isinstance(acc, BlockedAccel):
        return
    uv = pixel_uv(cfg.width, cfg.height)
    o, d = camera.generate_rays(uv)
    rays = Rays.make(o, d)

    def timed(fn, *args, n=5):
        jax.block_until_ready(fn(*args))
        t0 = time.time()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.time() - t0) / n

    coh = jax.jit(lambda r: _coherence_order(r, acc.bounds))
    t_coh = timed(coh, rays)

    @jax.jit
    def packed_fn(r):
        order = _coherence_order(r, acc.bounds)
        rq = jax.tree.map(lambda a: jnp.take(a, order, axis=0), r)
        return _pack_rays(rq)

    packed = packed_fn(rays)
    t_pack = max(timed(packed_fn, rays) - t_coh, 0.0)
    cull_fn = jax.jit(lambda p: _cull(p, acc.aabb))
    t_cull = timed(cull_fn, packed)
    lists_fn = jax.jit(lambda p: _visit_lists(p, acc.aabb))
    t_sort = max(timed(lists_fn, packed) - t_cull, 0.0)
    isect = jax.jit(lambda r: intersector.intersect(scene, r))
    t_tot = timed(isect, rays, n=3)
    t_trav = max(t_tot - t_coh - t_pack - t_cull - t_sort, 0.0)
    log(f"phase breakdown (primary query): argsort {t_coh*1e3:.1f} ms, "
        f"pack {t_pack*1e3:.1f} ms, cull {t_cull*1e3:.1f} ms, "
        f"list-sort {t_sort*1e3:.1f} ms, traverse+resolve {t_trav*1e3:.1f} ms"
        f" -> total {t_tot*1e3:.1f} ms")


def measure_secondary(width, height, depth, spp_per_call):
    """Feature-coverage line: textured_hall (44 tris, textures + normal
    maps + point/dir lights)."""
    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import (
        IntegratorConfig, RenderConfig, SamplerConfig, SamplerType,
    )
    from mcrt_tpu.parallel.render import render_spp_batch
    from mcrt_tpu.scene import builders

    scene, camera = builders.textured_hall()
    cfg = RenderConfig(
        width=width, height=height, spp=spp_per_call,
        sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=depth),
    )
    intersector = build_intersector(scene, cfg)
    rays_per_call = count_rays_per_sample(
        scene, camera, cfg, intersector) * spp_per_call

    @jax.jit
    def render(scene_in, frames):
        return jnp.sum(render_spp_batch(scene_in, camera, frames, cfg,
                                        intersector))

    frames = jnp.arange(spp_per_call, dtype=jnp.int32)
    float(render(scene, frames))
    t0 = time.time()
    for i in range(4):
        acc = render(scene, frames + i * spp_per_call)
    _ = float(acc)
    dt = time.time() - t0
    rs = rays_per_call * 4 / dt
    log(f"secondary textured_hall: {rs:,.0f} rays/s "
        f"({dt / (4 * spp_per_call) * 1e3:.1f} ms/spp)")
    return rs


_RING_SNIPPET = r"""
import json, time
import jax, jax.numpy as jnp
import numpy as np
jax.config.update("jax_platforms", "cpu")
from mcrt_tpu.accel import build_intersector
from mcrt_tpu.camera.pinhole import pixel_uv
from mcrt_tpu.config import AccelType, RenderConfig
from mcrt_tpu.core.types import Rays
from mcrt_tpu.parallel.mesh import make_mesh
from mcrt_tpu.parallel.ring import build_sharded_scene
from mcrt_tpu.scene.builders import SceneBuffers, icosphere, quad
from mcrt_tpu.scene.scene import UberMaterial, build_scene

# mid-size procedural scene (~5.2k tris): 16 icospheres + floor, so each
# of the 8 shards holds ~650 triangles and per-shard culling has work to
# do (cornell's 36 tris/shard measured kernel overhead, not the ring)
sb = SceneBuffers()
p, i = quad([-6, 0, 6], [6, 0, 6], [6, 0, -6], [-6, 0, -6])
sb.add_mesh(p, i, 0)
for gx in range(4):
    for gz in range(4):
        p, i, _ = icosphere(((gx - 1.5) * 2.2, 0.7, (gz - 1.5) * 2.2),
                            0.65, subdiv=2)
        sb.add_mesh(p, i, 0)
positions, normals, uvs, indices, face_shape, sm, sl = sb.concat()
scene = build_scene(positions, normals, uvs, indices, face_shape, sm,
                    [UberMaterial(diffuse=(0.6,) * 3)], shape_light=sl)

from mcrt_tpu.camera.pinhole import PinholeCamera
camera = PinholeCamera.look_at(eye=(0.0, 5.0, 9.0), target=(0.0, 0.5, 0.0),
                               fov_deg=50.0, aspect=1.0)
uv = pixel_uv(128, 128)
o, d = camera.generate_rays(uv)
rays = Rays.make(o, d)
mesh = make_mesh(n_spp=1, n_rays=len(jax.devices()))
sscene, ring = build_sharded_scene(scene, mesh, use_blocked=True)
# like-for-like baseline (VERDICT r4 item 4): the SAME blocked engine,
# replicated — so the ratio isolates ring comm + per-shard re-query cost,
# not a kernel-vs-kernel difference
cfg = RenderConfig(width=128, height=128, accel=AccelType.BLOCKED)
rep = build_intersector(scene, cfg)

def run(fn, s, r, reps=4):
    jax.block_until_ready(fn(s, r))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(s, r))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]

j_ring = jax.jit(lambda s, r: ring.intersect(s, r).t.sum())
j_rep = jax.jit(lambda s, r: rep.intersect(s, r).t.sum())
t_ring = run(j_ring, sscene, rays)
t_rep = run(j_rep, scene, rays)
print(json.dumps({"t_ring": t_ring, "t_rep": t_rep,
                  "tris": int(np.asarray(scene.geometry.face_valid).sum())}))
"""


def measure_ring() -> float:
    """Ring-sharded intersector cost vs the REPLICATED BLOCKED intersector
    on the same rays and scene, 8-CPU-device mesh (VERDICT r4 item 4:
    like-for-like baseline).  Both sides run the blocked kernels in
    interpret mode on the CPU, so absolute times say nothing of a GPU —
    the ratio isolates ring ppermute + 8x re-query overhead against one
    replicated query of the same engine."""
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": (env.get("XLA_FLAGS", "")
                      + " --xla_force_host_platform_device_count=8").strip(),
        "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
    })
    out = subprocess.run([sys.executable, "-c", _RING_SNIPPET],
                         capture_output=True, text=True, env=env,
                         timeout=2400)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if not line:
        log(f"ring run failed: {out.stderr[-500:]}")
        return float("nan")
    r = json.loads(line[-1])
    log(f"ring: {r['t_ring']*1e3:.1f} ms vs replicated-blocked "
        f"{r['t_rep']*1e3:.1f} ms per query "
        f"({r['tris']} tris, 8 shards, 8-CPU-dev interpret)")
    return r["t_ring"] / r["t_rep"]


def main():
    scene_name = os.environ.get("BENCH_SCENE", "bunny_field")
    width = int(os.environ.get("BENCH_WIDTH", "512"))
    height = int(os.environ.get("BENCH_HEIGHT", "512"))
    depth = int(os.environ.get("BENCH_DEPTH", "8"))
    spp_per_call = int(os.environ.get("BENCH_SPP_PER_CALL", "4"))
    calls = int(os.environ.get("BENCH_CALLS", "8"))
    skip_extras = os.environ.get("BENCH_SKIP_EXTRAS", "0") == "1"

    from mcrt_tpu.accel import build_intersector
    from mcrt_tpu.config import (
        AccelType, BuilderType, BVHConfig, IntegratorConfig, RenderConfig,
        SamplerConfig, SamplerType,
    )
    from mcrt_tpu.parallel.render import render_spp_batch
    from mcrt_tpu.scene import builders

    accel = AccelType(os.environ.get("BENCH_ACCEL", "auto"))
    builder = BuilderType(os.environ.get("BENCH_BUILDER", "sah"))
    scene, camera = getattr(builders, scene_name)()

    cfg = RenderConfig(
        width=width, height=height, spp=spp_per_call, accel=accel,
        bvh=BVHConfig(builder=builder),
        sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=depth),
    )
    intersector = build_intersector(scene, cfg)

    @jax.jit
    def render(scene_in, frames):
        img = render_spp_batch(scene_in, camera, frames, cfg, intersector)
        return jnp.sum(img)  # scalar readback only

    # rays per full spp-batch call
    rays_per_sample = count_rays_per_sample(scene, camera, cfg, intersector)
    rays_per_call = rays_per_sample * spp_per_call

    # warmup / compile
    frames = jnp.arange(spp_per_call, dtype=jnp.int32)
    np.asarray(render(scene, frames))

    t0 = time.time()
    acc = None
    for i in range(calls):
        acc = render(scene, frames + i * spp_per_call)
    _ = float(acc)  # sync
    dt = time.time() - t0

    rays_per_sec = rays_per_call * calls / dt
    n_chips = jax.device_count()

    ms_per_spp = dt / (calls * spp_per_call) * 1e3
    log(f"breakdown: {ms_per_spp:.1f} ms/spp at {width}x{height}, "
        f"{depth} bounces ({scene_name}, sobol)")

    grad_ratio = float("nan")
    scaling = float("nan")
    bdpt_ms = float("nan")
    secondary = float("nan")
    ring_ratio = float("nan")
    if not skip_extras:
        try:
            measure_phases(scene, camera, cfg, intersector)
        except Exception as e:  # pragma: no cover - diagnostics only
            log(f"phase breakdown failed: {e}")
        try:
            secondary = measure_secondary(width, height, depth, spp_per_call)
        except Exception as e:  # pragma: no cover
            log(f"secondary scene measurement failed: {e}")
        try:
            grad_ratio = measure_grad_overhead(scene, camera)
        except Exception as e:  # pragma: no cover
            log(f"grad overhead measurement failed: {e}")
        try:
            bdpt_ms = measure_bdpt(scene, camera)
        except Exception as e:  # pragma: no cover
            log(f"bdpt measurement failed: {e}")
        try:
            scaling = measure_scaling()
        except Exception as e:  # pragma: no cover
            log(f"scaling measurement failed: {e}")
        try:
            ring_ratio = measure_ring()
        except Exception as e:  # pragma: no cover
            log(f"ring measurement failed: {e}")

    def _r(x, nd=2):
        return None if x != x else round(x, nd)

    result = {
        "metric": "rays/sec/chip",
        "value": round(rays_per_sec / n_chips),
        "unit": (f"rays/s ({scene_name} {width}x{height}, {depth} bounces, "
                 f"sobol, accel={cfg.accel.value})"),
        "secondary_textured_hall_rays_s": _r(secondary, 0),
        "grad_overhead_ratio": _r(grad_ratio),
        "per_sample_throughput_ratio_8dev": _r(scaling, 3),
        "ring_overhead_ratio": _r(ring_ratio),
        "bdpt_ms_per_spp_128": _r(bdpt_ms, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
