"""Frame renderer: the pass pipeline as one jitted function.

Replacement for the reference's ``RenderPipeline`` pass sequencer +
blackboard (``engine/rendering/architecture/RenderPipeline.h:10-94``): where
the reference chains RTPrimaryRays → RTPathTracing → RTReconstruction →
RTDenoise → RTToneMapping passes with device syncs between them (SURVEY §3.2),
here primary-ray generation, the full bounce loop, and filter-weighted
accumulation compile into a *single* XLA program per frame; denoise/tonemap
are applied on the resolved image only when displaying.
"""
from __future__ import annotations

import functools
import time as _time

import jax
import jax.numpy as jnp

from .accel import Intersector, build_intersector
import numpy as _np
from .camera.pinhole import PinholeCamera, pixel_uv
from .config import IntegratorType, RenderConfig
from .film.accumulate import Accumulator, accumulate
from .film.denoise import bilateral
from .film.tonemap import reinhard
from .integrators import path as path_integrator
from .sampling import rng
from .scene.scene import Scene


def _radical_inverse(i: jax.Array, base: int) -> jax.Array:
    """Halton radical inverse for the frame-wide TAA jitter sequence — the
    reference uses host Sobol for this (``PathTracingApp.cpp:208-215``)."""
    def body(_, carry):
        val, inv, x = carry
        d = x % base
        x = x // base
        inv = inv / base
        return val + d.astype(jnp.float32) * inv, inv, x

    val, _, _ = jax.lax.fori_loop(
        0, 32, body, (jnp.zeros_like(i, jnp.float32), jnp.asarray(1.0), i)
    )
    return val


def frame_jitter(frame: jax.Array) -> jax.Array:
    """(2,) sub-pixel offset in [-0.5, 0.5) for this frame."""
    f = frame.astype(jnp.int32)
    return jnp.stack(
        [_radical_inverse(f + 1, 2) - 0.5, _radical_inverse(f + 1, 3) - 0.5]
    )


@functools.lru_cache(maxsize=8)
def _morton_pixel_order(w: int, h: int):
    """2D Morton pixel permutation (and its inverse): rays are traced in
    Z-order so each intersector tile covers a compact screen square — the
    warp-coherence mitigation from SURVEY §7 'hard parts' (1).  Static per
    resolution; applied as two constant gathers per sample."""
    xs = _np.arange(w * h, dtype=_np.uint64) % w
    ys = _np.arange(w * h, dtype=_np.uint64) // w

    def expand(x):
        x = (x | (x << _np.uint64(8))) & _np.uint64(0x00FF00FF)
        x = (x | (x << _np.uint64(4))) & _np.uint64(0x0F0F0F0F)
        x = (x | (x << _np.uint64(2))) & _np.uint64(0x33333333)
        x = (x | (x << _np.uint64(1))) & _np.uint64(0x55555555)
        return x

    code = (expand(xs) << _np.uint64(1)) | expand(ys)
    order = _np.argsort(code, kind="stable").astype(_np.int32)
    inv = _np.empty_like(order)
    inv[order] = _np.arange(w * h, dtype=_np.int32)
    return order, inv


def render_sample(
    scene: Scene,
    camera: PinholeCamera,
    frame: jax.Array,
    cfg: RenderConfig,
    intersector: Intersector,
) -> tuple[jax.Array, jax.Array]:
    """Render one sample-per-pixel wavefront; returns ((H*W, 3) radiance,
    (2,) jitter used)."""
    w, h = cfg.width, cfg.height
    n = w * h
    jitter = frame_jitter(frame)
    uv = pixel_uv(w, h, jitter=jitter[None, :])
    order, inv_order = _morton_pixel_order(w, h)
    uv = jnp.take(uv, jnp.asarray(order), axis=0)  # trace in Z-order
    o, d = camera.generate_rays(uv)
    diff = camera.generate_ray_differentials(uv, w, h)
    from .core.types import Rays

    rays = Rays.make(o, d)
    pixel_ids = jnp.asarray(order)  # per-pixel RNG streams stay pixel-keyed
    stream = rng.make_stream(cfg.sampler, frame, pixel_ids)
    if cfg.integrator.type == IntegratorType.PATH:
        radiance = path_integrator.trace(
            scene, rays, stream, cfg.integrator,
            intersector.intersect, intersector.occluded,
            diff=diff,
        )
    else:
        from .integrators import bdpt as bdpt_integrator

        radiance = bdpt_integrator.trace(
            scene, camera, rays, stream, cfg.integrator,
            intersector.intersect, intersector.occluded,
            film=(w, h), slot_of_pixel=jnp.asarray(inv_order),
        )
    radiance = jnp.take(radiance, jnp.asarray(inv_order), axis=0)
    return radiance, jitter


def render_frame_fn(
    scene: Scene,
    camera: PinholeCamera,
    accum: Accumulator,
    frame: jax.Array,
    cfg: RenderConfig,
    intersector: Intersector,
) -> Accumulator:
    """One progressive frame: trace `samples_per_pass` wavefronts and fold
    them into the accumulator (``reconstruction.cl:6-60`` analogue)."""

    def one(i, acc):
        # `frame` is the number of samples already accumulated (accum.frame
        # advances once per sample inside this loop)
        f = frame + i
        radiance, jitter = render_sample(scene, camera, f, cfg, intersector)
        return accumulate(
            acc, radiance, jitter, cfg.filter, cfg.integrator.max_radiance
        )

    return jax.lax.fori_loop(0, cfg.samples_per_pass, one, accum)


class Renderer:
    """Host-side orchestrator — the ``PathTracingApp``/``RenderPipeline``
    analogue. Owns the compiled frame function and the accumulator."""

    def __init__(self, scene: Scene, camera: PinholeCamera, cfg: RenderConfig):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.intersector = build_intersector(scene, cfg)
        self.accum = Accumulator.zeros(cfg.width, cfg.height)
        self._render_start = None
        self._refit_fn = None  # jit(refit_blocked)
        self._refit2_fn = None  # jit(refit_two_level_scene)
        self._make_frame_fn()

    def _make_frame_fn(self):
        """(Re)bind the compiled frame function.  For the blocked and
        two-level accels the accel pytree is a jit ARGUMENT, not a captured
        constant — so a refit-edit (same topology, new geometry/transforms)
        reuses the compiled program with the refitted accel instead of
        recompiling."""
        from .accel import blocked_intersector, two_level_intersector
        from .accel.pallas_blocked import BlockedAccel
        from .accel.two_level import TwoLevelAccel

        cfg = self.cfg
        acc = self.intersector.accel
        if isinstance(acc, (BlockedAccel, TwoLevelAccel)):
            bind = (blocked_intersector if isinstance(acc, BlockedAccel)
                    else two_level_intersector)

            def fn(scene, camera, accum, frame, accel):
                return render_frame_fn(
                    scene, camera, accum, frame, cfg=cfg,
                    intersector=bind(accel),
                )

            self._frame_fn = jax.jit(fn)
            self._accel_arg = True
        else:
            self._frame_fn = jax.jit(
                functools.partial(
                    render_frame_fn, cfg=cfg, intersector=self.intersector
                )
            )
            self._accel_arg = False

    def reset(self):
        """Accumulation reset on camera move / scene edit
        (``RTPathTracingPass.cpp:49-53``)."""
        self.accum = self.accum.reset()
        self._render_start = None

    def update_scene(self, scene: Scene, rebuild_accel: bool = True):
        """Swap in an edited scene — the ``RTScene::updateDynamicEntities`` →
        ``Commit`` → notify-integrators path (``RTScene.cpp:317-391``,
        SURVEY §3.4): rebuild or refit the accel and reset accumulation.

        Transform-only edits take the in-jit ``refit_blocked`` path instead
        of a host rebuild — the reference's refit-via-``Commit`` from the
        same scene-update entry point (``RTScene.cpp:317-391``).  Topology
        sameness is detected structurally: an edit produced by
        ``scene.replace`` / ``SceneAnimator.transformed`` shares the
        ``indices``/``face_valid`` leaves with the current scene, which is
        exactly the "moved vertices, same faces" contract refit requires.
        Material-only edits (same geometry) can pass
        ``rebuild_accel=False``."""
        from .accel import blocked_intersector, two_level_intersector
        from .accel.pallas_blocked import BlockedAccel, refit_blocked
        from .accel.two_level import TwoLevelAccel, refit_two_level_scene

        old = self.scene
        self.scene = scene
        if rebuild_accel:
            acc = self.intersector.accel
            same_faces = (
                scene.geometry.indices is old.geometry.indices
                and scene.geometry.face_valid is old.geometry.face_valid
            )
            if isinstance(acc, BlockedAccel) and same_faces:
                if self._refit_fn is None:
                    self._refit_fn = jax.jit(refit_blocked)
                self.intersector = blocked_intersector(
                    self._refit_fn(acc, scene.geometry))
            elif (isinstance(acc, TwoLevelAccel) and same_faces
                  and scene.geometry.positions is old.geometry.positions):
                # instance-transform-only edit: recompute pair boxes in-jit
                if self._refit2_fn is None:
                    self._refit2_fn = jax.jit(refit_two_level_scene)
                self.intersector = two_level_intersector(
                    self._refit2_fn(acc, scene))
            else:
                self.intersector = build_intersector(scene, self.cfg)
                self._make_frame_fn()
        self.reset()

    def update_camera(self, camera: PinholeCamera):
        """Camera move: swap + accumulation reset (the reference's
        ``bMovedInLastUpdate`` signal, SURVEY §2c camera layer)."""
        self.camera = camera
        self.reset()

    def step(self, n_frames: int = 1):
        for _ in range(n_frames):
            if self.stopped():
                break
            if self._accel_arg:
                self.accum = self._frame_fn(
                    self.scene, self.camera, self.accum, self.accum.frame,
                    self.intersector.accel,
                )
            else:
                self.accum = self._frame_fn(
                    self.scene, self.camera, self.accum, self.accum.frame
                )
        return self.accum

    def stopped(self) -> bool:
        """Pause conditions — the reference's stopAtFrame/stopAtTime
        (``RTPathTracingPass.cpp:56-58``)."""
        if self.cfg.stop_at_spp and int(self.accum.frame) >= self.cfg.stop_at_spp:
            return True
        if self.cfg.stop_at_time_s:
            if self._render_start is None:
                self._render_start = _time.monotonic()
            elif _time.monotonic() - self._render_start >= self.cfg.stop_at_time_s:
                return True
        return False

    def render(self, spp: int | None = None) -> jax.Array:
        """Render to `spp` samples per pixel and return the resolved image."""
        spp = spp if spp is not None else self.cfg.spp
        per_pass = self.cfg.samples_per_pass
        frames = -(-spp // per_pass)
        self.step(frames)
        return self.display_image()

    def display_image(self) -> jax.Array:
        """Resolve + optional denoise + tonemap (RTDenoisePass /
        RTToneMappingPass analogues)."""
        img = self.accum.image
        if self.cfg.denoise.enabled:
            img = bilateral(img, self.cfg.denoise)
        if self.cfg.tonemap.enabled:
            img = reinhard(img, self.cfg.tonemap)
        return img
