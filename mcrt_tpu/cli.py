"""Command-line interface.

New capability (the reference is GUI-only — scene switching, settings and
render control all live in the ImGui editor, ``GUI/PathTracingGUI.cpp``;
SURVEY §5 config notes there are no CLI flags or config files).  The CLI
exposes the same knob set as typed YAML + flags:

    python -m mcrt_tpu render --scene cornell --out out.png --spp 64
    python -m mcrt_tpu render --config render.yaml --obj scene.obj
    python -m mcrt_tpu info
    python -m mcrt_tpu bench --scene bunny_field
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _load_config(args) -> "RenderConfig":
    from .config import RenderConfig, from_dict, replace
    from .config import IntegratorConfig, IntegratorType

    if args.config:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                "--config reads YAML and needs PyYAML, which is not "
                "installed") from e

        with open(args.config) as f:
            cfg = from_dict(yaml.safe_load(f) or {})
    else:
        cfg = RenderConfig()
    over = {}
    if args.width:
        over["width"] = args.width
    if args.height:
        over["height"] = args.height
    if args.spp:
        over["spp"] = args.spp
    if over:
        cfg = replace(cfg, **over)
    integ = {}
    if args.max_depth:
        integ["max_depth"] = args.max_depth
    if args.integrator:
        integ["type"] = IntegratorType(args.integrator)
    if integ:
        cfg = replace(cfg, integrator=replace(cfg.integrator, **integ))
    return cfg


def _load_scene(args):
    from .scene import builders

    if args.obj:
        return builders.scene_from_obj(args.obj)
    maker = getattr(builders, args.scene, None)
    if maker is None:
        sys.exit(f"unknown scene {args.scene!r}; use cornell_box / "
                 f"bunny_field / textured_hall / glass_gallery / "
                 f"heavy_gallery / instanced_boxes / bunny_field_instanced "
                 f"or --obj FILE")
    return maker()


def cmd_render(args) -> int:
    import numpy as np

    from .renderer import Renderer
    from .utils.image import write_png

    cfg = _load_config(args)
    scene, camera = _load_scene(args)
    t0 = time.time()
    r = Renderer(scene, camera, cfg)
    if args.progressive:
        # progressive-viewer stand-in (the reference's interactive loop
        # accumulates spp across frames and displays continuously,
        # RTPathTracingPass + RTDisplayPass): write the current accumulated
        # image every --progressive spp so convergence can be watched
        per_pass = cfg.samples_per_pass
        interval = max(args.progressive, per_pass)
        next_dump = interval
        while int(r.accum.frame) < cfg.spp and not r.stopped():
            r.step(1)
            spp_done = int(r.accum.frame)
            if spp_done >= next_dump or spp_done >= cfg.spp:
                img = np.asarray(r.display_image())
                write_png(args.out, img.reshape(cfg.height, cfg.width, 3))
                print(f"  {spp_done}/{cfg.spp} spp "
                      f"({time.time() - t0:.1f}s) -> {args.out}",
                      flush=True)
                next_dump += interval
        img = np.asarray(r.display_image())
    else:
        img = np.asarray(r.render())
    dt = time.time() - t0
    write_png(args.out, img.reshape(cfg.height, cfg.width, 3))
    n_rays = cfg.width * cfg.height * cfg.spp * (cfg.integrator.max_depth + 1)
    print(f"rendered {cfg.width}x{cfg.height} @ {cfg.spp} spp "
          f"in {dt:.2f}s (~{n_rays / dt / 1e6:.1f} Mrays/s upper bound) "
          f"-> {args.out}")
    return 0


def cmd_view(args) -> int:
    """Progressive viewer: serve the accumulating render over HTTP with
    camera-orbit and material edits (the GUI/editor stand-in,
    ``PathTracingGUI.cpp:32`` / ``RTDisplayPass.cpp:15-24``)."""
    from .renderer import Renderer
    from .viewer import ProgressiveViewer

    cfg = _load_config(args)
    scene, camera = _load_scene(args)
    r = Renderer(scene, camera, cfg)
    v = ProgressiveViewer(r, host=args.host, port=args.port,
                          scene_name=("custom" if args.obj else args.scene))
    print(f"serving http://{args.host}:{v.port}/ "
          f"({cfg.width}x{cfg.height}, progressive)", flush=True)
    try:
        v.serve()
    except KeyboardInterrupt:
        pass
    finally:
        v.stop()
    return 0


def cmd_info(args) -> int:
    import jax

    from .runtime import enumerate_devices, device_memory_stats
    from .runtime.native import available as native_available

    print(f"jax {jax.__version__}")
    for d in enumerate_devices():
        mem = f"{d.memory_bytes / 2**30:.1f} GiB" if d.memory_bytes else "?"
        print(f"  device {d.index}: {d.kind} ({d.platform}), HBM {mem}")
    stats = device_memory_stats(0)
    if stats:
        used = stats.get("bytes_in_use", 0)
        print(f"  bytes in use: {used / 2**20:.1f} MiB")
    print(f"native library: {'available' if native_available() else 'absent'}")
    return 0


def cmd_bench(args) -> int:
    import os
    import subprocess

    env = dict(os.environ)
    if args.scene:
        env["BENCH_SCENE"] = args.scene
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    return subprocess.call([sys.executable, bench], env=env)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mcrt_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("--scene", default="cornell_box",
                    help="built-in scene (cornell_box, bunny_field)")
    pr.add_argument("--obj", default=None, help="OBJ file to render")
    pr.add_argument("--config", default=None, help="YAML RenderConfig")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--spp", type=int, default=0)
    pr.add_argument("--max-depth", type=int, default=0)
    pr.add_argument("--integrator", choices=["path", "bdpt"], default=None)
    pr.add_argument("--progressive", type=int, default=0, metavar="N",
                    help="write the accumulated image every N spp "
                         "(progressive-viewer stand-in)")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("view", help="progressive HTTP viewer with edits")
    pv.add_argument("--scene", default="cornell_box")
    pv.add_argument("--obj", default=None)
    pv.add_argument("--config", default=None)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--width", type=int, default=0)
    pv.add_argument("--height", type=int, default=0)
    pv.add_argument("--spp", type=int, default=0)
    pv.add_argument("--max-depth", type=int, default=0)
    pv.add_argument("--integrator", choices=["path", "bdpt"], default=None)
    pv.add_argument("--progressive", type=int, default=0)
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("info", help="device + runtime info")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--scene", default=None)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
