"""Progressive HTTP viewer — the interactive-editor stand-in.

Closes the reference's last application-layer component
(``GUI/PathTracingGUI.cpp:32`` ImGui editor + ``RTDisplayPass.cpp:15-24``
display): a headless-friendly live view of the accumulating image plus the
two interactive edit loops the reference's GUI drives —

- **camera move** -> accumulation reset (``FreeCameraViewController``'s
  ``bMovedInLastUpdate`` signal feeding ``RTPathTracingPass.cpp:49-53``),
  exposed as orbit/dolly controls around the scene center;
- **material edit** -> scene re-upload + reset
  (``RTUberMaterialComponent`` dirty flag -> ``RTScene.cpp:370-390``),
  exposed as per-material diffuse/roughness setters;
- **light edit** -> lights-table re-upload + reset (the GUI's light
  editing, ``PathTracingGUI.cpp:106-118``; dynamic light updates
  ``RTScene.cpp:356-391``), exposed as per-light intensity/position
  setters;
- **scene switch** -> full scene + accel rebuild at runtime (the GUI's
  scene selector, ``PathTracingGUI.cpp:106-118`` /
  ``PathTracingApp::loadScene``).

Serves a single-page UI at ``/`` (auto-refreshing image + controls), the
current tonemapped frame at ``/image.png``, a JSON status line at
``/api/status`` (spp + resolution), and ``/api/stats`` — spp, render
time, samples/s, and device/accel memory — the ``StatsWindow`` +
spp/render-time/memory readout (``PathTracingGUI.cpp:110-117``,
``engine/gui/StatsWindow.cpp:12-49``).  The render loop runs in the
calling thread (``serve``); HTTP handlers only enqueue edits, which the
loop applies between progressive steps — the single-jit-stream
discipline.

Usage: ``python -m mcrt_tpu view --scene cornell_box --port 8000``.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>mcrt_tpu viewer</title><style>
body { background:#181818; color:#ddd; font-family:monospace; }
img { image-rendering:pixelated; width:512px; border:1px solid #444; }
button { margin:2px; } input { width: 56px; }
</style></head><body>
<h3>mcrt_tpu progressive viewer</h3>
<div><img id="view" src="/image.png"></div>
<div id="status">-</div>
<div>
 orbit:
 <button onclick="cam(-0.2,0)">&larr;</button>
 <button onclick="cam(0.2,0)">&rarr;</button>
 <button onclick="cam(0,0.15)">&uarr;</button>
 <button onclick="cam(0,-0.15)">&darr;</button>
 dolly:
 <button onclick="dolly(0.9)">+</button>
 <button onclick="dolly(1.1)">-</button>
</div>
<div>
 material <input id="mid" value="0"> diffuse
 <input id="r" value="0.6"> <input id="g" value="0.6"> <input id="b" value="0.6">
 roughness <input id="rough" value="">
 <button onclick="mat()">apply</button>
</div>
<div>
 light <input id="lid" value="0"> intensity
 <input id="lr" value=""> <input id="lg" value=""> <input id="lb" value="">
 position <input id="lx" value=""> <input id="ly" value=""> <input id="lz" value="">
 <button onclick="light()">apply</button>
</div>
<div>
 shape <input id="sid" value="0"> move
 <input id="sx" value="0"> <input id="sy" value="0"> <input id="sz" value="0">
 rotY <input id="sry" value=""> scale <input id="ss" value="">
 <button onclick="xform()">apply</button>
</div>
<div>
 scene <select id="scene"></select>
 <button onclick="loadScene()">load</button>
 <span id="stats"></span>
</div>
<script>
async function tick() {
  const s = await (await fetch('/api/status')).json();
  document.getElementById('status').textContent =
    s.width + 'x' + s.height + '  spp=' + s.spp;
  const st = await (await fetch('/api/stats')).json();
  document.getElementById('stats').textContent =
    ' ' + st.samples_per_sec.toFixed(2) + ' spp/s, ' +
    st.render_time_s.toFixed(1) + 's, accel ' +
    (st.accel_bytes/1e6).toFixed(1) + ' MB';
  document.getElementById('view').src = '/image.png?ts=' + Date.now();
}
setInterval(tick, 1000);
async function scenes() {
  const s = await (await fetch('/api/scenes')).json();
  const sel = document.getElementById('scene');
  for (const n of s.scenes) {
    const o = document.createElement('option');
    o.value = n; o.textContent = n; sel.appendChild(o);
  }
}
scenes();
function cam(yaw, pitch) {
  fetch('/api/camera?yaw=' + yaw + '&pitch=' + pitch);
}
function dolly(f) { fetch('/api/camera?dolly=' + f); }
function mat() {
  const q = new URLSearchParams({
    id: document.getElementById('mid').value,
    r: document.getElementById('r').value,
    g: document.getElementById('g').value,
    b: document.getElementById('b').value,
    roughness: document.getElementById('rough').value,
  });
  fetch('/api/material?' + q);
}
function light() {
  const v = id => document.getElementById(id).value;
  const q = new URLSearchParams({id: v('lid'), ir: v('lr'), ig: v('lg'),
    ib: v('lb'), x: v('lx'), y: v('ly'), z: v('lz')});
  fetch('/api/light?' + q);
}
function loadScene() {
  fetch('/api/scene?name=' + document.getElementById('scene').value);
}
function xform() {
  const v = id => document.getElementById(id).value;
  const q = new URLSearchParams({shape: v('sid'), x: v('sx'), y: v('sy'),
    z: v('sz'), ry: v('sry'), s: v('ss')});
  fetch('/api/transform?' + q);
}
</script></body></html>
"""

# demo scenes selectable at runtime (PathTracingApp's 5 scene descriptors,
# PathTracingApp.cpp:348-407)
SCENES = ("cornell_box", "glass_gallery", "textured_hall", "bunny_field",
          "heavy_gallery")


class ProgressiveViewer:
    """Owns a :class:`~mcrt_tpu.renderer.Renderer` and serves its
    accumulator over HTTP while stepping it progressively."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000,
                 scene_name: str = "custom"):
        self.renderer = renderer
        self._edits: list = []
        self._edit_lock = threading.Lock()
        self._stop = threading.Event()
        self._scene_name = scene_name
        self._render_time = 0.0  # wall seconds spent rendering samples
        self._rate = 0.0  # samples/sec (progressive throughput)
        self._animator = None  # lazy SceneAnimator for baked-shape moves
        self._transforms = None
        # orbit state: pivot at the scene center (the editor's entity-frame
        # orbit), eye from the current camera
        self._pivot = np.asarray(renderer.scene.center, np.float32)
        self._eye = np.asarray(renderer.camera.position, np.float32)
        self._up = (0.0, 1.0, 0.0)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                viewer._handle(self)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_port
        self._http_thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._http_thread.start()

    # ---- HTTP ----------------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler):
        url = urllib.parse.urlparse(req.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        if url.path == "/":
            self._send(req, 200, _PAGE.encode(), "text/html")
        elif url.path == "/image.png":
            self._send(req, 200, self.png_bytes(), "image/png")
        elif url.path == "/api/status":
            st = self.status()
            self._send(req, 200, json.dumps(st).encode(), "application/json")
        elif url.path == "/api/camera":
            self.enqueue_orbit(
                yaw=float(q.get("yaw", 0.0)), pitch=float(q.get("pitch", 0.0)),
                dolly=float(q.get("dolly", 1.0)),
            )
            self._send(req, 200, b"{}", "application/json")
        elif url.path == "/api/material":
            kw = {}
            if all(k in q for k in ("r", "g", "b")):
                kw["diffuse"] = (float(q["r"]), float(q["g"]), float(q["b"]))
            if q.get("roughness"):
                kw["roughness"] = float(q["roughness"])
            self.enqueue_material(int(q.get("id", 0)), **kw)
            self._send(req, 200, b"{}", "application/json")
        elif url.path == "/api/pick":
            sel = self.pick(float(q.get("u", 0.5)), float(q.get("v", 0.5)))
            self._send(req, 200, json.dumps(sel).encode(), "application/json")
        elif url.path == "/api/transform":
            kw = {}
            if all(q.get(k) for k in ("x", "y", "z")):
                kw["translate"] = (float(q["x"]), float(q["y"]),
                                   float(q["z"]))
            if q.get("ry"):
                kw["rotate_y"] = float(q["ry"])
            if q.get("s"):
                kw["scale"] = float(q["s"])
            self.enqueue_transform(int(q.get("shape", 0)), **kw)
            self._send(req, 200, b"{}", "application/json")
        elif url.path == "/api/light":
            kw = {}
            if all(q.get(k) for k in ("ir", "ig", "ib")):
                kw["intensity"] = (
                    float(q["ir"]), float(q["ig"]), float(q["ib"]))
            if all(q.get(k) for k in ("x", "y", "z")):
                kw["position"] = (float(q["x"]), float(q["y"]), float(q["z"]))
            self.enqueue_light(int(q.get("id", 0)), **kw)
            self._send(req, 200, b"{}", "application/json")
        elif url.path == "/api/scenes":
            self._send(req, 200, json.dumps({"scenes": list(SCENES)}).encode(),
                       "application/json")
        elif url.path == "/api/scene":
            name = q.get("name", "")
            if name not in SCENES:
                self._send(req, 400, b'{"error": "unknown scene"}',
                           "application/json")
            else:
                self.enqueue_scene(name)
                self._send(req, 200, b"{}", "application/json")
        elif url.path == "/api/stats":
            self._send(req, 200, json.dumps(self.stats()).encode(),
                       "application/json")
        else:
            self._send(req, 404, b"not found", "text/plain")

    @staticmethod
    def _send(req, code, body: bytes, ctype: str):
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.send_header("Cache-Control", "no-store")
        req.end_headers()
        req.wfile.write(body)

    # ---- state ---------------------------------------------------------
    def png_bytes(self) -> bytes:
        from .utils.image import png_bytes, to_srgb_u8

        r = self.renderer
        img = np.asarray(r.display_image()).reshape(
            r.cfg.height, r.cfg.width, 3)
        return png_bytes(to_srgb_u8(img, flip_vertical=True))

    def status(self) -> dict:
        r = self.renderer
        return {"spp": int(r.accum.frame), "width": r.cfg.width,
                "height": r.cfg.height}

    def stats(self) -> dict:
        """The StatsWindow / GUI memory readout (``PathTracingGUI.cpp:
        110-117``, ``StatsWindow.cpp:12-49``): spp, wall render time,
        progressive throughput, and device/accel memory."""
        from .runtime.platform import _nbytes, device_memory_stats

        r = self.renderer
        dev = device_memory_stats()
        return {
            "spp": int(r.accum.frame),
            "scene": self._scene_name,
            "render_time_s": round(self._render_time, 3),
            "samples_per_sec": round(self._rate, 4),
            "accel_bytes": _nbytes(r.intersector.accel),
            "scene_bytes": _nbytes(r.scene),
            "device_bytes_in_use": int(dev.get("bytes_in_use", 0)),
            "device_bytes_limit": int(dev.get("bytes_limit", 0)),
        }

    def pick(self, u: float, v: float) -> dict:
        """Entity picking (the editor's ``EntityPicker``,
        ``engine/util/ECSUtil``): cast the camera ray through film (u, v)
        and report the hit shape + its material/light ids, so transform and
        material edits can target what the user clicked."""
        import jax.numpy as jnp

        from .core.types import Rays

        r = self.renderer
        o, d = r.camera.generate_rays(jnp.asarray([[u, v]], jnp.float32))
        # the production intersectors expect padded wavefronts; a 1-ray
        # query is fine (they pad internally)
        hit = r.intersector.intersect(r.scene, Rays.make(o, d))
        if not bool(hit.valid[0]):
            return {"hit": False}
        shape = int(hit.shape[0])
        scene = r.scene
        return {
            "hit": True,
            "shape": shape,
            "prim": int(hit.prim[0]),
            "t": float(hit.t[0]),
            "material": int(scene.shapes.material[shape]),
            "light": int(scene.shapes.light[shape]),
            "instanced": bool(
                scene.instances is not None
                and shape in np.asarray(scene.instances.shape).tolist()),
        }

    # ---- edits (enqueued by HTTP threads, applied by the render loop) --
    def enqueue_orbit(self, yaw=0.0, pitch=0.0, dolly=1.0):
        with self._edit_lock:
            self._edits.append(("camera", (yaw, pitch, dolly)))

    def enqueue_material(self, mat_id: int, **kw):
        with self._edit_lock:
            self._edits.append(("material", (mat_id, kw)))

    def enqueue_light(self, light_id: int, **kw):
        with self._edit_lock:
            self._edits.append(("light", (light_id, kw)))

    def enqueue_transform(self, shape_id: int, **kw):
        with self._edit_lock:
            self._edits.append(("transform", (shape_id, kw)))

    def enqueue_scene(self, name: str):
        with self._edit_lock:
            self._edits.append(("scene", name))

    def _apply_edits(self) -> bool:
        """Drain and apply queued edits; returns True if any were applied."""
        with self._edit_lock:
            edits, self._edits = self._edits, []
        for kind, payload in edits:
            if kind == "camera":
                yaw, pitch, dolly = payload
                v = self._eye - self._pivot
                cy, sy = np.cos(yaw), np.sin(yaw)
                v = np.asarray(
                    [cy * v[0] + sy * v[2], v[1], -sy * v[0] + cy * v[2]],
                    np.float32)
                r_xz = float(np.linalg.norm([v[0], v[2]]))
                ang = float(np.arctan2(v[1], r_xz)) + pitch
                ang = float(np.clip(ang, -1.45, 1.45))
                rad = float(np.linalg.norm(v)) * dolly
                v = np.asarray([
                    v[0] / max(r_xz, 1e-6) * np.cos(ang),
                    np.sin(ang),
                    v[2] / max(r_xz, 1e-6) * np.cos(ang),
                ], np.float32) * rad
                self._eye = self._pivot + v
                from .camera.pinhole import PinholeCamera

                cam = self.renderer.camera
                self.renderer.update_camera(PinholeCamera.look_at(
                    eye=self._eye, target=self._pivot, up=self._up,
                    fov_deg=float(np.rad2deg(
                        2.0 * np.arctan(float(cam.tan_half_fov)))),
                    aspect=float(cam.aspect),
                ))
            elif kind == "material":
                mat_id, kw = payload
                import jax.numpy as jnp

                scene = self.renderer.scene
                mats = scene.materials
                if "diffuse" in kw:
                    mats = mats.replace(diffuse=mats.diffuse.at[mat_id].set(
                        jnp.asarray(kw["diffuse"], jnp.float32)))
                if "roughness" in kw:
                    mats = mats.replace(
                        roughness=mats.roughness.at[mat_id].set(
                            kw["roughness"]))
                # material-only edit: no accel rebuild (RTScene.cpp:370-390)
                self.renderer.update_scene(scene.replace(materials=mats),
                                           rebuild_accel=False)
            elif kind == "light":
                light_id, kw = payload
                import jax.numpy as jnp

                scene = self.renderer.scene
                lights = scene.lights
                if "intensity" in kw:
                    lights = lights.replace(
                        intensity=lights.intensity.at[light_id].set(
                            jnp.asarray(kw["intensity"], jnp.float32)))
                if "position" in kw:
                    lights = lights.replace(
                        position=lights.position.at[light_id].set(
                            jnp.asarray(kw["position"], jnp.float32)))
                # lights don't participate in the accel: table re-upload +
                # reset only (RTScene.cpp:356-391 light update path)
                self.renderer.update_scene(scene.replace(lights=lights),
                                           rebuild_accel=False)
            elif kind == "transform":
                shape_id, kw = payload
                from .scene.dynamic import (
                    SceneAnimator, rotation_y, scale as mk_scale,
                    set_shape_transform, translation,
                )

                m = translation(kw.get("translate", (0.0, 0.0, 0.0)))
                if "rotate_y" in kw:
                    m = m @ rotation_y(kw["rotate_y"])
                if "scale" in kw:
                    m = m @ mk_scale(kw["scale"])
                scene = self.renderer.scene
                inst_shapes = (set(np.asarray(scene.instances.shape).tolist())
                               if scene.instances is not None else set())
                if shape_id in inst_shapes:
                    # instanced shape: pure transform edit; update_scene
                    # takes the in-jit two-level refit (no rebuild)
                    self.renderer.update_scene(
                        set_shape_transform(scene, shape_id, m))
                else:
                    # baked shape: re-transform vertices from the pristine
                    # base snapshot, carrying forward material/light edits
                    # made since (entity move in the editor,
                    # PathTracingGUI.cpp:106-118 -> RTScene.cpp:317-359)
                    if self._animator is None:
                        self._animator = SceneAnimator.create(scene)
                        self._transforms = self._animator.identity_transforms()
                    self._transforms[shape_id] = m
                    out = self._animator.transformed(
                        np.asarray(self._transforms))
                    out = out.replace(
                        materials=scene.materials,
                        lights=out.lights.replace(
                            intensity=scene.lights.intensity,
                            position=scene.lights.position,
                        ),
                    )
                    self.renderer.update_scene(out)
            elif kind == "scene":
                from .renderer import Renderer
                from .scene import builders

                scene, camera = getattr(builders, payload)()
                self.renderer = Renderer(scene, camera, self.renderer.cfg)
                self._scene_name = payload
                self._pivot = np.asarray(scene.center, np.float32)
                self._eye = np.asarray(camera.position, np.float32)
                self._render_time = 0.0
                self._animator = None
                self._transforms = None
        return bool(edits)

    # ---- loop ----------------------------------------------------------
    def serve(self, max_steps: int | None = None):
        """Run the render loop in this thread (HTTP is already served from
        the daemon thread started at construction); progressive
        accumulation continues until interrupted or ``max_steps`` frames
        have been stepped."""
        import time as _t

        steps = 0
        while not self._stop.is_set():
            edited = self._apply_edits()
            if not self.renderer.stopped():
                t0 = _t.perf_counter()
                self.renderer.step(1)
                dt = _t.perf_counter() - t0
                self._render_time += dt
                per = self.renderer.cfg.samples_per_pass
                self._rate = per / dt if dt > 0 else 0.0
                steps += 1  # counts RENDERED samples only (ADVICE r4)
            elif not edited:
                # target spp reached and no pending edits: idle politely
                # instead of busy-spinning a core (ADVICE r4)
                _t.sleep(0.05)
            if max_steps is not None and steps >= max_steps:
                break
        # the HTTP server keeps serving the final image until stop()

    def stop(self):
        self._stop.set()
        self.server.shutdown()
