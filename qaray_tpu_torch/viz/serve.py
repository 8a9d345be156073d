"""Interactive preview server: the counterpart of qaray_tpu/viz/serve.py,
the GUI replacement.

The reference's interactive value lives in its GLUT viewport
(renderers/gui/viewport.cpp:107-527): kick off a render, watch it fill in,
abort/restart on camera or parameter edits, inspect pixels. This module
gives the same loop over localhost HTTP:

  GET  /            the viewer page (auto-refreshing preview + controls)
  GET  /image.png   latest progressive frame (or the finished render)
  GET  /depth.png   z-buffer visualization (GUI view mode 3)
  GET  /spp.png     sample-count heat map (GUI view mode 4)
  GET  /irradiance.png   pixels whose primary vertex gathered photons
                         (GUI view mode 5)
  GET  /status      {"spp": n, "spp_max": m, "rendering": bool, ...}
  GET  /probe?x=..&y=..      pixel RGB+z (GUI left-click PrintPixelData,
                             viewport.cpp:516-527)
  GET  /restart     stop + restart the render (GUI SPACE,
                             Renderer_GUI.cpp:37-61)
  GET  /set?spp=..&bounce=..&integrator=..   edit params, restart
  GET  /orbit?dyaw=..&dpitch=..&zoom=..      orbit the camera about its
                             look-at point, recompute the scene, restart
                             (GUI right-drag rotation, viewport.cpp)

The render runs on a worker thread, which makes the Renderer's device its
current device (CUDA's current device and stream are per thread); its
snapshots read the pipeline at round boundaries only (the progress
callback, after the Renderer retired its dispatch in flight). Edits set
the renderer's cooperative stop flag (the tasking signal_stop analog),
join the worker and restart with the new state.
"""

from __future__ import annotations

import copy
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>qaray_tpu_torch preview</title><style>
body {{ background:#181818; color:#ddd; font-family:monospace; }}
img {{ image-rendering:pixelated; border:1px solid #444; }}
a, button {{ color:#8cf; background:#222; border:1px solid #555;
             padding:2px 8px; text-decoration:none; }}
</style></head><body>
<h3>qaray_tpu_torch &mdash; live preview</h3>
<div id="status">...</div>
<p>
<button onclick="go('/restart')">restart</button>
<button onclick="go('/orbit?dyaw=-10')">&#8634; yaw</button>
<button onclick="go('/orbit?dyaw=10')">yaw &#8635;</button>
<button onclick="go('/orbit?dpitch=10')">pitch+</button>
<button onclick="go('/orbit?dpitch=-10')">pitch-</button>
<button onclick="go('/orbit?zoom=0.9')">zoom in</button>
<button onclick="go('/orbit?zoom=1.1')">zoom out</button>
</p>
<p><img id="img" width="{w2}" src="/image.png" onclick="probe(event)">
<img id="z" width="{w2}" src="/depth.png"></p>
<div id="probe"></div>
<script>
function go(u) {{ fetch(u); }}
function probe(e) {{
  const r = e.target.getBoundingClientRect();
  const x = Math.floor((e.clientX - r.left) / r.width * {w});
  const y = Math.floor((e.clientY - r.top) / r.height * {h});
  fetch(`/probe?x=${{x}}&y=${{y}}`).then(r => r.text()).then(
    t => document.getElementById('probe').textContent = t);
}}
setInterval(() => {{
  document.getElementById('img').src = '/image.png?' + Date.now();
  document.getElementById('z').src = '/depth.png?' + Date.now();
  fetch('/status').then(r => r.text()).then(
    t => document.getElementById('status').textContent = t);
}}, 1000);
</script></body></html>
"""


def _png_bytes(plane: np.ndarray, w: int, h: int) -> bytes:
    """A framebuffer plane ([n] grey or [n, 3] RGB uint8) as PNG bytes."""
    from qaray_tpu_torch.fb.png import png_bytes

    a = plane.reshape(h, w, -1)
    return png_bytes(a[..., 0] if a.shape[-1] == 1 else a)


class RenderServer:
    """Owns a Renderer + SceneDesc; serves and re-drives renders."""

    def __init__(self, renderer, scene_desc, port: int = 8000):
        self.renderer = renderer
        self.scene_desc = scene_desc
        self.port = port
        self._lock = threading.Lock()
        # Serializes start/stop/edit across HTTP handler threads, and
        # guarantees the worker is stopped BEFORE params/camera mutate
        # (the live render must never observe inconsistent state mid-round).
        self._ctl = threading.RLock()
        self._png = None
        self._fb_snapshot = None
        self._spp_done = 0
        self._rendering = False
        self._generation = 0
        self._worker = None
        self._httpd = None

    # -- render loop --------------------------------------------------------

    def _snapshot(self, r):
        # Pull the device accumulator into the host mirror first (called on
        # the worker thread at a round boundary, or after it stopped).
        fb = r.sync_fb()
        snap = copy.deepcopy(fb)
        snap.finalize(self.renderer.param.use_srgb, self.renderer.param.spp_max)
        w, h = snap.width, snap.height
        with self._lock:
            self._png = _png_bytes(snap.img, w, h)
            self._fb_snapshot = snap

    def _run_once(self):
        r = self.renderer
        if r.device.type == "cuda" and r.device.index is not None:
            torch.cuda.set_device(r.device)

        def progress(done, total):
            self._spp_done = done
            self._snapshot(r)

        r.set_progress_callback(progress)
        try:
            r.compute_scene(self.scene_desc)
            r.render()
            self._snapshot(r)
        finally:
            self._rendering = False

    def start_render(self):
        with self._ctl:
            self.stop_render()
            self._generation += 1
            # Set before the worker starts, so that /status never shows the
            # new generation with the previous render's state.
            self._rendering = True
            self._spp_done = 0
            # Cleared here, not on the worker: a stop asked for before the
            # worker runs must not be lost.
            self.renderer.stop_flag = False
            self._worker = threading.Thread(target=self._run_once, daemon=True)
            self._worker.start()

    def stop_render(self):
        with self._ctl:
            if self._worker is not None and self._worker.is_alive():
                self.renderer.signal_stop()
                self._worker.join()
            self._worker = None

    # -- edits --------------------------------------------------------------

    def orbit(self, dyaw=0.0, dpitch=0.0, zoom=1.0):
        """Rotate the camera about its look-at point (right-drag analog)."""
        self.stop_render()
        cam = self.scene_desc.camera
        pos = np.asarray(cam.pos, np.float64)
        dirv = np.asarray(cam.dir, np.float64)
        up = np.asarray(cam.up, np.float64)
        dist = cam.focal_distance if cam.focal_distance > 0 else 1.0
        target = pos + dirv / max(np.linalg.norm(dirv), 1e-9) * dist
        rel = (pos - target) * zoom

        def rot(v, axis, deg):
            axis = axis / max(np.linalg.norm(axis), 1e-9)
            th = np.radians(deg)
            return (v * np.cos(th) + np.cross(axis, v) * np.sin(th)
                    + axis * np.dot(axis, v) * (1 - np.cos(th)))

        rel = rot(rel, up, dyaw)
        right = np.cross(dirv, up)
        if np.linalg.norm(right) > 1e-9:
            rel = rot(rel, right, dpitch)
        new_pos = target + rel
        cam.pos = new_pos.astype(np.float32)
        newdir = target - new_pos
        cam.dir = (newdir / max(np.linalg.norm(newdir), 1e-9)).astype(
            np.float32
        )
        self.start_render()

    def set_params(self, **kw):
        self.stop_render()
        p = self.renderer.param
        if "spp" in kw:
            p.spp_min = p.spp_max = int(kw["spp"])
        if "bounce" in kw:
            p.max_bounce = int(kw["bounce"])
        if "integrator" in kw:
            p.integrator = str(kw["integrator"])
        # DoF preview (GUI viewport.cpp:365-391 jittered-camera
        # accumulation): edit aperture/focal distance and re-render — the
        # integrator's lens sampling accumulates the same blur
        # progressively, so a low spp gives the quick preview.
        if "dof" in kw:
            self.scene_desc.camera.depth_of_field = float(kw["dof"])
        if "focaldist" in kw:
            self.scene_desc.camera.focal_distance = float(kw["focaldist"])
        self.start_render()

    # -- http ---------------------------------------------------------------

    def status(self):
        return {
            "spp": self._spp_done,
            "spp_max": self.renderer.param.spp_max,
            "rendering": self._rendering,
            "generation": self._generation,
            "integrator": self.renderer.param.integrator,
        }

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                fb = server._fb_snapshot
                if u.path == "/":
                    cam = server.scene_desc.camera
                    self._send(200, "text/html", _PAGE.format(
                        w=cam.img_width, h=cam.img_height,
                        w2=cam.img_width * 2, h2=cam.img_height * 2,
                    ).encode())
                elif u.path == "/image.png":
                    with server._lock:
                        png = server._png
                    if png is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif u.path == "/depth.png" and fb is not None:
                    img = fb.z_image()
                    self._send(200, "image/png",
                               _png_bytes(img, fb.width, fb.height))
                elif u.path == "/spp.png" and fb is not None:
                    img = fb.sample_count_image()
                    self._send(200, "image/png",
                               _png_bytes(img, fb.width, fb.height))
                elif u.path == "/irradiance.png" and fb is not None:
                    # GUI view mode 5 (viewport.cpp:501-509): pixels whose
                    # primary vertex performed a photon-gather estimate.
                    self._send(200, "image/png",
                               _png_bytes(fb.irrad, fb.width, fb.height))
                elif u.path == "/status":
                    self._send(200, "application/json",
                               json.dumps(server.status()).encode())
                elif u.path == "/probe" and fb is not None:
                    x, y = int(q.get("x", 0)), int(q.get("y", 0))
                    try:
                        r, g, b, z = fb.probe(x, y)
                        msg = (f"Pixel [ {x}, {y} ] Color3c: {r}, {g}, {b}"
                               f"   Z: {z:f}")
                    except IndexError as e:
                        msg = str(e)
                    self._send(200, "text/plain", msg.encode())
                elif u.path == "/restart":
                    server.start_render()
                    self._send(200, "text/plain", b"restarted")
                elif u.path == "/set":
                    server.set_params(**q)
                    self._send(200, "text/plain", b"ok")
                elif u.path == "/orbit":
                    server.orbit(
                        dyaw=float(q.get("dyaw", 0.0)),
                        dpitch=float(q.get("dpitch", 0.0)),
                        zoom=float(q.get("zoom", 1.0)),
                    )
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler

    def serve(self, block: bool = True):
        self.start_render()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          self._handler())
        self.port = self._httpd.server_address[1]
        print(f"preview server: http://127.0.0.1:{self.port}/", flush=True)
        if block:
            try:
                self._httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                self.shutdown()
        else:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
        return self

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.stop_render()
