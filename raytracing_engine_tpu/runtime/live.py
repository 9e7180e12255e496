"""Live interactive serving — frames out, input events in, while running.

The reference is a windowed real-time app: a winit window with a grabbed
cursor (/root/reference/src/main.rs:430-441) integrates live WASD/QE +
mouse-look every frame (src/main.rs:732-775) and presents via the
swapchain (src/main.rs:872-927). The repo's FrameLoop preserves those
semantics over SCRIPTED InputEvent streams; this module closes the last
gap: a loopback HTTP server that drives the SAME FrameLoop from events
arriving live over the wire and streams the rendered frames back.

Protocol (machine-first; loopback by default — serving publishes nothing):

  POST /step    body = one InputEvent as JSON ({"move": [dx, fy, uz],
                "rot": [yaw, pitch], "cursor": [cx, cy], "dt": s,
                "quit"/"fullscreen_toggle": bool, "focus": bool|null,
                "resize": [w, h]|null}; all fields optional) ->
                response = the rendered frame as an RGB PNG
                (image/png; X-Frame-Index / X-Camera headers carry state).
                A frozen/quit event returns 204 (no frame — the
                reference's frozen loop skips rendering, src/main.rs:726).
  GET /frame    the last rendered frame (PNG), 204 if none yet.
  GET /state    JSON {frame, camera: {position, yaw, pitch}, quit, frozen,
                size}.
  GET /         a minimal HTML viewer: canvas + keyboard/mouse handlers
                that POST /step per animation tick (human-driveable from
                any browser on the host).

Determinism contract: the server only FORWARDS events into
FrameLoop.step, so any event sequence driven over the wire renders
bit-identically to the same sequence replayed offline
(tests/test_live.py proves it) — the reference's input→frame semantics,
transport-independent.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np

from raytracing_engine_tpu.runtime.frame import FrameLoop, InputEvent
from raytracing_engine_tpu.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>raytracing_engine_tpu live</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace}
#hud{position:fixed;top:6px;left:8px}</style></head>
<body><div id="hud">WASD/QE move &middot; arrows/drag look &middot;
F fullscreen &middot; Esc quit</div><img id="v" alt="frame">
<script>
const keys = {}; let cx = 0, cy = 0, last = performance.now();
onkeydown = e => { keys[e.key.toLowerCase()] = 1; };
onkeyup = e => { keys[e.key.toLowerCase()] = 0; };
onmousemove = e => { if (e.buttons & 1) { cx += e.movementX; cy += e.movementY; } };
async function tick() {
  const now = performance.now(), dt = Math.min((now - last) / 1e3, 0.1);
  last = now;
  const k = n => keys[n] ? 1 : 0;
  const ev = {
    move: [k('d') - k('a'), k('w') - k('s'), k('q') - k('e')],
    rot: [k('arrowright') - k('arrowleft'), k('arrowdown') - k('arrowup')],
    cursor: [cx, cy], dt: dt,
    fullscreen_toggle: !!keys['f'], quit: !!keys['escape'],
  };
  keys['f'] = 0; cx = 0; cy = 0;
  const r = await fetch('/step', {method: 'POST', body: JSON.stringify(ev)});
  if (r.status === 200) {
    const b = await r.blob();
    document.getElementById('v').src = URL.createObjectURL(b);
  }
  if (!ev.quit) requestAnimationFrame(tick);
}
tick();
</script></body></html>"""


def _event_from_json(d: dict) -> InputEvent:
    kw = {}
    for k in ("move", "rot", "cursor", "resize"):
        if d.get(k) is not None:
            kw[k] = tuple(d[k])
    for k in ("dt",):
        if k in d:
            kw[k] = float(d[k])
    for k in ("quit", "fullscreen_toggle"):
        if k in d:
            kw[k] = bool(d[k])
    if "focus" in d:
        kw["focus"] = None if d["focus"] is None else bool(d["focus"])
    return InputEvent(**kw)


class LiveFrameServer:
    """Serve a FrameLoop over loopback HTTP (threaded, single-loop-lock).

    >>> srv = LiveFrameServer(FrameLoop(cfg, scene))
    >>> srv.url      # e.g. 'http://127.0.0.1:43211'
    >>> srv.close()

    One lock serializes loop access: concurrent /step requests integrate
    input in arrival order, exactly like a window system's event queue.
    """

    def __init__(self, loop: FrameLoop, host: str = "127.0.0.1",
                 port: int = 0):
        self.loop = loop
        self._lock = threading.Lock()
        self._frame_idx = -1
        self._last_png = None
        server = self

        # present-path quantization ON DEVICE: the same elementwise IEEE
        # f32 ops as utils.image.to_srgb_u8 (clamp, *255, rint, clamp),
        # so the fetched u8 plane is BIT-IDENTICAL to the host conversion
        # (tests/test_live.py's wire==offline contract) while the
        # device-to-host copy moves 1/4 the bytes (~25 MB per 1080p frame
        # as f32).
        import jax.numpy as jnp

        self._to_u8 = jax.jit(lambda x: jnp.clip(
            jnp.rint(jnp.clip(x, 0.0, 1.0) * 255.0), 0, 255
        ).astype(jnp.uint8))

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the hud is the UI
                pass

            def _send(self, code, body=b"", ctype="text/plain",
                      headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif self.path.startswith("/frame"):
                    with server._lock:
                        png = server._last_png
                        idx = server._frame_idx
                    if png is None:
                        self._send(204)
                    else:
                        self._send(200, png, "image/png",
                                   [("X-Frame-Index", str(idx))])
                elif self.path == "/state":
                    with server._lock:
                        body = json.dumps(server.state()).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404)

            def do_POST(self):
                if self.path != "/step":
                    self._send(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    spec = json.loads(self.rfile.read(n) or b"{}")
                    ev = _event_from_json(spec)
                except (ValueError, TypeError) as e:
                    self._send(400, f"bad event: {e}".encode())
                    return
                with server._lock:
                    prev = server.loop._last
                    img = server.loop.step(ev)
                    if server.loop.quit or img is None or img is prev:
                        # nothing rendered (quit / frozen) — the
                        # reference's frozen loop skips the body
                        # (src/main.rs:726); 204 mirrors that
                        self._send(204, headers=[
                            ("X-Quit", str(server.loop.quit).lower())])
                        return
                    img = np.asarray(
                        jax.block_until_ready(server._to_u8(img)))
                    server._frame_idx += 1
                    server._last_png = encode_png(img, level=1)
                    png, idx = server._last_png, server._frame_idx
                    cam = json.dumps(server._camera())
                self._send(200, png, "image/png",
                           [("X-Frame-Index", str(idx)),
                            ("X-Camera", cam)])

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def _camera(self):
        cam = self.loop.camera
        return {"position": np.asarray(cam.position).tolist(),
                "rotation": np.asarray(cam.rotation).tolist()}

    def state(self):
        return {"frame": self._frame_idx, "camera": self._camera(),
                "quit": self.loop.quit, "frozen": self.loop.frozen,
                "size": [self.loop.cfg.width, self.loop.cfg.height]}

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
