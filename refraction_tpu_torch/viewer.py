"""Live orbit viewer: the reference's window, rebuilt for a headless host.

The reference presents every frame into a Win32 window vsync-locked
(WinMain.cpp:46-59, RefractionDemo.cpp:607-609). On a headless host (a GPU server) the
equivalent is a tiny HTTP server: the render loop (run.py --serve) keeps
publishing tonemapped frames, and a browser pointed at the port watches the
orbit live. Frames are served as PNG (io/png.py — no JPEG dependency) two
ways:

- ``/``        an HTML page whose JS fetches ``/frame`` in a tight loop
               (works in every browser; paces itself to the server);
- ``/stream``  a multipart/x-mixed-replace push stream (MJPEG-style, with
               PNG parts) for clients that support it;
- ``/stats``   the latest frame's stats line as JSON.

Pure stdlib (http.server + threading); zero new dependencies. The port's
copy of `refraction_tpu.viewer`.
"""

from __future__ import annotations

import http.server
import io
import json
import socketserver
import threading
import time

from refraction_tpu_torch.io.png import encode_png

_PAGE = b"""<!doctype html>
<html><head><title>refraction_tpu live</title><style>
 body { background:#111; color:#ddd; font-family:monospace; text-align:center }
 img { image-rendering:auto; max-width:96vw; max-height:85vh; }
</style></head><body>
<h3>refraction_tpu &mdash; live orbit</h3>
<img id="v"><div id="s"></div>
<script>
const img = document.getElementById('v'), s = document.getElementById('s');
let last = -1;
async function tick() {
  try {
    const r = await fetch('/frame?x=' + Math.random());
    const id = r.headers.get('X-Frame-Id');
    const b = await r.blob();
    if (id != last) {
      const url = URL.createObjectURL(b);
      if (img.src.startsWith('blob:')) URL.revokeObjectURL(img.src);
      img.src = url; last = id;  // revoke the old blob or the tab leaks
    }
    const st = await (await fetch('/stats')).json();
    s.textContent = JSON.stringify(st);
  } catch (e) {}
  requestAnimationFrame(tick);
}
tick();
</script></body></html>"""


class FrameServer:
    """Publish frames from the render loop; serve them over HTTP."""

    def __init__(self, port: int = 8000, host: str = "0.0.0.0"):
        self._lock = threading.Condition()
        self._png: bytes | None = None
        self._frame_id = -1
        self._stats: dict = {}
        self.port = port

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/frame":
                    png, fid = server.latest()
                    if png is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png,
                                   [("X-Frame-Id", str(fid))])
                elif path == "/stats":
                    self._send(200, "application/json",
                               json.dumps(server._stats).encode())
                elif path == "/stream":
                    self._stream()
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _stream(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                last = -1
                try:
                    while True:
                        png, fid = server.wait_frame(last, timeout=5.0)
                        if png is None:
                            continue
                        last = fid
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/png\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(png)}\r\n\r\n".encode())
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return

        class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # ---- publisher side (render loop) ---------------------------------
    def publish(self, u8_image, stats: dict | None = None) -> None:
        """Publish an (H, W, 3) uint8 frame (tonemapped)."""
        buf = io.BytesIO()
        encode_png(buf, u8_image)
        data = buf.getvalue()
        with self._lock:
            self._png = data
            self._frame_id += 1
            if stats:
                self._stats = stats
            self._lock.notify_all()

    # ---- consumer side -------------------------------------------------
    def latest(self):
        with self._lock:
            return self._png, self._frame_id

    def wait_frame(self, after_id: int, timeout: float = 5.0):
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._frame_id <= after_id:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, after_id
                self._lock.wait(remaining)
            return self._png, self._frame_id

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
