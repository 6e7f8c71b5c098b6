"""Live preview server (counterpart of utils/preview.py): the headless
stand-in for the reference's GL window (preview.cpp:109-203) and imshow of
the denoised tensor (main.cpp:89-100).

A small in-process HTTP server streams frames as multipart
``x-mixed-replace`` (JPEG parts through PIL when PIL imports, PNG parts
through this package's ``encode_png`` otherwise; browsers show either):

    python -m ai_path_tracer_denoiser_tpu_torch.app interactive scene.txt --serve 8000
    # then open http://localhost:8000/

Stdlib only, PIL optional.  The server holds only the newest encoded frame
(drop-not-queue, like a swapchain), so a slow viewer never stalls the
render loop.  ``/camera?dphi=..`` queues orbit input that the loop drains
with ``pop_camera``.
"""
from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html><html><head><title>ai_path_tracer_denoiser_tpu</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;height:100vh}
img{image-rendering:pixelated;max-width:96vw;max-height:96vh}
#hint{position:fixed;bottom:6px;left:8px;color:#888;font:12px monospace}</style></head>
<body><img src="/stream">
<div id="hint">arrows: orbit &nbsp; +/-: zoom</div>
<script>
// keyboard orbit -> /camera query params (keyCallback/mouse orbit analogue,
// main.cpp:169-223); the render loop polls these between frames.
const step = {ArrowLeft:['dphi',-0.08], ArrowRight:['dphi',0.08],
              ArrowUp:['dtheta',-0.08], ArrowDown:['dtheta',0.08],
              '+':['dzoom',-0.4], '=':['dzoom',-0.4], '-':['dzoom',0.4]};
addEventListener('keydown', e => {
  const s = step[e.key];
  if (s) { fetch(`/camera?${s[0]}=${s[1]}`); e.preventDefault(); }
});
</script></body></html>"""

_CAMERA_KEYS = ("phi", "theta", "zoom", "dphi", "dtheta", "dzoom")


def _encode(frame: np.ndarray):
    """uint8 (H, W, 3) -> (mime, bytes): JPEG through PIL, else PNG."""
    try:
        from PIL import Image
    except ImportError:
        from .imageio import encode_png
        return "image/png", encode_png(frame)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return "image/jpeg", buf.getvalue()


class PreviewServer:
    """Threaded frame streamer; ``push()`` swaps in the newest frame.

    Binds loopback by default: the stream is unauthenticated, so serving
    on every interface (``host="0.0.0.0"``, ``--serve-host``) is an
    explicit choice.  ``port=0`` takes a free port (``.port``).
    """

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self._frame = None          # (mime, bytes)
        self._seq = 0
        self._cond = threading.Condition()
        # pending camera input: relative d* keys accumulate, absolute keys
        # overwrite; the render loop drains them with pop_camera()
        self._camera: dict = {}
        self._cam_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # no line per request
                pass

            def do_GET(self):
                from urllib.parse import parse_qsl, urlparse
                url = urlparse(self.path)
                if url.path == "/stream":
                    self._stream()
                elif url.path == "/camera":
                    outer._queue_camera(parse_qsl(url.query))
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def _stream(self):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                try:
                    while True:
                        with outer._cond:
                            # a new frame, or the same one again after 5 s;
                            # before the first push this waits (the JAX
                            # loop spins there, holding the GIL)
                            outer._cond.wait_for(
                                lambda: outer._frame is not None and outer._seq != seen,
                                timeout=5.0)
                            if outer._frame is None:
                                continue
                            seen = outer._seq
                            mime, data = outer._frame
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(f"Content-Type: {mime}\r\n"
                                         f"Content-Length: {len(data)}\r\n\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass         # the viewer went away

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _queue_camera(self, pairs):
        with self._cam_lock:
            for k, v in pairs:
                if k not in _CAMERA_KEYS:
                    continue
                try:
                    v = float(v)
                except ValueError:
                    continue
                if k.startswith("d"):
                    self._camera[k] = self._camera.get(k, 0.0) + v
                else:
                    self._camera[k] = v

    def push(self, frame: np.ndarray):
        """Publish a float [0, 1] or uint8 (H, W, 3) frame (floats are
        rounded to the nearest 8-bit step)."""
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        encoded = _encode(np.ascontiguousarray(arr))
        with self._cond:
            self._frame = encoded
            self._seq += 1
            self._cond.notify_all()

    def pop_camera(self) -> dict:
        """Drain pending camera input: {phi|theta|zoom: absolute,
        dphi|dtheta|dzoom: accumulated} -- empty if none arrived."""
        with self._cam_lock:
            out, self._camera = self._camera, {}
        return out

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
