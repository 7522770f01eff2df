"""Live browser viewer: the headless stand-in for the reference's
``render('human')`` window.

Counterpart of dtown/utils/viewer.py. A small in-process HTTP server
streams the latest frame as MJPEG: point a browser at
``http://<host>:<port>/`` and the view repaints as the simulation runs.
The standard library's ``http.server`` serves it; PIL encodes the JPEGs
and is imported only when a frame is published.

Endpoints:
  ``/``           HTML page with the live <img> and a caption line
  ``/caption``    the latest caption as text
  ``/stream``     multipart/x-mixed-replace MJPEG stream
  ``/frame.jpg``  single JPEG snapshot of the latest frame

Usage::

    v = LiveViewer(port=8600)          # port=0 picks a free port
    v.update(frame, caption="step 12 reward=0.53")   # uint8 [H, W, 3]
    ...
    v.close()

``python -m dtown_torch.manual_control --serve`` and
``python -m dtown_torch.eval_policy --serve`` wire it up.
"""
from __future__ import annotations

import io
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>dtown_torch live view</title>
<style>
 body {{ background: #111; color: #ddd; font-family: monospace;
        display: flex; flex-direction: column; align-items: center; }}
 img {{ margin-top: 2em; image-rendering: pixelated; width: {w}px; }}
 #cap {{ margin-top: 1em; }}
</style></head>
<body><img src="/stream" alt="live frame"><div id="cap"></div>
<script>
 setInterval(async () => {{
   const r = await fetch('/caption');
   document.getElementById('cap').textContent = await r.text();
 }}, 500);
</script>
</body></html>
"""


class LiveViewer:
    """Threaded MJPEG server holding the latest frame. ``wait_sent`` blocks
    until a given frame has gone out on a stream: a readiness signal for
    callers that must not publish the next frame before a client has the
    last."""

    def __init__(self, port: int = 0, display_width: int = 512,
                 host: str = "0.0.0.0"):
        self._lock = threading.Condition()
        self._jpeg: bytes | None = None
        self._caption = ""
        self._seq = 0
        self._sent_seq = 0
        self._closed = False
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-request lines on stderr
                pass

            def _reply(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._reply(_PAGE.format(w=display_width).encode(),
                                "text/html")
                elif self.path == "/caption":
                    self._reply(viewer._caption.encode(), "text/plain")
                elif self.path == "/frame.jpg":
                    jpeg = viewer._jpeg
                    if jpeg is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._reply(jpeg, "image/jpeg")
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while not viewer._closed:
                            jpeg, seq = viewer._wait_next(seq)
                            if jpeg is None:
                                break
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(jpeg)
                                + jpeg + b"\r\n")
                            self.wfile.flush()
                            viewer._mark_sent(seq)
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # the browser tab closed
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{socket.gethostname()}:{self.port}/"

    @property
    def seq(self) -> int:
        """The number of frames published so far."""
        return self._seq

    def update(self, frame, caption: str = ""):
        """Publish a new frame: uint8 [H, W, 3], or [H, W] grayscale (a
        tensor is read to the host)."""
        from PIL import Image

        if hasattr(frame, "detach"):
            frame = frame.detach().cpu().numpy()
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=85)
        with self._lock:
            self._jpeg = buf.getvalue()
            self._caption = caption
            self._seq += 1
            self._lock.notify_all()

    def _wait_next(self, last_seq, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists (or the timeout,
        after which the current frame is sent again to keep the stream
        alive)."""
        with self._lock:
            # a predicate, not a bare wait: _mark_sent wakes the waiters too
            self._lock.wait_for(
                lambda: self._seq != last_seq or self._closed, timeout)
            return self._jpeg, self._seq

    def _mark_sent(self, seq):
        with self._lock:
            self._sent_seq = max(self._sent_seq, seq)
            self._lock.notify_all()

    def wait_sent(self, seq: int, timeout: float) -> bool:
        """Block until frame ``seq`` (or a later one) has been written to
        a stream client, or ``timeout`` seconds pass; True if it was."""
        with self._lock:
            return self._lock.wait_for(lambda: self._sent_seq >= seq,
                                       timeout)

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()
