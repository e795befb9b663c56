"""Live progressive-accumulation preview over HTTP.

Counterpart of the JAX package's utils/viewer.py. The reference is an
on-screen app: its user watches the accumulation converge in a window. A
headless host streams instead: ``PreviewServer`` serves

  /            a small HTML page showing the live stream of every window
  /stream?view=yxz
               a multipart/x-mixed-replace stream of PNG frames at up to
               ``fps`` parts a second
  /frame.png?view=yxz
               the current frame once
  POST /cmd    one interactive command line (the stdin grammar of app.py:
               capture, escape, w/a/s/d/space/c/e/q, mouse DX DY, wheel D,
               frames N, ...), handed to the app's command queue; the
               page's JavaScript turns browser input into these (click =
               pointer capture, Escape = release, WASD/Space/C/E/Q = moves,
               captured mouse movement = mouse-look, wheel = psi).

The server owns nothing: it pulls frames through the ``get_frame(view)``
callback the app supplies, which reads the snapshot the render loop
publishes after each step, and pushes command lines through
``on_command``, which only enqueues: the render loop stays in the app's
main thread. Frames are encoded per connection at compress_level 1.
stdlib only (http.server and threading).
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from fourd_ray_tracing_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>fourd_ray_tracing_tpu_torch</title>
<style>body{{background:#111;color:#ddd;font:14px monospace;text-align:center}}
img{{image-rendering:pixelated;margin:6px;border:1px solid #333}}
#s{{color:#8a8}}</style>
</head><body><h3>fourd_ray_tracing_tpu_torch &mdash; live</h3>
{imgs}
<p id="s">click the main window to capture the mouse (Esc releases);
WASD/Space/C move, E/Q slide along w, wheel rotates psi</p>
<script>
const send = l => fetch('/cmd', {{method: 'POST', body: l}});
const img = document.querySelector('img');
let captured = false, dx = 0, dy = 0;
img.onclick = () => img.requestPointerLock();
document.addEventListener('pointerlockchange', () => {{
  captured = document.pointerLockElement === img;
  send(captured ? 'capture' : 'escape');
  document.getElementById('s').textContent =
    captured ? 'captured - Esc to release' : 'click the main window to capture';
}});
document.addEventListener('mousemove', e => {{
  if (captured) {{ dx += e.movementX; dy -= e.movementY; }}
}});
setInterval(() => {{
  if (captured && (dx || dy)) {{
    send(`mouse ${{dx}} ${{dy}}`); dx = 0; dy = 0;
  }}
}}, 60);
const keymap = {{w:'w', a:'a', s:'s', d:'d', ' ':'space', c:'c',
                e:'e', q:'q'}};
document.addEventListener('keydown', e => {{
  if (captured && keymap[e.key]) {{ send(keymap[e.key] + ' 0.1');
                                    e.preventDefault(); }}
}});
document.addEventListener('wheel', e => {{
  if (captured) send(`wheel ${{e.deltaY > 0 ? -1 : 1}}`);
}});
</script></body></html>"""


class PreviewServer:
    """Threaded HTTP preview. ``get_frame(view) -> (H, W, 3) uint8`` is
    called from server threads; it must be cheap and never block the
    render loop (it reads the newest published snapshot)."""

    def __init__(
        self,
        get_frame: Callable[[str], np.ndarray],
        views: Sequence[str] = ("yxz",),
        host: str = "127.0.0.1",
        port: int = 0,
        fps: float = 10.0,
        on_command: Callable[[str], None] | None = None,
    ):
        self._get_frame = get_frame
        self._on_command = on_command
        self.views = tuple(views)
        self.fps = float(fps)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _view(self) -> str:
                q = parse_qs(urlparse(self.path).query)
                v = q.get("view", [outer.views[0]])[0]
                return v if v in outer.views else outer.views[0]

            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = urlparse(self.path).path
                if path == "/":
                    imgs = "".join(
                        f'<img src="/stream?view={v}" alt="{v}" title="{v}">'
                        for v in outer.views
                    )
                    body = _PAGE.format(imgs=imgs).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/frame.png":
                    data = encode_png(outer._get_frame(self._view()),
                                      compress_level=1)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif path == "/stream":
                    view = self._view()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    delay = 1.0 / max(outer.fps, 0.1)
                    try:
                        while not outer._closed:
                            data = encode_png(outer._get_frame(view),
                                              compress_level=1)
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n".encode()
                            )
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()
                            time.sleep(delay)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                if urlparse(self.path).path != "/cmd" or outer._on_command is None:
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > 1024:
                    # Reject instead of truncating: unread body bytes
                    # would desync keep-alive request parsing.
                    self.send_error(413)
                    return
                line = self.rfile.read(n).decode("utf-8", "replace")
                outer._on_command(line.strip()[:256])
                self.send_response(204)
                self.end_headers()

        self._closed = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def close(self) -> None:
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
