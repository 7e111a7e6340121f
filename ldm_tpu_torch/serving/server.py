"""Dependency-free HTTP front end for :class:`GenerationService` (the twin
of ``ldm_tpu/serving/server.py``).

stdlib ``http.server`` only: a ``ThreadingHTTPServer`` whose request threads
block on the service's futures while its one batching worker keeps the
device fed; concurrency comes from coalescing requests on the device, not
from Python.  PIL is imported only to encode ``png``.

Endpoints:

* ``GET  /healthz``  → ``{"ok": true}``
* ``GET  /stats``    → ServiceStats as JSON
* ``POST /generate`` → body ``{"class_id": int | [int,...], "n": int = 1,
  "seed": int?, "format": "png" | "npy"}``; response
  ``{"images": [<base64>...], "format": ..., "seed": <seed used>}`` where each
  element is one PNG file (or one ``.npy`` buffer) base64-encoded.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ldm_tpu_torch.serving.service import GenerationService


def _encode_png(image: np.ndarray) -> bytes:
    from PIL import Image

    arr = image[..., 0] if image.shape[-1] == 1 else image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _encode_npy(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, image)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    service: GenerationService  # injected by GenerationHTTPServer
    request_timeout_s: float

    # quiet by default; the service's stats are the observability surface
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, self.service.stats().as_dict())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            class_id = req["class_id"]
            n = int(req.get("n", 1))
            seed = req.get("seed")
            fmt = req.get("format", "png")
            if fmt not in ("png", "npy"):
                raise ValueError(f"format must be png or npy, got {fmt!r}")
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            future: Future = self.service.submit(class_id, n=n, seed=seed)
        except (ValueError, RuntimeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            images = future.result(timeout=self.request_timeout_s)
        except Exception as e:  # queue-full rejection or worker failure
            self._reply(503, {"error": str(e)})
            return
        enc = _encode_png if fmt == "png" else _encode_npy
        self._reply(200, {
            "images": [base64.b64encode(enc(img)).decode() for img in images],
            "format": fmt,
            "seed": seed,
        })


class GenerationHTTPServer:
    """Threaded HTTP server wrapping a (started) GenerationService."""

    def __init__(
        self,
        service: GenerationService,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 300.0,
    ):
        handler = type(
            "BoundHandler", (_Handler,),
            {"service": service, "request_timeout_s": request_timeout_s},
        )
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "GenerationHTTPServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ldm-torch-serving-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(10.0)
        self._httpd.server_close()
        self._thread = None

    def serve_forever(self) -> None:
        """Blocking serve (the CLI path); Ctrl-C returns."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
