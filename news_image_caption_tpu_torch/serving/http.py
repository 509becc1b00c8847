"""HTTP proxy in front of the serving stack (stdlib, no Flask).

A copy of `news_image_caption_tpu/serving/http.py` in which only the
client's import changes: POST /encode with a JSON body, GET /status and
GET /status/worker. `tests/test_torch_serving.py` holds the two
handlers' answers equal byte for byte.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from news_image_caption_tpu_torch.serving.client import \
    CaptioningClient


def make_handler(client: CaptioningClient, server_info: dict):
    client_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/status/worker":
                # Live worker telemetry over the `_stats` job RPC
                # (reference analog: bert-serving's /status/server,
                # server/http.py:8-66). One worker answers per call.
                try:
                    with client_lock:
                        stats = client.stats()
                    self._json(200, {"status": "ok", **stats})
                except Exception as e:
                    self._json(502, {"error": repr(e)})
            elif self.path.startswith("/status"):
                self._json(200, {"status": "ok", **server_info})
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if self.path != "/encode":
                self._json(404, {"error": "unknown endpoint"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length))
                # `_stats` is the worker telemetry RPC key (reserved,
                # see CaptioningClient.caption) — a user payload must
                # not be able to hijack /encode into a stats response.
                req.pop("_stats", None)
                job = {k: np.asarray(v["data"], dtype=v["dtype"])
                       if isinstance(v, dict) and "data" in v else v
                       for k, v in req.items()}
                # ThreadingHTTPServer handlers share ONE client whose
                # ZMQ sockets are not thread-safe (and whose SUB
                # stream would interleave results across threads) —
                # serialize the round trip.
                with client_lock:
                    result = client.caption(job)
                self._json(200, {
                    k: v.tolist() if isinstance(v, np.ndarray) else v
                    for k, v in result.items()})
            except Exception as e:
                self._json(500, {"error": repr(e)})

        def log_message(self, *args):
            pass

    return Handler


def serve_http(client: CaptioningClient, port: int = 0,
               server_info: Optional[dict] = None):
    """Start the HTTP proxy; returns (server, port). Non-blocking."""
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", port), make_handler(client, server_info or {}))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1]
