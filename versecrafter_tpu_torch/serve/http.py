"""Minimal JSON-over-HTTP server on the standard library.

The port's own copy of ``versecrafter_tpu.serve.http``. A Router maps
(method, path pattern) to handler(request); a pattern's ``<name>`` matches
one path segment and ``<path:name>`` spans segments (nested result paths
such as ``generated/generated_video_0.mp4``). A handler returns (status,
payload), the payload a dict (sent as JSON), bytes (octet-stream) or
(bytes, content_type). An exception inside a handler becomes a 500 whose
JSON carries the error and its traceback.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Tuple
from urllib.parse import parse_qs, urlparse


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, params: dict):
        self.method = handler.command
        parsed = urlparse(handler.path)
        self.path = parsed.path
        self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        self.params = params
        self.headers = handler.headers
        length = int(handler.headers.get("Content-Length") or 0)
        self.body = handler.rfile.read(length) if length else b""

    def json(self) -> dict:
        if not self.body:
            return {}
        return json.loads(self.body)


class Router:
    def __init__(self):
        self.routes = []

    def add(self, method: str, pattern: str, fn: Callable[[Request], Tuple[int, Any]]):
        def param(m):
            return (f"(?P<{m.group(2)}>.+)" if m.group(1)
                    else f"(?P<{m.group(2)}>[^/]+)")
        regex = re.compile(
            "^" + re.sub(r"<(path:)?(\w+)>", param, pattern) + "$")
        self.routes.append((method, regex, fn))

    def route(self, method: str, pattern: str):
        def deco(fn):
            self.add(method, pattern, fn)
            return fn
        return deco

    def match(self, method: str, path: str):
        for m, regex, fn in self.routes:
            if m != method:
                continue
            mt = regex.match(path)
            if mt:
                return fn, mt.groupdict()
        return None, None


def make_server(router: Router, host: str = "0.0.0.0", port: int = 8190,
                quiet: bool = True) -> ThreadingHTTPServer:
    """A threading HTTP server that dispatches through `router` (port 0:
    an ephemeral port, read back from ``server.server_address``)."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            if not quiet:
                super().log_message(*a)

        def _respond(self, status: int, payload):
            if isinstance(payload, tuple):
                data, ctype = payload
            elif isinstance(payload, bytes):
                data, ctype = payload, "application/octet-stream"
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def _dispatch(self):
            fn, params = router.match(self.command, urlparse(self.path).path)
            if fn is None:
                self._respond(404, {"error": "not found", "path": self.path})
                return
            try:
                req = Request(self, params or {})
                status, payload = fn(req)
                self._respond(status, payload)
            except Exception as e:  # noqa: BLE001 — serving boundary
                self._respond(500, {"error": str(e),
                                    "traceback": traceback.format_exc()})

        do_GET = do_POST = do_PUT = do_DELETE = _dispatch

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return th
