"""Minimal web application core: routing, JSON envelopes, error mapping.

A cut-down copy of `kubeflow_tpu/web/wsgi.py`, holding what the model
server and the apiserver facade use: path-parameter routes and query
parameters, `HttpError` → JSON error envelope (with the error's extra
headers, e.g. 429's Retry-After), the control-plane storage errors
mapped onto statuses (NotFound 404, AlreadyExists and Conflict 409,
Invalid 422, Unavailable 503), a catch-all 500, `serve()` (GET, POST,
PUT, PATCH, DELETE) on an HTTP/1.1 threading server with persistent
connections and chunked `StreamResponse`s (the watch stream's
transport), and `TestClient`, which calls the app in-process with a
WSGI-style environ. Not copied yet (ROADMAP Queue 1): the tracing span
per request, TLS, static mounts and the WSGI ``__call__`` shim.
"""

from __future__ import annotations

import http.server
import io
import json
import logging
import re
import socketserver
import threading
import traceback
import urllib.parse
from typing import Any, Callable

from kubeflow_tpu_torch.testing import fake_apiserver as storage

log = logging.getLogger(__name__)


class HttpError(Exception):
    def __init__(
        self,
        status: int,
        message: str,
        headers: list[tuple[str, str]] | None = None,
    ):
        super().__init__(message)
        self.status = status
        self.message = message
        # Extra response headers the error carries (429 + Retry-After,
        # the model server's backpressure answer).
        self.headers = list(headers or [])


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query: dict[str, str] = {
            k: v[-1]
            for k, v in urllib.parse.parse_qs(environ.get("QUERY_STRING", "")).items()
        }
        self.headers: dict[str, str] = {}
        for key, value in environ.items():
            if key.startswith("HTTP_"):
                self.headers[key[5:].replace("_", "-").lower()] = value
        if "CONTENT_TYPE" in environ:
            self.headers["content-type"] = environ["CONTENT_TYPE"]
        self.path_params: dict[str, str] = {}
        self._body: bytes | None = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            stream = self.environ.get("wsgi.input")
            self._body = stream.read(length) if stream and length else b""
        return self._body

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            parsed = json.loads(self.body)
        except ValueError as e:
            raise HttpError(400, f"invalid JSON body: {e}") from e
        if not isinstance(parsed, dict):
            raise HttpError(400, "JSON body must be an object")
        return parsed


class Response:
    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        content_type: str = "application/json",
        headers: list[tuple[str, str]] | None = None,
    ):
        self.body = body
        self.status = status
        self.headers = list(headers or [])
        self.headers.append(("Content-Type", content_type))

    @property
    def content_type(self) -> str:
        for key, value in self.headers:
            if key.lower() == "content-type":
                return value
        return ""

    def json(self) -> dict:
        return json.loads(self.body)


class StreamResponse(Response):
    """A response whose body is produced incrementally (chunked transfer
    on the wire): `chunks` is an iterable of bytes, each framed and
    flushed as soon as it is produced, so a handler can hold the
    connection open and push events as they happen (the watch
    stream)."""

    def __init__(
        self,
        chunks,
        status: int = 200,
        content_type: str = "application/json",
        headers: list[tuple[str, str]] | None = None,
    ):
        super().__init__(b"", status=status, content_type=content_type,
                         headers=headers)
        self.chunks = chunks


def encode_json(payload: Any) -> bytes:
    """The JSON wire encoder: compact separators, utf-8."""
    return json.dumps(payload, separators=(",", ":")).encode()


def json_response(
    payload: Any,
    status: int = 200,
    headers: list[tuple[str, str]] | None = None,
) -> Response:
    return Response(encode_json(payload), status=status, headers=headers)


def error_response(
    status: int,
    message: str,
    headers: list[tuple[str, str]] | None = None,
) -> Response:
    return json_response(
        {"success": False, "status": status, "log": message}, status=status,
        headers=headers,
    )


class _Route:
    def __init__(self, pattern: str, methods: tuple[str, ...], handler):
        self.methods = methods
        self.handler = handler
        # <name> matches one path segment.
        regex = re.sub(
            r"<([a-zA-Z_][a-zA-Z0-9_]*)>", r"(?P<\1>[^/]+)", pattern
        )
        self.regex = re.compile(f"^{regex}$")


class App:
    """A web application with path-param routes."""

    def __init__(self, name: str):
        self.name = name
        self._routes: list[_Route] = []
        self.add_route("/healthz", self._healthz, methods=("GET",))

    def _healthz(self, req: Request) -> Response:
        return json_response({"app": self.name, "ok": True})

    def add_route(
        self,
        pattern: str,
        handler: Callable[[Request], Response],
        methods: tuple[str, ...] = ("GET",),
    ) -> None:
        self._routes.append(
            _Route(pattern, tuple(m.upper() for m in methods), handler)
        )

    def handle(self, req: Request) -> Response:
        try:
            return self._dispatch(req)
        except HttpError as e:
            return error_response(e.status, e.message, headers=e.headers)
        except storage.NotFound as e:
            return error_response(404, str(e))
        except (storage.AlreadyExists, storage.Conflict) as e:
            return error_response(409, str(e))
        except storage.Invalid as e:
            return error_response(422, str(e))
        except storage.Unavailable as e:
            return error_response(503, str(e))
        except Exception as e:  # the catch-all 500
            log.error("%s: unhandled error: %s", self.name, e)
            log.debug("%s", traceback.format_exc())
            return error_response(500, f"internal error: {e}")

    def _dispatch(self, req: Request) -> Response:
        matched_path = False
        for route in self._routes:
            m = route.regex.match(req.path)
            if not m:
                continue
            matched_path = True
            if req.method not in route.methods:
                continue
            req.path_params = m.groupdict()
            return route.handler(req)
        if matched_path:
            raise HttpError(405, f"{req.method} not allowed on {req.path}")
        raise HttpError(404, f"no route for {req.path}")


class _Http11Handler(http.server.BaseHTTPRequestHandler):
    """HTTP/1.1 handler with persistent connections: the per-connection
    thread loops on `handle_one_request` until the peer closes or idles
    out."""

    protocol_version = "HTTP/1.1"
    # Predict responses are small writes on a persistent connection;
    # Nagle + delayed ACK would stall each by ~40 ms.
    disable_nagle_algorithm = True
    # Reaps idle keep-alive connections and caps a stalled client.
    timeout = 75.0

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        log.debug("%s %s", self.address_string(), format % args)

    def _environ(self) -> dict:
        path, _, query = self.path.partition("?")
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        body = self.rfile.read(length) if length > 0 else b""
        environ = {
            "REQUEST_METHOD": self.command,
            "PATH_INFO": urllib.parse.unquote(path),
            "QUERY_STRING": query,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "REMOTE_ADDR": self.client_address[0],
        }
        for key, value in self.headers.items():
            if key.lower() == "content-type":
                environ["CONTENT_TYPE"] = value
            else:
                environ["HTTP_" + key.upper().replace("-", "_")] = value
        return environ

    def _handle(self) -> None:
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            # Bodies are framed by Content-Length only; a chunked body left
            # unread on a keep-alive connection would parse as the next
            # request. Refuse it and drop the connection.
            self.send_response(501)
            self.send_header("Content-Length", "0")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            return
        resp = self.server.app.handle(Request(self._environ()))
        try:
            if isinstance(resp, StreamResponse):
                self._send_stream(resp)
            else:
                self._send(resp)
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            self.close_connection = True

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        for key, value in resp.headers:
            self.send_header(key, value)
        # Content-Length is what keeps the connection reusable.
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        self.wfile.write(resp.body)

    def _send_stream(self, resp: StreamResponse) -> None:
        """Chunked transfer: each produced chunk is framed and flushed as
        it arrives. The framing is self-delimiting, so the connection
        stays reusable after the terminal 0-chunk."""
        self.send_response(resp.status)
        for key, value in resp.headers:
            self.send_header(key, value)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for chunk in resp.chunks:
                if not chunk:
                    continue
                self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        finally:
            close = getattr(resp.chunks, "close", None)
            if close is not None:
                close()  # the generator's cleanup runs even on a client abort

    do_GET = _handle
    do_POST = _handle
    do_PUT = _handle
    do_PATCH = _handle
    do_DELETE = _handle

    def handle_one_request(self):
        try:
            super().handle_one_request()
        except (ConnectionResetError, BrokenPipeError, TimeoutError):
            self.close_connection = True


class _HttpServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    """Threading server, one thread per connection."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, addr, handler, app: App):
        self.app = app
        super().__init__(addr, handler)


def serve(app: App, host: str = "0.0.0.0", port: int = 8080):
    """Serve on a background thread; returns (server, thread). Stop with
    ``server.shutdown(); server.server_close()``. `server.server_port`
    is the bound port (pass port=0 to pick a free one)."""
    server = _HttpServer((host, port), _Http11Handler, app)
    # Bounded accept(): a connection reset between select() and accept()
    # must not park the serve loop, or shutdown() never returns.
    server.socket.settimeout(5.0)
    thread = threading.Thread(
        target=server.serve_forever, name=f"{app.name}-http", daemon=True
    )
    thread.start()
    return server, thread


class TestClient:
    """In-process client: builds a WSGI environ and calls the app."""

    __test__ = False  # not a pytest test class

    def __init__(self, app: App):
        self.app = app

    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        headers: dict[str, str] | None = None,
        raw: bytes | None = None,
        content_type: str = "application/json",
    ) -> Response:
        """`body` is a JSON object; `raw` posts bytes verbatim with
        `content_type` (the binary tensor frame in tests)."""
        path, _, query = path.partition("?")
        if raw is None:
            raw = json.dumps(body).encode() if body is not None else b""
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "QUERY_STRING": query,
            "CONTENT_LENGTH": str(len(raw)),
            "CONTENT_TYPE": content_type,
            "wsgi.input": io.BytesIO(raw),
        }
        for key, value in (headers or {}).items():
            environ["HTTP_" + key.upper().replace("-", "_")] = value
        return self.app.handle(Request(environ))

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, body: dict | None = None, **kw) -> Response:
        return self.request("POST", path, body=body, **kw)

    def put(self, path: str, body: dict | None = None, **kw) -> Response:
        return self.request("PUT", path, body=body, **kw)

    def patch(self, path: str, body: dict | None = None, **kw) -> Response:
        return self.request("PATCH", path, body=body, **kw)

    def delete(self, path: str, **kw) -> Response:
        return self.request("DELETE", path, **kw)
