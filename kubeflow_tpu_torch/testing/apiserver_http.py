"""HTTP facade and client for the in-process API server.

A cut-down copy of `kubeflow_tpu/testing/apiserver_http.py` (a module
with no JAX in it). `ApiServerApp` serves a `FakeApiServer` over REST so
that separate processes (the model-server workers of a ``runtime:
process`` fleet) share the control plane's store:

    GET    /apis/<kind>                  ?namespace=&labelSelector=k=v
    GET    /apis/<kind>?watch=true&stream=true&resourceVersion=N
    GET    /apis/<kind>/<ns>/<name>      ('_' namespace = cluster scope)
    POST   /apis/<kind>
    PUT    /apis/<kind>/<ns>/<name>[/status]
    DELETE /apis/<kind>/<ns>/<name>

The watch is the streaming form: one chunked response held open across
events, one JSON event per line, BOOKMARK lines for quiet progress and
an ERROR line (410 past the journal's horizon) before the stream ends.

`HttpApiClient` mirrors the FakeApiServer surface (get, list, create,
update, update_status, delete, record_event, watch), so controller-side
code runs the same in-process or against the facade: keep-alive
connections from a pool, bounded write retries that never double-apply
(a create claims an AlreadyExists only when the stored object holds
what it sent; a delete takes NotFound as done; an update carries its
resourceVersion), and an informer watch loop that lists every watched
kind, then follows the stream from the list's resourceVersion,
reconnects after a dropped stream and re-lists on Gone.

Not copied: bearer tokens and RBAC (the facade is open, for localhost
rigs), TLS (an ``https`` endpoint is refused until it is ported, never
downgraded), active-passive endpoint failover (one endpoint), circuit
breakers, the long-poll watch, server-side apply, conversion, pod logs
and the trace drain.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import urllib.parse

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    ApiError,
    Conflict,
    FakeApiServer,
    Gone,
    Invalid,
    NotFound,
    Unavailable,
    WatchHandler,
    event_name,
    event_resource,
)
from kubeflow_tpu_torch.web.wsgi import (
    App,
    HttpError,
    Request,
    Response,
    StreamResponse,
    encode_json,
    json_response,
)

log = logging.getLogger(__name__)


def _ns_seg(namespace: str) -> str:
    return namespace or "_"


def _seg_ns(seg: str) -> str:
    return "" if seg == "_" else seg


class ApiServerApp(App):
    """REST facade over a `FakeApiServer` (open: no authentication)."""

    # How long one streaming response lives before the server ends it
    # cleanly (bounds a dead client's grip on its thread; a live client
    # re-opens on its pooled connection).
    STREAM_DURATION = 240.0
    # Bookmark cadence: each quiet slice emits a BOOKMARK line, a
    # heartbeat and an rv advance.
    STREAM_SLICE = 5.0

    def __init__(self, api: FakeApiServer):
        super().__init__("apiserver")
        self.api = api
        self.add_route("/apis/<kind>", self.list_kind)
        self.add_route("/apis/<kind>", self.create, ("POST",))
        self.add_route("/apis/<kind>/<ns>/<name>", self.get)
        self.add_route("/apis/<kind>/<ns>/<name>", self.update, ("PUT",))
        self.add_route("/apis/<kind>/<ns>/<name>", self.delete, ("DELETE",))
        self.add_route("/apis/<kind>/<ns>/<name>/status", self.update_status, ("PUT",))

    def list_kind(self, req: Request) -> Response:
        if req.query.get("watch") in ("true", "1"):
            return self._watch(req)
        selector = None
        if "labelSelector" in req.query:
            selector = dict(
                part.split("=", 1)
                for part in req.query["labelSelector"].split(",")
                if "=" in part
            )
        namespace = req.query.get("namespace")
        # The list's rv is the watch bookmark, read BEFORE listing: an
        # object committed between the two reads is then delivered again
        # by the watch (at least once) instead of lost behind it.
        rv = self.api.current_rv
        items = self.api.list(
            req.path_params["kind"],
            namespace=_seg_ns(namespace) if namespace is not None else None,
            label_selector=selector,
        )
        body = (
            b'{"items":[' + b",".join(r.wire_bytes() for r in items)
            + b'],"resourceVersion":' + str(rv).encode() + b"}"
        )
        return Response(body)

    def _watch(self, req: Request) -> StreamResponse:
        """The streaming watch from `resourceVersion`; `_` as the kind
        watches every kind (the client multiplexes one stream across its
        handlers)."""
        if req.query.get("stream") not in ("true", "1"):
            raise HttpError(400, "only the streaming watch (stream=true) is served")
        try:
            since = int(req.query.get("resourceVersion", "0"))
        except ValueError:
            raise HttpError(400, "resourceVersion must be an integer") from None
        kind = req.path_params["kind"]
        namespace = req.query.get("namespace")
        duration = min(float(req.query.get("timeoutSeconds", self.STREAM_DURATION)), 3600.0)

        def line(payload: dict) -> bytes:
            return encode_json(payload) + b"\n"

        def gen():
            # Raised after App.handle returned (mid chunked response), so
            # an error rides the stream as an ERROR line.
            rv = since
            deadline = time.monotonic() + duration
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return  # a clean end; the client resumes from its rv
                try:
                    events, new_rv = self.api.wait_events(
                        rv,
                        kind=None if kind == "_" else kind,
                        namespace=_seg_ns(namespace) if namespace is not None else None,
                        timeout=min(self.STREAM_SLICE, remaining),
                    )
                except Gone as e:
                    yield line({"type": "ERROR", "status": 410, "message": str(e)})
                    return
                except Exception as e:
                    yield line({"type": "ERROR", "status": 503, "message": str(e)})
                    return
                # One chunk per wakeup: the batch and its bookmark ride a
                # single framed write.
                out = bytearray()
                for ev_rv, ev, obj in events:
                    out += (b'{"type":"' + ev.encode() + b'","rv":' + str(ev_rv).encode()
                            + b',"object":' + obj.wire_bytes() + b"}\n")
                rv = new_rv
                out += line({"type": "BOOKMARK", "resourceVersion": rv})
                yield bytes(out)

        return StreamResponse(gen())

    def get(self, req: Request) -> Response:
        obj = self.api.get(
            req.path_params["kind"], req.path_params["name"], _seg_ns(req.path_params["ns"])
        )
        return Response(obj.wire_bytes())

    def create(self, req: Request) -> Response:
        obj = Resource.from_dict(req.json())
        if obj.kind != req.path_params["kind"]:
            raise HttpError(400, "kind mismatch between path and body")
        return json_response(self.api.create(obj).to_dict(), status=201)

    def _body_matching_path(self, req: Request) -> Resource:
        """The path is authoritative: a body naming another object than
        the REST path is a client bug, not a write to the named object."""
        obj = Resource.from_dict(req.json())
        if (
            obj.kind != req.path_params["kind"]
            or obj.metadata.name != req.path_params["name"]
            or (obj.metadata.namespace or "") != _seg_ns(req.path_params["ns"])
        ):
            raise HttpError(400, "kind/namespace/name mismatch between path and body")
        return obj

    def update(self, req: Request) -> Response:
        return json_response(self.api.update(self._body_matching_path(req)).to_dict())

    def update_status(self, req: Request) -> Response:
        return json_response(self.api.update_status(self._body_matching_path(req)).to_dict())

    def delete(self, req: Request) -> Response:
        self.api.delete(
            req.path_params["kind"], req.path_params["name"], _seg_ns(req.path_params["ns"])
        )
        return json_response({"deleted": True})


def endpoints_from_env(value: str) -> list[str]:
    """The apiserver address of the launcher's env contract: one URL or
    a comma-separated endpoint list."""
    urls = [u.strip() for u in value.split(",") if u.strip()]
    if not urls:
        raise ValueError(f"no apiserver endpoints in {value!r}")
    return urls


def _subsumes(stored, sent) -> bool:
    """Whether `stored` holds everything in `sent` (dicts may carry
    extra keys): the create-recovery ownership test."""
    if isinstance(sent, dict):
        if not isinstance(stored, dict):
            return False
        return all(k in stored and _subsumes(stored[k], v) for k, v in sent.items())
    return stored == sent


class HttpApiClient:
    """Remote twin of FakeApiServer's CRUD and watch surface.

    `base_url` is one endpoint (a string, or `endpoints_from_env`'s list
    of one): more than one raises, since failover is not ported, and an
    ``https`` endpoint raises until TLS is ported."""

    # Idle connections kept (a worker runs one watch stream and a few
    # concurrent calls).
    POOL_SIZE = 4
    # Pooled connections idle longer than this are discarded: below the
    # server's 75 s keep-alive reap, so a write almost never races a
    # server-side close.
    POOL_IDLE_MAX = 60.0
    # Socket timeout of one call.
    TIMEOUT = 10.0
    # Pause before a dropped watch stream reconnects.
    WATCH_RETRY = 0.5
    # Write attempts beyond the first, and their backoff: doubling from
    # RETRY_BASE, capped at RETRY_CAP.
    WRITE_RETRIES = 3
    RETRY_BASE = 0.05
    RETRY_CAP = 1.0

    def __init__(self, base_url):
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if len(urls) != 1:
            raise ValueError(
                f"HttpApiClient takes one endpoint, got {urls!r}: active-passive "
                "failover is not ported"
            )
        self.base_url = urls[0].rstrip("/")
        parts = urllib.parse.urlsplit(self.base_url)
        if parts.scheme != "http":
            raise ValueError(
                f"{self.base_url!r}: only http:// endpoints are served here; TLS is "
                "not ported, and an https endpoint is never downgraded to http"
            )
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self.retries_total = 0  # write attempts beyond the first
        self.handshakes = 0  # connections dialed
        self._pool: list = []
        self._pool_lock = threading.Lock()
        self._watchers: list[tuple[str | None, WatchHandler]] = []
        self._watch_lock = threading.Lock()
        self._watch_thread: threading.Thread | None = None
        self._closed = threading.Event()

    # -- transport ----------------------------------------------------------

    def _get_conn(self) -> http.client.HTTPConnection:
        now = time.monotonic()
        with self._pool_lock:
            while self._pool:
                conn = self._pool.pop()
                if now - conn._kftpu_idle_since <= self.POOL_IDLE_MAX:
                    return conn
                conn.close()
            self.handshakes += 1
        conn = http.client.HTTPConnection(self._host, self._port, timeout=self.TIMEOUT)
        conn._kftpu_reused = False
        return conn

    def _put_conn(self, conn) -> None:
        conn._kftpu_reused = True
        conn._kftpu_idle_since = time.monotonic()
        if conn.sock is not None:
            conn.sock.settimeout(self.TIMEOUT)  # a stream may have raised it
        with self._pool_lock:
            if len(self._pool) < self.POOL_SIZE and not self._closed.is_set():
                self._pool.append(conn)
                return
        conn.close()

    def _request_raw(self, method: str, path: str, body: dict | None = None):
        """One round trip on a pooled connection; returns (conn, resp)
        with the response unread. Only a GET retries (once, on a fresh
        connection) when a reused connection dies: for a write the
        failure is ambiguous (the server may have committed), so it
        propagates to `_write_with_retry`."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        while True:
            conn = self._get_conn()
            try:
                conn.request(method, path, body=data, headers=headers)
                return conn, conn.getresponse()
            except (http.client.HTTPException, OSError):
                reused = conn._kftpu_reused
                conn.close()
                if reused and method == "GET":
                    continue  # a stale keep-alive connection: one fresh retry
                raise

    def _finish(self, conn, resp) -> bytes:
        """Read the body and recycle (or retire) the connection."""
        try:
            data = resp.read()
        except Exception:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            self._put_conn(conn)
        return data

    @staticmethod
    def _raise_for_status(status: int, detail: str):
        if status == 404:
            raise NotFound(detail)
        if status == 409:
            # The facade folds AlreadyExists and Conflict onto 409.
            if "already exists" in detail:
                raise AlreadyExists(detail)
            raise Conflict(detail)
        if status == 410:
            raise Gone(detail)
        if status == 422:
            raise Invalid(detail)
        if status == 503:
            raise Unavailable(detail)
        raise ApiError(f"HTTP {status}: {detail}")

    def _call(self, method: str, path: str, body: dict | None = None) -> dict:
        conn, resp = self._request_raw(method, path, body)
        status = resp.status
        data = self._finish(conn, resp)
        if status >= 400:
            self._raise_for_status(status, data.decode(errors="replace"))
        return json.loads(data)

    def _write_with_retry(self, attempt, *, recover_committed=None):
        """Bounded retry with exponential backoff and full jitter for
        transient write failures (503, a dead connection). A dead
        connection is ambiguous: after one, an already-happened error
        (AlreadyExists, NotFound, Conflict) goes to `recover_committed`,
        which returns the recovered result or None to re-raise, so a
        retried write never applies twice."""
        delay = self.RETRY_BASE
        ambiguous = False
        attempts = 0
        while True:
            try:
                return attempt()
            except (Unavailable, http.client.HTTPException, OSError) as e:
                ambiguous = ambiguous or not isinstance(e, Unavailable)
                attempts += 1
                if attempts > self.WRITE_RETRIES or self._closed.is_set():
                    raise
                self.retries_total += 1
                self._closed.wait(random.uniform(0, delay))
                delay = min(delay * 2, self.RETRY_CAP)
            except (AlreadyExists, NotFound, Conflict) as e:
                if ambiguous and recover_committed is not None:
                    out = recover_committed(e)
                    if out is not None:
                        return out
                raise

    # -- CRUD ---------------------------------------------------------------

    def get(self, kind: str, name: str, namespace: str = "default") -> Resource:
        return Resource.from_dict(self._call("GET", f"/apis/{kind}/{_ns_seg(namespace)}/{name}"))

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[Resource]:
        params = {}
        if namespace is not None:
            params["namespace"] = _ns_seg(namespace)
        if label_selector:
            params["labelSelector"] = ",".join(f"{k}={v}" for k, v in label_selector.items())
        query = f"?{urllib.parse.urlencode(params)}" if params else ""
        return [Resource.from_dict(d) for d in self._call("GET", f"/apis/{kind}{query}")["items"]]

    def create(self, obj: Resource) -> Resource:
        def attempt() -> Resource:
            return Resource.from_dict(self._call("POST", f"/apis/{obj.kind}", obj.to_dict()))

        def recover(e: ApiError) -> Resource | None:
            # AlreadyExists after an ambiguous failure: our create may be
            # the one that landed; claim it only if it holds what we sent.
            if not isinstance(e, AlreadyExists):
                return None
            try:
                stored = self.get(obj.kind, obj.metadata.name, obj.metadata.namespace)
            except ApiError:
                return None
            if _subsumes(stored.spec, obj.spec) and stored.metadata.labels == obj.metadata.labels:
                return stored
            return None

        return self._write_with_retry(attempt, recover_committed=recover)

    def _put(self, obj: Resource, suffix: str) -> Resource:
        # Safe to retry: the body's resourceVersion precondition turns a
        # replay of a committed write into a Conflict, never a double
        # apply.
        path = f"/apis/{obj.kind}/{_ns_seg(obj.metadata.namespace)}/{obj.metadata.name}{suffix}"
        return self._write_with_retry(
            lambda: Resource.from_dict(self._call("PUT", path, obj.to_dict()))
        )

    def update(self, obj: Resource) -> Resource:
        return self._put(obj, "")

    def update_status(self, obj: Resource) -> Resource:
        return self._put(obj, "/status")

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._write_with_retry(
            lambda: self._call("DELETE", f"/apis/{kind}/{_ns_seg(namespace)}/{name}"),
            # NotFound after an ambiguous failure: the object is gone,
            # which is all a delete promises.
            recover_committed=lambda e: {"deleted": True} if isinstance(e, NotFound) else None,
        )

    def record_event(
        self, about: Resource, reason: str, message: str, *, type_: str = "Normal"
    ) -> Resource:
        """The same Event FakeApiServer.record_event emits; a retried or
        repeated emission lands on the existing Event."""
        ev = event_resource(about, reason, message, type_=type_)
        try:
            return self.create(ev)
        except AlreadyExists:
            return self.get("Event", event_name(about, reason, message, type_),
                            about.metadata.namespace)

    # -- watch (informer client) -------------------------------------------

    def watch(self, handler: WatchHandler, kind: str | None = None) -> None:
        """Register a handler; the first registration starts the watch
        loop, whose first pass delivers every existing object of each
        watched kind as a synthetic MODIFIED (list-then-watch)."""
        with self._watch_lock:
            self._watchers.append((kind, handler))
            started = self._watch_thread is None
            if started:
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, name="apiclient-watch", daemon=True
                )
                self._watch_thread.start()
        if not started and kind is not None:
            # A late registration: the running stream's bookmark may be
            # past this kind's objects; deliver their current state now.
            try:
                for item in self._call("GET", f"/apis/{kind}")["items"]:
                    self._dispatch("MODIFIED", Resource.from_dict(item))
            except Exception:
                log.debug("late-registration sync for %s failed", kind, exc_info=True)

    def close(self) -> None:
        self._closed.set()
        with self._pool_lock:
            conns, self._pool = self._pool, []
        for conn in conns:
            conn.close()

    def _dispatch(self, event: str, obj: Resource) -> None:
        with self._watch_lock:
            watchers = list(self._watchers)
        for kind, handler in watchers:
            if kind is None or kind == obj.kind:
                try:
                    handler(event, obj)
                except Exception:
                    log.exception("watch handler failed for %s %s", event, obj.key)

    def _resync(self) -> int:
        """List every concretely watched kind, delivering synthetic
        MODIFIED events; returns the first list's rv to watch from, so
        anything committed mid-resync is delivered again by the watch."""
        with self._watch_lock:
            kinds = {k for k, _ in self._watchers if k is not None}
        rv = None
        for kind in sorted(kinds):
            data = self._call("GET", f"/apis/{kind}")
            if rv is None:
                rv = data.get("resourceVersion", 0)
            for item in data["items"]:
                self._dispatch("MODIFIED", Resource.from_dict(item))
        return rv if rv is not None else 0

    def _watch_loop(self) -> None:
        rv = None
        while not self._closed.is_set():
            try:
                if rv is None:
                    rv = self._resync()
                rv = self._stream_once(rv)
            except Gone:
                rv = None  # the journal's horizon passed us: re-list
            except Exception:
                if self._closed.is_set():
                    return
                log.debug("watch stream error; retrying", exc_info=True)
                self._closed.wait(self.WATCH_RETRY)

    def _stream_once(self, rv: int) -> int:
        """Consume one streaming watch response, dispatching events as
        their lines arrive; returns the rv to resume from when the
        server ends the stream cleanly. Raises on a dropped stream (the
        loop reconnects from the last rv) and Gone on a 410."""
        params = urllib.parse.urlencode({"watch": "true", "stream": "true", "resourceVersion": rv})
        conn, resp = self._request_raw("GET", f"/apis/_?{params}")
        if resp.status >= 400:
            status = resp.status
            self._raise_for_status(status, self._finish(conn, resp).decode(errors="replace"))
        # The server bookmarks every STREAM_SLICE (5 s): a silent peer
        # past this read timeout is a dead one.
        if conn.sock is not None:
            conn.sock.settimeout(30.0)
        try:
            while not self._closed.is_set():
                line = resp.readline()
                if not line:
                    self._put_conn(conn)  # the terminal chunk: reusable
                    return rv
                ev = json.loads(line)
                etype = ev["type"]
                if etype == "BOOKMARK":
                    rv = ev["resourceVersion"]
                elif etype == "ERROR":
                    if ev.get("status") == 410:
                        raise Gone(ev.get("message", "watch horizon"))
                    raise ApiError(f"watch stream error {ev.get('status')}: "
                                   f"{ev.get('message', '')}")
                else:
                    self._dispatch(etype, Resource.from_dict(ev["object"]))
                    rv = ev["rv"]
            conn.close()
            return rv
        except BaseException:
            conn.close()
            raise
