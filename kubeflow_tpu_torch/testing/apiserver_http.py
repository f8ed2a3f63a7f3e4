"""HTTP facade and client for the in-process API server.

A cut-down copy of `kubeflow_tpu/testing/apiserver_http.py` (a module
with no JAX in it). `ApiServerApp` serves a `FakeApiServer` over REST so
that separate processes (controller managers, pod workers, the CLI)
share the control plane's store:

    GET    /apis/<kind>                  ?namespace=&labelSelector=k=v&version=
    GET    /apis/<kind>?watch=true       &resourceVersion=N&timeoutSeconds=S[&stream=true]
    GET    /apis/<kind>/<ns>/<name>      ('_' namespace = cluster scope; ?version=)
    POST   /apis/<kind>                  (?apply=true: create-or-update)
    PUT    /apis/<kind>/<ns>/<name>[/status]
    DELETE /apis/<kind>/<ns>/<name>

Multi-version kinds: a POST or PUT body may carry any served apiVersion
(the store converts it to the hub version); a GET with ``?version=``
reads at any served version, and an unserved one is a 422.

The watch has two forms. The long-poll (the default, without
``stream``) blocks until events land past ``resourceVersion`` or
``timeoutSeconds`` (at most 60) pass, and returns them with the rv to
resume from; a bookmark past the journal's horizon is a 410. The
streaming form (``stream=true``) is one chunked response held open
across events, one JSON event per line, BOOKMARK lines for quiet
progress and an ERROR line (410 past the horizon) before the stream
ends. Both build each event's bytes once in the `WatchCache`, whatever
the number of watchers.

A write may carry ``X-Kftpu-Lease-Guard: [ns, name, holder,
transitions]`` (a leader-elected client arms it with
`HttpApiClient.set_lease_guard`): the store checks it under its commit
lock and a fenced write is a 409, as a Conflict is; a malformed header
is a 400.

`HttpApiClient` mirrors the FakeApiServer surface (get, list, create,
update, update_status, delete, apply, record_event, watch), so controller-side
code runs the same in-process or against the facade: keep-alive
connections from a pool, bounded write retries that never double-apply
(a create claims an AlreadyExists only when the stored object holds
what it sent; a delete takes NotFound as done; an update carries its
resourceVersion), and an informer watch loop that lists every watched
kind, then follows the stream from the list's resourceVersion,
reconnects after a dropped stream and re-lists on Gone. The watch
prefers the stream and degrades to the long-poll, never for good:
`stream_failure_threshold` failed streams in a row open the stream
circuit for `stream_degraded_seconds` (one long-poll round follows every
failed stream), and a server that affirmatively rejects ``stream``
(a 400 naming it, `_stream_rejected`; a stray 400 is a transient error)
is re-probed every `stream_reprobe_seconds`. `watch_stats()` counts the
streams opened and failed, the long-poll rounds (those while degraded
too), the degraded episodes and seconds, and the streams opened after a
degraded episode.

`base_url` may be an endpoint list (`endpoints_from_env`: an
active-passive pair over one durable store, `testing/failover.py`), of
``http`` or ``https`` URLs; an https endpoint is verified against the
pinned platform CA (`ca=` or ``KFTPU_CA``, `web/tls.py`), never the
system trust store, and without one the client refuses to start. The
client talks to one endpoint at a time and fails over, stickily (one
takeover costs one rotation), when a dial is refused (a write too:
nothing was sent) or when that endpoint's circuit is open (per-endpoint
`CircuitBreaker`s: repeated transport failures or 5xx shed to the next
endpoint). Once bytes are on the wire the ambiguous-failure rules above
apply unchanged. A watch that dies with its endpoint resumes on the
next one from its bookmark; a bookmark the new active cannot serve gets
410 and the informer relists. `failovers` counts rotations and
`handshakes` the connections dialed, refused dials included.

With `tokens` (an `api/tokens.TokenRegistry`) the facade is secure:
every request but /healthz carries ``Authorization: Bearer <token>``
naming a registered identity (else 401), and every operation is gated
by a SubjectAccessReview over the stored RBAC objects (`api/rbac.py`;
else 403 with a readable message). Status is its own RBAC subresource
(``<resource>/status``), and a create from an identity without that
grant has its status dropped. A watch of one kind needs ``watch`` on
it; the multiplexed ``_`` stream delivers only the objects whose kind
and namespace the identity may watch. Without `tokens` the facade is
open (the test seam and localhost rigs; every earlier caller).

Two more routes: ``GET /apis/Pod/<ns>/<name>/log`` serves the pod's
captured stdout (`runtime/local.LocalPodRunner` publishes
``status.logPath``), only from files under `log_root` (status is
client-writable), and ``GET /debug/traces`` drains the process's
finished tracing spans (`utils/tracing.py`; gated as a delete of
``traces`` cluster-wide, since draining clears them).

`HttpApiClient` sends a bearer token (`token=` or ``KFTPU_TOKEN``),
never over plaintext http unless the caller opts in
(``allow_plaintext_token=`` or ``KFTPU_ALLOW_PLAINTEXT=1``), and the
active span's trace id on every call, so a reconcile's calls join its
trace; a 401 or 403 raises `Forbidden`; `pod_log` reads the log route.

"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import os
import pathlib
import random
import re
import threading
import time
import urllib.parse

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.api.rbac import resource_for_kind, subject_access_review
from kubeflow_tpu_torch.api.tokens import TokenRegistry
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    ApiError,
    Conflict,
    FakeApiServer,
    Forbidden,
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
    error_response,
    json_response,
)
from kubeflow_tpu_torch.utils import tracing

log = logging.getLogger(__name__)


def _ns_seg(namespace: str) -> str:
    return namespace or "_"


def _seg_ns(seg: str) -> str:
    return "" if seg == "_" else seg


class WatchCache:
    """Shared watch cache: each journal event is serialized to its
    compact-JSON wire form EXACTLY ONCE, and the cached bytes fan out
    to every consumer — streaming connections write the cached line,
    long-poll responses are assembled from the cached fragments. This
    is the apiserver watch-cache property (serialize once, no matter
    how many watchers): 50 watchers of one event cost one json.dumps
    and 50 socket writes.

    Keyed by (rv, type): both stores stamp every journal event with a
    fresh rv, so the key is unique per event; DELETED events carry
    their own fresh rv by construction. Bounded FIFO — rv is monotonic,
    so eviction order is age order. Thread-safe; a rare concurrent miss
    serializes twice, which only costs the duplicate work."""

    def __init__(self, size: int = 4096):
        self._entries: collections.OrderedDict[tuple[int, str], bytes] = (
            collections.OrderedDict()
        )
        self._size = size
        self._lock = threading.Lock()
        self.serializations = 0  # misses: actual json.dumps calls
        self.hits = 0

    def event_bytes(self, rv: int, etype: str, obj: Resource) -> bytes:
        """Wire form of one watch event, without trailing newline:
        {"type":...,"rv":...,"object":{...}}. The object payload comes
        from the snapshot's own cached wire bytes (`Resource.
        wire_bytes`), so even the one serialization per event is shared
        with get/list responses of the same snapshot."""
        key = (rv, etype)
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self.hits += 1
                return cached
        data = (
            b'{"type":"' + etype.encode() + b'","rv":' + str(rv).encode()
            + b',"object":' + obj.wire_bytes() + b"}"
        )
        with self._lock:
            self.serializations += 1
            self._entries[key] = data
            while len(self._entries) > self._size:
                self._entries.popitem(last=False)
        return data


class ApiServerApp(App):
    """REST facade over a `FakeApiServer`: secure with `tokens`, open
    without (see the module docstring). `log_root` is the directory the
    pod-log route may serve from; None serves no logs."""

    # How long one streaming response lives before the server ends it
    # cleanly (bounds a dead client's grip on its thread; a live client
    # re-opens on its pooled connection).
    STREAM_DURATION = 240.0
    # Bookmark cadence: each quiet slice emits a BOOKMARK line, a
    # heartbeat and an rv advance.
    STREAM_SLICE = 5.0

    def __init__(
        self,
        api: FakeApiServer,
        log_root: str | None = None,
        tokens: TokenRegistry | None = None,
    ):
        super().__init__("apiserver")
        self.api = api
        self.tokens = tokens
        self.watch_cache = WatchCache()
        if tokens is not None:
            self.before_request(self._authenticate)
        self.log_root = pathlib.Path(log_root).resolve() if log_root else None
        self.add_route("/apis/<kind>", self.list_kind)
        self.add_route("/apis/<kind>", self.create, ("POST",))
        self.add_route("/apis/<kind>/<ns>/<name>", self.get)
        self.add_route("/apis/<kind>/<ns>/<name>", self.update, ("PUT",))
        self.add_route("/apis/<kind>/<ns>/<name>", self.delete, ("DELETE",))
        self.add_route("/apis/<kind>/<ns>/<name>/status", self.update_status, ("PUT",))
        self.add_route("/apis/Pod/<ns>/<name>/log", self.pod_log)
        self.add_route("/debug/traces", self.drain_traces)

    # -- authentication and authorization ------------------------------------

    def _authenticate(self, req: Request) -> Response | None:
        """Before-request hook (secure mode): the bearer token's identity
        or a 401. /healthz stays open for probes."""
        if req.path == "/healthz":
            return None
        scheme, _, token = req.headers.get("authorization", "").partition(" ")
        user = (self.tokens.authenticate(token.strip())
                if scheme.lower() == "bearer" and token.strip() else None)
        if user is None:
            return error_response(
                401, "no valid bearer token (secure facade: every request needs "
                "'Authorization: Bearer <token>')")
        req.user = user
        return None

    def _authorize(self, req: Request, verb: str, resource: str, namespace: str) -> None:
        """The SubjectAccessReview gate of one operation; a no-op when
        open."""
        if self.tokens is None:
            return
        if not subject_access_review(self.api, req.user, verb, resource, namespace):
            scope = f"in namespace {namespace!r}" if namespace else "cluster-wide"
            raise HttpError(403, f"user {req.user!r} is not allowed to {verb} {resource} {scope}")

    def _watchable(self, req: Request, kind: str):
        """The per-event filter of the multiplexed ``_`` stream: an event
        passes when its (kind, namespace) may be watched by the
        identity. None when every event passes (open mode, or a
        concrete kind, authorized up front)."""
        if self.tokens is None or kind != "_":
            return None
        cache: dict = {}

        def may_watch(obj: Resource) -> bool:
            key = (obj.kind, obj.metadata.namespace or "")
            if key not in cache:
                cache[key] = subject_access_review(
                    self.api, req.user, "watch", resource_for_kind(obj.kind), key[1])
            return cache[key]

        return may_watch

    def drain_traces(self, req: Request) -> Response:
        # Draining clears the shared tracer: gated as a write.
        self._authorize(req, "delete", "traces", "")
        return json_response({"spans": tracing.tracer.export(),
                              "dropped": tracing.tracer.dropped})

    def pod_log(self, req: Request) -> Response:
        """The pod's captured stdout (the kubelet log endpoint's RBAC
        resource, ``pods/log``, verb get)."""
        ns = _seg_ns(req.path_params["ns"])
        self._authorize(req, "get", "pods/log", ns)
        if self.log_root is None:
            raise HttpError(404, "log serving not configured (no capture directory)")
        pod = self.api.get("Pod", req.path_params["name"], ns)
        log_path = pod.status.get("logPath")
        if not log_path:
            raise HttpError(404, f"pod {pod.metadata.name!r} has no captured logs (the "
                            "local runtime publishes status.logPath when capture is on)")
        path = pathlib.Path(log_path).resolve()
        # status is client-writable: nothing outside the capture root.
        if not path.is_relative_to(self.log_root):
            raise HttpError(404, f"log path for {pod.metadata.name!r} is outside the "
                            "capture directory")
        if not path.is_file():
            raise HttpError(404, f"log file {log_path!r} is gone")
        return Response(path.read_bytes(), content_type="text/plain")

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
        self._authorize(req, "list", resource_for_kind(req.path_params["kind"]),
                        _seg_ns(namespace) if namespace is not None else "")
        # The list's rv is the watch bookmark, read BEFORE listing: an
        # object committed between the two reads is then delivered again
        # by the watch (at least once) instead of lost behind it.
        rv = self.api.current_rv
        items = self.api.list(
            req.path_params["kind"],
            namespace=_seg_ns(namespace) if namespace is not None else None,
            label_selector=selector,
        )
        items = [self._at_version(r, req) for r in items]
        body = (
            b'{"items":[' + b",".join(r.wire_bytes() for r in items)
            + b'],"resourceVersion":' + str(rv).encode() + b"}"
        )
        return Response(body)

    def _watch(self, req: Request) -> Response:
        """The watch from `resourceVersion`, in two forms; `_` as the kind
        watches every kind (the client multiplexes one watch across its
        handlers).

        Long-poll (the default): block until events land past the
        bookmark or `timeoutSeconds` (at most 60) pass, and return them
        with the rv to resume from; 410 past the journal's horizon.

        Streaming (``stream=true``): one chunked response held open across
        events, a BOOKMARK line each quiet `STREAM_SLICE` and an ERROR
        line carrying the would-be status (410, 503) before it ends."""
        try:
            since = int(req.query.get("resourceVersion", "0"))
        except ValueError:
            raise HttpError(400, "resourceVersion must be an integer") from None
        kind = req.path_params["kind"]
        namespace = req.query.get("namespace")
        if kind != "_":
            # A concrete kind is authorized up front (a 403 beats a
            # watch that silently delivers nothing); `_` per event.
            self._authorize(req, "watch", resource_for_kind(kind),
                            _seg_ns(namespace) if namespace is not None else "")
        may_watch = self._watchable(req, kind)
        if req.query.get("stream") in ("true", "1"):
            return self._watch_stream(req, since, kind, namespace, may_watch)
        timeout = min(float(req.query.get("timeoutSeconds", "10")), 60.0)
        try:
            events, rv = self.api.wait_events(
                since,
                kind=None if kind == "_" else kind,
                namespace=_seg_ns(namespace) if namespace is not None else None,
                timeout=timeout,
            )
        except Gone as e:
            raise HttpError(410, str(e)) from None
        # The envelope from the cached per-event bytes: N long-pollers of
        # one event share one serialization.
        frags = [self.watch_cache.event_bytes(ev_rv, ev, obj) for ev_rv, ev, obj in events
                 if may_watch is None or may_watch(obj)]
        return Response(b'{"events":[' + b",".join(frags)
                        + b'],"resourceVersion":' + str(rv).encode() + b"}")

    def _watch_stream(self, req: Request, since: int, kind: str, namespace: str | None,
                      may_watch) -> StreamResponse:
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
                    if may_watch is not None and not may_watch(obj):
                        continue
                    out += self.watch_cache.event_bytes(ev_rv, ev, obj) + b"\n"
                rv = new_rv
                out += line({"type": "BOOKMARK", "resourceVersion": rv})
                yield bytes(out)

        return StreamResponse(gen())

    @staticmethod
    def _lease_guard(req: Request):
        """The write's lease guard from X-Kftpu-Lease-Guard, or None: the
        store verifies holder and generation atomically with the commit
        (`fake_apiserver.check_lease_guard`)."""
        raw = req.headers.get("x-kftpu-lease-guard")
        if not raw:
            return None
        try:
            ns, name, holder, transitions = json.loads(raw)
            return (str(ns), str(name), str(holder), int(transitions))
        except (ValueError, TypeError) as e:
            raise HttpError(400, f"malformed X-Kftpu-Lease-Guard header: {e}") from None

    def get(self, req: Request) -> Response:
        self._authorize(req, "get", resource_for_kind(req.path_params["kind"]),
                        _seg_ns(req.path_params["ns"]))
        obj = self.api.get(
            req.path_params["kind"], req.path_params["name"], _seg_ns(req.path_params["ns"])
        )
        return Response(self._at_version(obj, req).wire_bytes())

    def _at_version(self, obj: Resource, req: Request) -> Resource:
        """`obj` at the query's ``version``, or as stored. An unserved
        version raises Invalid, which the app maps to 422 and the client
        maps back."""
        version = req.query.get("version")
        if not version:
            return obj
        return self.api.convert_to(obj, version)

    def create(self, req: Request) -> Response:
        obj = Resource.from_dict(req.json())
        if obj.kind != req.path_params["kind"]:
            raise HttpError(400, "kind mismatch between path and body")
        resource = resource_for_kind(obj.kind)
        namespace = obj.metadata.namespace or ""
        if self.tokens is not None and obj.status and not subject_access_review(
                self.api, req.user, "update", resource + "/status", namespace):
            # A create-only identity must not forge a status (a Succeeded
            # phase, say): dropped, as the real apiserver does. An
            # identity with the status grant (a runtime that materializes
            # Running objects) keeps it.
            obj.status = {}
        if req.query.get("apply") in ("true", "1"):
            # Server-side apply: the store's create-or-update, so a remote
            # reconciler's apply is a no-op exactly when an in-process
            # one's is and does not re-trigger its own watches. It needs
            # both verbs.
            self._authorize(req, "create", resource, namespace)
            self._authorize(req, "update", resource, namespace)
            return json_response(
                self.api.apply(obj, lease_guard=self._lease_guard(req)).to_dict())
        self._authorize(req, "create", resource, namespace)
        return json_response(
            self.api.create(obj, lease_guard=self._lease_guard(req)).to_dict(), status=201)

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
        self._authorize(req, "update", resource_for_kind(req.path_params["kind"]),
                        _seg_ns(req.path_params["ns"]))
        return json_response(self.api.update(
            self._body_matching_path(req), lease_guard=self._lease_guard(req)).to_dict())

    def update_status(self, req: Request) -> Response:
        # Its own subresource: `tpujobs` update does not grant
        # `tpujobs/status`.
        self._authorize(req, "update", resource_for_kind(req.path_params["kind"]) + "/status",
                        _seg_ns(req.path_params["ns"]))
        return json_response(self.api.update_status(
            self._body_matching_path(req), lease_guard=self._lease_guard(req)).to_dict())

    def delete(self, req: Request) -> Response:
        self._authorize(req, "delete", resource_for_kind(req.path_params["kind"]),
                        _seg_ns(req.path_params["ns"]))
        self.api.delete(
            req.path_params["kind"], req.path_params["name"], _seg_ns(req.path_params["ns"]),
            lease_guard=self._lease_guard(req),
        )
        return json_response({"deleted": True})


class CircuitBreaker:
    """Per-endpoint circuit breaker: `threshold` consecutive
    transport-class failures open the circuit for `cooldown` seconds, in
    which calls shed at once instead of hammering the endpoint; after the
    cooldown one probe a window goes through (half-open) and one success
    closes it. A functional error status (404, 409, 422) is a success
    here: the endpoint answered."""

    def __init__(self, threshold: int = 5, cooldown: float = 2.0):
        self.threshold = threshold
        self.cooldown = cooldown
        self.failures = 0
        self.trips = 0  # times the circuit opened
        self._probe_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.failures < self.threshold:
                return True
            now = time.monotonic()
            if now >= self._probe_at:
                self._probe_at = now + self.cooldown  # this window's one probe
                return True
            return False

    def success(self) -> None:
        with self._lock:
            self.failures = 0

    def failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.failures >= self.threshold:
                # A failed half-open probe re-trips and restarts the
                # cooldown, so `trips` shows a flapping endpoint's history.
                self.trips += 1
                self._probe_at = time.monotonic() + self.cooldown

    @property
    def open(self) -> bool:
        with self._lock:
            return self.failures >= self.threshold and time.monotonic() < self._probe_at


def endpoints_from_env(value: str) -> list[str]:
    """The apiserver address of the launcher's env contract
    (``KFTPU_APISERVER``): one URL or a comma-separated endpoint list."""
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


class _Endpoint:
    """One apiserver address: its parsed location, its own keep-alive
    pool and the connections dialed to it."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        parts = urllib.parse.urlsplit(self.url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"{self.url!r}: an apiserver endpoint is http:// or https://")
        self.host = parts.hostname or "127.0.0.1"
        self.https = parts.scheme == "https"
        self.port = parts.port or (443 if self.https else 80)
        self.pool: list = []
        self.handshakes = 0

    def __repr__(self) -> str:
        return f"_Endpoint({self.url!r})"


class _ConnectFailed(Exception):
    """The dial failed before any request byte was sent: the one
    transport failure that is unambiguous for every method, so the
    client may replay even a write on the next endpoint."""

    def __init__(self, cause: OSError):
        super().__init__(str(cause))
        self.cause = cause


class HttpApiClient:
    """Remote twin of FakeApiServer's CRUD and watch surface.

    `base_url` is one URL or a list of them (see the module docstring).
    Keyword arguments override the class's timing constants for this
    client; `ca` pins the platform CA for https endpoints (default
    ``KFTPU_CA``); `token` is the bearer credential (default
    ``KFTPU_TOKEN``)."""

    # Idle connections kept per endpoint (a worker runs one watch stream
    # and a few concurrent calls).
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

    def __init__(
        self,
        base_url,
        *,
        ca: str | None = None,
        token: str | None = None,
        allow_plaintext_token: bool | None = None,
        timeout: float | None = None,
        watch_retry: float | None = None,
        watch_poll_timeout: float = 5.0,
        write_retries: int | None = None,
        retry_base: float | None = None,
        retry_cap: float | None = None,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 2.0,
        stream_failure_threshold: int = 3,
        stream_degraded_seconds: float = 5.0,
        stream_reprobe_seconds: float = 60.0,
    ):
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("HttpApiClient needs at least one endpoint")
        self._endpoints = [_Endpoint(u) for u in urls]
        # The endpoint requests go to first; a rotation moves every later
        # request (and the watch stream) until that endpoint fails in turn.
        self._active = 0
        self._endpoint_lock = threading.Lock()
        self.failovers = 0  # endpoint rotations
        for attr, value in (("TIMEOUT", timeout), ("WATCH_RETRY", watch_retry),
                            ("WRITE_RETRIES", write_retries), ("RETRY_BASE", retry_base),
                            ("RETRY_CAP", retry_cap)):
            if value is not None:
                setattr(self, attr, value)
        # The pinned CA (a path or inline PEM), passed on to the pods a
        # runner on this client starts.
        self.ca = ca = ca if ca is not None else os.environ.get("KFTPU_CA")
        self._ssl = None
        if any(ep.https for ep in self._endpoints):
            if not ca:
                # The platform CA is self-signed: without the pin every
                # request would die later with CERTIFICATE_VERIFY_FAILED.
                raise ValueError(
                    f"https endpoint {self._endpoints[0].url!r} needs the platform CA "
                    "pinned (ca=, --ca or KFTPU_CA)")
            from kubeflow_tpu_torch.web import tls as tlsmod

            self._ssl = tlsmod.client_context(ca)
        # The identity credential; a pod's worker inherits it from its
        # env like the endpoints and the CA.
        self.token = token if token is not None else os.environ.get("KFTPU_TOKEN")
        plaintext = [ep.url for ep in self._endpoints if not ep.https]
        if plaintext and self.token:
            # A bearer token over cleartext is a leaked credential: every
            # endpoint must be https (a failover would leak it too),
            # unless the caller opts in for a trusted loopback.
            if allow_plaintext_token is None:
                allow_plaintext_token = os.environ.get("KFTPU_ALLOW_PLAINTEXT") == "1"
            if not allow_plaintext_token:
                raise ValueError(
                    f"refusing to send a bearer token over plaintext {plaintext[0]!r}: use "
                    "https:// (pin the CA via ca=/KFTPU_CA) or pass allow_plaintext_token=True"
                    " / KFTPU_ALLOW_PLAINTEXT=1 for a trusted loopback")
        self.retries_total = 0  # write attempts beyond the first
        self._pool_lock = threading.Lock()
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._watchers: list[tuple[str | None, WatchHandler]] = []
        self._watch_lock = threading.Lock()
        self._watch_thread: threading.Thread | None = None
        self._closed = threading.Event()
        # Leader-election write fencing: when armed, every write carries
        # the guard and the store refuses it (Conflict) unless the lease
        # still shows this holder and generation.
        self.lease_guard: tuple[str, str, str, int] | None = None
        # The watch's health: failed streams past the threshold shed it to
        # long-poll for `stream_degraded_seconds`, then the stream is
        # probed again; a server that affirmatively rejects the stream
        # form is re-probed every `stream_reprobe_seconds`.
        self.watch_poll_timeout = watch_poll_timeout
        self._stream_breaker = CircuitBreaker(threshold=stream_failure_threshold,
                                              cooldown=stream_degraded_seconds)
        self.stream_reprobe_seconds = stream_reprobe_seconds
        self._stream_unsupported_until = 0.0
        self._degraded_since: float | None = None
        self._watch_counts = collections.Counter()
        self._stats_lock = threading.Lock()
        self._degraded_s = 0.0

    def set_lease_guard(self, guard: tuple[str, str, str, int] | None) -> None:
        """Arm (or, with None, disarm) the lease guard on every write.
        Pass `LeaderElector.guard` once leading: from then on a deposed
        leader's writes are Conflicts, never changes to its successor's
        term."""
        self.lease_guard = guard

    # -- endpoints ------------------------------------------------------------

    def _endpoint(self) -> _Endpoint:
        with self._endpoint_lock:
            return self._endpoints[self._active]

    @property
    def base_url(self) -> str:
        """The endpoint serving this client now."""
        return self._endpoint().url

    @property
    def endpoints(self) -> tuple[str, ...]:
        return tuple(ep.url for ep in self._endpoints)

    @property
    def handshakes(self) -> int:
        """Connections dialed over all endpoints, refused dials included
        (a served https connection is one TLS handshake)."""
        return sum(ep.handshakes for ep in self._endpoints)

    def _set_active(self, ep: _Endpoint) -> None:
        with self._endpoint_lock:
            idx = self._endpoints.index(ep)
            if idx != self._active:
                self._active = idx
                self.failovers += 1
                log.info("apiserver failover: now talking to %s", ep.url)

    def _breaker_for(self, ep: _Endpoint, method: str, path: str) -> CircuitBreaker:
        """One breaker per endpoint, method and endpoint class (the first
        two path segments): a sick watch does not open the circuit for
        writes, and a dead active's open circuits never gate its standby."""
        bare = path.partition("?")[0]
        key = f"{ep.url} {method} /" + "/".join(bare.split("/")[1:3])
        with self._breakers_lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = self._breakers[key] = CircuitBreaker(
                    threshold=self.breaker_threshold, cooldown=self.breaker_cooldown)
            return breaker

    def breaker_state(self) -> dict[str, tuple[int, bool]]:
        """Each endpoint class's breaker: (trips, open now)."""
        with self._breakers_lock:
            snapshot = dict(self._breakers)
        return {k: (b.trips, b.open) for k, b in snapshot.items()}

    # -- transport ----------------------------------------------------------

    def _new_conn(self, ep: _Endpoint) -> http.client.HTTPConnection:
        if ep.https:
            conn = http.client.HTTPSConnection(ep.host, ep.port, timeout=self.TIMEOUT,
                                               context=self._ssl)
        else:
            conn = http.client.HTTPConnection(ep.host, ep.port, timeout=self.TIMEOUT)
        conn._kftpu_reused = False
        conn._kftpu_ep = ep
        with self._pool_lock:
            ep.handshakes += 1
        return conn

    def _get_conn(self, ep: _Endpoint) -> http.client.HTTPConnection:
        now = time.monotonic()
        with self._pool_lock:
            while ep.pool:
                conn = ep.pool.pop()
                if now - conn._kftpu_idle_since <= self.POOL_IDLE_MAX:
                    return conn
                conn.close()
        return self._new_conn(ep)

    def _put_conn(self, conn) -> None:
        conn._kftpu_reused = True
        conn._kftpu_idle_since = time.monotonic()
        if conn.sock is not None:
            conn.sock.settimeout(self.TIMEOUT)  # a stream may have raised it
        ep = conn._kftpu_ep
        with self._pool_lock:
            if len(ep.pool) < self.POOL_SIZE and not self._closed.is_set():
                ep.pool.append(conn)
                return
        conn.close()

    def _attempt(self, ep: _Endpoint, method: str, path: str, data, headers):
        """One round trip against one endpoint. A failed dial (nothing
        sent) raises `_ConnectFailed`; after bytes hit the wire only a
        GET retries, once, on a fresh connection when a reused one died:
        for a write the failure is ambiguous (the server may have
        committed), so it propagates to `_write_with_retry`."""
        while True:
            conn = self._get_conn(ep)
            if conn.sock is None:
                try:
                    conn.connect()
                except OSError as e:
                    conn.close()
                    raise _ConnectFailed(e) from e
            try:
                conn.request(method, path, body=data, headers=headers)
                return conn, conn.getresponse()
            except (http.client.HTTPException, OSError):
                reused = conn._kftpu_reused
                conn.close()
                if reused and method == "GET":
                    continue  # a stale keep-alive connection: one fresh retry
                raise

    def _request_raw(self, method: str, path: str, body: dict | None = None):
        """One round trip; returns (conn, resp) with the response unread.
        Starting at the active endpoint, it skips endpoints whose circuit
        is open and rotates past those that refuse the dial; the one that
        answers becomes active. With one endpoint an open circuit raises
        Unavailable and a refused dial its OSError."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json", **tracing.trace_header()}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        guard = self.lease_guard
        if guard is not None and method in ("POST", "PUT", "DELETE"):
            headers["X-Kftpu-Lease-Guard"] = json.dumps(list(guard))
        eps = self._endpoints
        with self._endpoint_lock:
            start = self._active
        last_exc: Exception | None = None
        for k in range(len(eps)):
            ep = eps[(start + k) % len(eps)]
            breaker = self._breaker_for(ep, method, path)
            if not breaker.allow():
                last_exc = Unavailable(
                    f"circuit open for {method} {path.partition('?')[0]} at {ep.url} "
                    "(failing fast after repeated endpoint failures)")
                continue
            try:
                conn, resp = self._attempt(ep, method, path, data, headers)
            except _ConnectFailed as e:
                breaker.failure()
                last_exc = e.cause
                continue  # the dial failed and nothing was sent: rotate
            except Exception:
                breaker.failure()
                raise  # ambiguous once bytes were sent: never rotate
            self._set_active(ep)
            return conn, resp
        raise last_exc

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
        if status in (401, 403):
            raise Forbidden(detail)
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
        breaker = self._breaker_for(conn._kftpu_ep, method, path)
        try:
            data = self._finish(conn, resp)
        except Exception:
            breaker.failure()
            raise
        # A 5xx counts against the endpoint; any other status, 404, 409
        # and 422 included, shows that it answers.
        if status >= 500:
            breaker.failure()
        else:
            breaker.success()
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

    def get(self, kind: str, name: str, namespace: str = "default",
            version: str | None = None) -> Resource:
        """The object, at `version` when given (any served version)."""
        query = f"?{urllib.parse.urlencode({'version': version})}" if version else ""
        return Resource.from_dict(
            self._call("GET", f"/apis/{kind}/{_ns_seg(namespace)}/{name}{query}"))

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
        version: str | None = None,
    ) -> list[Resource]:
        params = {}
        if version:
            params["version"] = version
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

    def pod_log(self, name: str, namespace: str = "default") -> str:
        """The pod's captured stdout, as text."""
        conn, resp = self._request_raw("GET", f"/apis/Pod/{_ns_seg(namespace)}/{name}/log")
        status = resp.status
        data = self._finish(conn, resp)
        if status >= 400:
            detail = data.decode(errors="replace")
            try:
                detail = json.loads(detail).get("log", detail)
            except ValueError:
                pass
            self._raise_for_status(status, detail)
        return data.decode(errors="replace")

    def apply(self, obj: Resource) -> Resource:
        """Create-or-update, evaluated by the store behind the facade.
        Declarative, so the transient-failure retry needs no recovery."""
        return self._write_with_retry(lambda: Resource.from_dict(
            self._call("POST", f"/apis/{obj.kind}?apply=true", obj.to_dict())))

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
            conns = [c for ep in self._endpoints for c in ep.pool]
            for ep in self._endpoints:
                ep.pool = []
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

    def _stream_allowed(self) -> bool:
        """Whether this pass tries the streaming form: not while the
        server has rejected it (until the re-probe) nor while the stream
        circuit is open (long-poll, degraded)."""
        if time.monotonic() < self._stream_unsupported_until:
            return False
        return self._stream_breaker.allow()

    @property
    def stream_degraded(self) -> bool:
        """True while the watch long-polls instead of streaming."""
        return (time.monotonic() < self._stream_unsupported_until
                or self._stream_breaker.open)

    def watch_stats(self) -> dict:
        """The watch's transport counters: streams opened and failed,
        long-poll rounds (and those while degraded), degraded episodes
        and seconds (an episode still open counts to now), and streams
        opened after a degraded episode."""
        with self._stats_lock:
            out = {k: self._watch_counts[k] for k in (
                "stream_opens", "stream_failures", "longpoll_rounds",
                "longpoll_rounds_degraded", "degraded_episodes", "streams_after_degraded")}
            since = self._degraded_since
            out["degraded_seconds"] = self._degraded_s + (
                time.monotonic() - since if since is not None else 0.0)
        return out

    def _count(self, what: str) -> None:
        with self._stats_lock:
            self._watch_counts[what] += 1

    def _note_degraded(self) -> None:
        with self._stats_lock:
            if self._degraded_since is None:
                self._degraded_since = time.monotonic()
                self._watch_counts["degraded_episodes"] += 1

    def _note_stream_open(self) -> None:
        with self._stats_lock:
            self._watch_counts["stream_opens"] += 1
            if self._degraded_since is not None:
                self._degraded_s += time.monotonic() - self._degraded_since
                self._degraded_since = None
                self._watch_counts["streams_after_degraded"] += 1

    def _watch_loop(self) -> None:
        rv = None
        # Prefer the stream; fall back to long-polling while the server
        # rejects it or the stream circuit is open. Neither fallback is
        # sticky: a rejection is re-probed every stream_reprobe_seconds,
        # and failed streams shed to long-poll only for the breaker's
        # cooldown.
        while not self._closed.is_set():
            try:
                if rv is None:
                    rv = self._resync()
                if self._stream_allowed():
                    try:
                        rv = self._stream_once(rv)
                        self._stream_breaker.success()
                        continue
                    except _StreamUnsupported as e:
                        log.info("server rejected the streaming watch (%s); long-polling, "
                                 "re-probe in %.0f s", e, self.stream_reprobe_seconds)
                        self._stream_unsupported_until = (
                            time.monotonic() + self.stream_reprobe_seconds)
                    except (Gone, PermissionError):
                        raise
                    except Exception:
                        if self._closed.is_set():
                            return
                        # Against the stream circuit; then one long-poll
                        # round, so progress continues while the stream is
                        # sick.
                        self._stream_breaker.failure()
                        self._count("stream_failures")
                        log.debug("stream watch failed (%d in a row); long-poll round",
                                  self._stream_breaker.failures, exc_info=True)
                degraded = self.stream_degraded
                if degraded:
                    self._note_degraded()
                params = urllib.parse.urlencode({"watch": "true", "resourceVersion": rv,
                                                 "timeoutSeconds": self.watch_poll_timeout})
                data = self._call("GET", f"/apis/_?{params}")
            except Gone:
                rv = None  # the journal's horizon passed us: re-list
                continue
            except PermissionError as e:
                if self._closed.is_set():
                    return
                # A missing, revoked or under-privileged token does not
                # heal by retrying hot: say so and back off hard.
                log.error("watch unauthorized (%s); backing off", e)
                self._closed.wait(max(self.WATCH_RETRY, 5.0))
                continue
            except Exception:
                if self._closed.is_set():
                    return
                log.debug("watch error; retrying", exc_info=True)
                self._closed.wait(self.WATCH_RETRY)
                continue
            self._count("longpoll_rounds")
            if degraded:
                self._count("longpoll_rounds_degraded")
            rv = data["resourceVersion"]
            for ev in data["events"]:
                self._dispatch(ev["type"], Resource.from_dict(ev["object"]))

    def _stream_once(self, rv: int) -> int:
        """Consume one streaming watch response, dispatching events as
        their lines arrive; returns the rv to resume from when the
        server ends the stream cleanly. Raises on a dropped stream (the
        loop reconnects from the last rv) and Gone on a 410."""
        params = urllib.parse.urlencode({"watch": "true", "stream": "true", "resourceVersion": rv})
        conn, resp = self._request_raw("GET", f"/apis/_?{params}")
        if resp.status == 400:
            detail = self._finish(conn, resp).decode(errors="replace")
            if _stream_rejected(detail):
                raise _StreamUnsupported(detail)
            # A stray 400 (an intermediary, a fault, a bad bookmark) is no
            # evidence that the server lacks the stream form.
            raise ApiError(f"watch stream HTTP 400: {detail}")
        if resp.status >= 400:
            status = resp.status
            self._raise_for_status(status, self._finish(conn, resp).decode(errors="replace"))
        self._note_stream_open()
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


def _stream_rejected(detail: str) -> bool:
    """Whether a 400 body is an AFFIRMATIVE rejection of the streaming
    watch: the stream token at a word start (an intermediary's
    "upstream" never matches) AND rejection language ("stream timeout"
    and "stream reset" transients never match). Only such a rejection
    may put the client in long-poll fallback."""
    message = detail
    try:
        parsed = json.loads(detail)
        if isinstance(parsed, dict):
            message = parsed.get("log", detail)
    except ValueError:
        pass
    message = str(message)
    return (re.search(r"\bstream", message, re.IGNORECASE) is not None
            and re.search(r"unsupported|not supported|unknown|unrecognized|invalid|parameter",
                          message, re.IGNORECASE) is not None)


class _StreamUnsupported(Exception):
    """The server affirmatively rejected ``stream=true``: long-poll and
    re-probe every `stream_reprobe_seconds`, never for good."""
