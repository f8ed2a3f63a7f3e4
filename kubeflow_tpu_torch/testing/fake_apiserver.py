"""An in-process API server with K8s storage semantics.

A cut-down copy of `kubeflow_tpu/testing/fake_apiserver.py` (a module
with no JAX in it), holding what the serving control plane uses:

- optimistic concurrency (resourceVersion conflict on stale writes)
- spec/status as separate update surfaces (`update`, `update_status`)
- label selectors on list
- watch events (ADDED/MODIFIED/DELETED) delivered to subscribers on a
  dispatcher thread, off the store lock; `flush()` is the barrier that
  deterministic tests drain on, and `close()` ends the thread
- the resumable event journal (`events_since`, `wait_events`) that the
  HTTP facade's watch stream serves, with `Gone` past its horizon
- finalizers: deleting an object that still lists finalizers only
  stamps its deletionTimestamp (a commit of its own, a MODIFIED event);
  the update that clears its last finalizer removes it
- owner references: removing an object deletes its dependents, and
  removing a Namespace drains every object in it (the real apiserver's
  namespace deletion); a dependent that is itself held by finalizers
  stays until it is finalized
- a create into a namespace this store drained is refused (NotFound, as
  the real apiserver's namespace lifecycle admission answers for a
  namespace that is gone) until a Namespace of that name is created
  again. The JAX store accepts it: a reconcile or a materializer step
  that read its object before a drain and creates after it would leave
  a pod nothing owns in a namespace that no longer exists, and a pod
  runner would start it. The set is kept in memory only.
- `apply` (create-or-update, a no-op when nothing changed) and
  `record_event`
- in-process admission hooks (`register_admission`), run on create and
  spec update inside the store lock: the TpuJob operator's strict spec
  validation, ResourceQuota admission (`controllers/quota.py`) and the
  PodDefault mutator (`controllers/poddefault.py`)
- admission webhooks: a cluster-scoped `WebhookConfiguration` (https
  url, inline PEM caBundle, kinds, optional namespaces and label
  selector, timeoutSeconds, failurePolicy Fail or Ignore) makes every
  create, update and apply of its kinds POST the object to that server
  (`controllers/webhook.py` serves the protocol) outside the store lock
  and before the in-process hooks; a denial rejects under either
  policy, a mutation may change spec, labels and annotations only
- lease-guard write fencing (`check_lease_guard`): a write that carries
  a `lease_guard` lands only while the Lease it names still shows that
  holder and generation, checked under the commit lock

- durability (`persist_dir=`): every committed write is appended to a
  fsync'd WAL (`testing/persist.py`; the compiled one unless
  ``wal_backend="python"`` names its twin) before its event is journaled or
  delivered, the WAL folds into a snapshot every `snapshot_every`
  writes and on `checkpoint()`/`close()`, and a store built over the
  same directory restores the objects and the resourceVersion
  (`_restore_locked`: snapshot plus WAL tail, a torn tail repaired, the
  watch floor re-seeded at the durable rv so an older bookmark gets
  Gone and relists). After a failed or fenced durable write the store
  fail-stops: every operation raises Unavailable (`_fail_stop_locked`).
  `wal_wrap=` wraps the opened WAL, as `testing/failover.term_fence`
  does for an active-passive pair.

Storage is copy-on-write: each commit deep-copies the incoming object
once, freezes it and shares that snapshot with the object map, the
journal, every watch handler and get/list results. `.thaw()` gives a
private mutable copy.

Multi-version kinds (`api/versioning.py`, the Notebook's v1alpha1,
v1beta1 and hub v1): every write at any served apiVersion is converted
to the kind's hub version before admission and storage, so the journal,
the watches and the WAL (`testing/persist.py`, JAX's format) hold the
hub form only; `convert_to` renders a stored object at another served
version. An unserved version is Invalid.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import threading
import time
from operator import itemgetter
from typing import Callable

from kubeflow_tpu_torch.api import versioning
from kubeflow_tpu_torch.api.objects import ObjectMeta, Resource, fresh_uid, now

WatchHandler = Callable[[str, Resource], None]  # (event_type, obj)

log = logging.getLogger(__name__)


class ApiError(Exception):
    pass


class NotFound(ApiError):
    pass


class AlreadyExists(ApiError):
    pass


class Conflict(ApiError):
    pass


class Invalid(ApiError):
    pass


class Forbidden(ApiError, PermissionError):
    """A 401 or 403 from the secure facade: an ApiError, so per-object
    error handling (the CLI's multi-document apply) reports it and goes
    on, and a PermissionError, so callers can treat auth failures as a
    class."""


class Gone(ApiError):
    """The requested resourceVersion predates the journal's oldest entry
    (HTTP 410 on an expired watch bookmark). Clients recover the way
    informers do: re-list, then watch from the list's resourceVersion."""


class Unavailable(ApiError):
    """The store refused the operation (HTTP 503): it fail-stopped after
    a WAL write failed or was fenced, so its memory may have run ahead
    of the durable log, and it serves nothing until a process restarts
    over the intact log."""


def _matches(labels: dict[str, str], selector: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def event_name(about: Resource, reason: str, message: str, type_: str = "Normal") -> str:
    """Content-derived Event name: a retried emission of the same
    occurrence collides with its first attempt (AlreadyExists, absorbed
    by the emitters) instead of duplicating it."""
    digest = hashlib.sha1(
        "\x00".join((
            about.kind, about.metadata.namespace or "", about.metadata.name,
            str(about.metadata.uid), reason, message, type_,
        )).encode()
    ).hexdigest()[:10]
    return f"{about.metadata.name}.{digest}"


def event_resource(
    about: Resource, reason: str, message: str, *, type_: str = "Normal"
) -> Resource:
    """The K8s-style Event object every emitter records."""
    return Resource(
        kind="Event",
        metadata=ObjectMeta(
            name=event_name(about, reason, message, type_),
            namespace=about.metadata.namespace,
        ),
        spec={
            "involvedObject": {
                "kind": about.kind,
                "name": about.metadata.name,
                "uid": about.metadata.uid,
            },
            "reason": reason,
            "message": message,
            "type": type_,
        },
        status={},
    )


def check_lease_guard(get_lease_spec, guard, kind: str) -> None:
    """Write fencing: a guarded write lands only while its lease still
    shows the presented holder AND generation (leaseTransitions). The
    caller holds its store's commit lock, so the check is atomic with the
    write: a deposed leader resurfacing after a partition, even with its
    last write already in flight, gets a Conflict instead of mutating
    state its successor owns. Writes to Leases are exempt (the election
    is arbitrated by resourceVersion CAS and must stay able to transfer
    ownership). `guard` is (namespace, name, holder, transitions) or
    None; `get_lease_spec(ns, name)` returns the lease's spec, or None
    when it does not exist."""
    if guard is None or kind == "Lease":
        return
    ns, name, holder, transitions = guard
    spec = get_lease_spec(ns, name)
    if (
        spec is None
        or spec.get("holderIdentity") != holder
        or int(spec.get("leaseTransitions", 0)) != int(transitions)
    ):
        current = (
            f"held by {spec.get('holderIdentity')!r} generation "
            f"{spec.get('leaseTransitions')}"
            if spec is not None
            else "gone"
        )
        raise Conflict(
            f"fenced: lease {ns or '_'}/{name} is {current}; writer "
            f"presented {holder!r} generation {transitions}: a deposed "
            f"leader must not write into its successor's term"
        )


class FakeApiServer:
    def __init__(
        self,
        *,
        journal_size: int = 10_000,
        persist_dir: str | None = None,
        snapshot_every: int = 1_000,
        wal_backend: str = "native",
        wal_wrap=None,
    ):
        self._objects: dict[tuple[str, str, str], Resource] = {}
        self._rv = 0
        # Bookmarks below the floor are history this process never held
        # (before a restore): Gone, and the watcher relists.
        self._floor = 0
        self._lock = threading.RLock()
        self._watchers: list[tuple[str | None, WatchHandler]] = []
        # Resumable event journal, rv-ordered: (resourceVersion, event,
        # object). Bounded; a bookmark past its horizon gets Gone.
        self._journal: list[tuple[int, str, Resource]] = []
        self._journal_size = journal_size
        self._journal_cv = threading.Condition(self._lock)
        # Handler dispatch runs on its own thread, off the store lock: a
        # slow handler delays delivery, never writers. The queue keeps
        # journal (rv) order for the handlers.
        self._dispatch_cv = threading.Condition()
        self._dispatch_q: list[tuple[str, Resource]] = []
        self._dispatch_enqueued = 0
        self._dispatch_done = 0
        self._dispatcher: threading.Thread | None = None
        self._closed = False
        self._admission: list[tuple[str | None, Callable[[Resource], Resource]]] = []
        # Keys of the stored WebhookConfigurations (a restore rebuilds it).
        self._webhook_keys: set[tuple[str, str, str]] = set()
        self._wal = None
        self._snapshot_every = max(1, snapshot_every)
        self._appends_since_snapshot = 0
        # The first durable-write failure; every operation then raises
        # Unavailable (`_fail_stop_locked`).
        self._broken: BaseException | None = None
        # Namespaces drained since this store started, until created again.
        self._drained: set[str] = set()
        # The WAL backend this store opened ("native" or "python"), or None.
        self.wal_backend = wal_backend if persist_dir is not None else None
        if persist_dir is not None:
            from kubeflow_tpu_torch.testing import persist

            self._wal = persist.open_wal(persist_dir, backend=wal_backend)
            if wal_wrap is not None:
                self._wal = wal_wrap(self._wal)
            with self._lock:  # a torn-tail repair checkpoints under the lock
                self._restore_locked()

    # -- persistence --------------------------------------------------------

    def _install(self, obj: Resource) -> None:
        obj.freeze()
        self._objects[obj.key] = obj
        if obj.kind == self.WEBHOOK_KIND:
            self._webhook_keys.add(obj.key)

    def _restore_locked(self) -> None:
        """Load the snapshot, then replay the WAL past its rv. Replay
        stops at the first record that does not decode (a crash mid-append
        loses only that unacked record) and repairs the log at once, since
        the next append would otherwise glue onto the partial line and be
        dropped by the restart after. Records at or below the snapshot's
        rv are skipped (a crash between a snapshot and its truncate
        leaves them)."""
        from kubeflow_tpu_torch.testing.persist import FORMAT

        snap_text = self._wal.read_snapshot()
        if snap_text:
            try:
                snap = json.loads(snap_text)
            except ValueError as e:
                raise Invalid(f"corrupt snapshot: {e}") from e
            if snap.get("format") != FORMAT:
                raise Invalid(f"snapshot format {snap.get('format')!r} is not {FORMAT}: "
                              "refusing to guess at a migration")
            for d in snap.get("objects", []):
                self._install(Resource.from_dict(d))
            self._rv = int(snap.get("rv", 0))
        torn = False
        for line in self._wal.read_journal().splitlines():
            try:
                rec = json.loads(line)
                rv, event = int(rec["rv"]), rec["event"]
                obj = Resource.from_dict(rec["object"])
            except (ValueError, KeyError, TypeError):
                log.warning("WAL replay stopped at a torn or corrupt record")
                torn = True
                break
            if rv <= self._rv:
                continue  # a pre-snapshot leftover
            if event == "DELETED":
                self._objects.pop(obj.key, None)
                self._webhook_keys.discard(obj.key)
            else:
                self._install(obj)
            self._rv = rv
        if torn:
            self._checkpoint_locked()
        self._floor = self._rv

    def _fail_stop_locked(self, cause: BaseException) -> None:
        """A durable write failed (an IO error, or a term fence): the
        mutation is in the object map but in no journal and no watcher,
        so rather than roll it back at every mutation site the store
        stops serving. Dropping the WAL handle keeps `close` and
        `checkpoint` from snapshotting the unlogged state."""
        self._broken = cause
        wal, self._wal = self._wal, None
        if wal is not None:
            try:
                wal.close()
            except Exception:
                pass
        log.error("store fail-stopped after a persistence failure: %s", cause)
        raise Unavailable(f"store fail-stopped after a persistence failure: {cause}") from cause

    def _check_available(self) -> None:
        if self._broken is not None:
            raise Unavailable(
                f"store fail-stopped after a persistence failure: {self._broken}")

    def _persist_locked(self, event: str, obj: Resource) -> None:
        """Append one committed write to the WAL (the caller holds the
        lock), before the journal and the watchers see it: an event a
        watcher saw is never missing after a crash."""
        try:
            self._wal.append(json.dumps(
                {"rv": obj.metadata.resource_version, "event": event,
                 "object": obj.to_dict()}, separators=(",", ":")))
            self._appends_since_snapshot += 1
            if self._appends_since_snapshot >= self._snapshot_every:
                self._checkpoint_locked()
        except ApiError:
            raise
        except Exception as e:
            self._fail_stop_locked(e)

    def _checkpoint_locked(self) -> None:
        from kubeflow_tpu_torch.testing.persist import FORMAT

        try:
            self._wal.snapshot(json.dumps(
                {"format": FORMAT, "rv": self._rv,
                 "objects": [o.to_dict() for _, o in sorted(self._objects.items())]},
                separators=(",", ":")))
        except Exception as e:
            self._fail_stop_locked(e)
        self._appends_since_snapshot = 0

    def checkpoint(self) -> None:
        """Fold the WAL into a fresh snapshot now. No-op without
        persistence."""
        with self._lock:
            if self._wal is not None:
                self._checkpoint_locked()

    # -- watch ------------------------------------------------------------

    def watch(self, handler: WatchHandler, kind: str | None = None) -> None:
        """Subscribe to events; kind=None receives everything. Handlers
        receive the shared frozen snapshot. The first subscription starts
        the dispatcher thread. Raises once the store is closed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("watch on a closed apiserver")
            self._watchers.append((kind, handler))
        with self._dispatch_cv:
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="apiserver-dispatch", daemon=True
                )
                self._dispatcher.start()

    def close(self) -> None:
        """Checkpoint a durable store and release its WAL, then end watch
        delivery: drop every handler and stop the dispatcher thread. The
        thread otherwise lives as long as the process and keeps every
        handler alive, with what it holds (a controller, its runtime, the
        fleet). Reads, writes (in memory only, once the WAL is released)
        and the journal go on working; a later `watch` raises. The JAX
        store's `close` only checkpoints its WAL, so its dispatcher never
        ends."""
        with self._lock:
            if self._wal is not None:
                self._checkpoint_locked()
                self._wal.close()
                self._wal = None
            self._closed = True
            self._watchers.clear()
        with self._dispatch_cv:
            dispatcher, self._dispatcher = self._dispatcher, None
            if dispatcher is None:
                return
            self._dispatch_q.append(None)  # the stop mark, after what is queued
            self._dispatch_cv.notify_all()
        if dispatcher is not threading.current_thread():
            dispatcher.join()

    @property
    def closed(self) -> bool:
        return self._closed

    def _emit(self, event: str, obj: Resource) -> None:
        """Persist, journal and queue one committed snapshot (caller holds
        the lock, so journal order is rv order). The availability check
        here is the authoritative one: a writer past an unlocked check
        while another thread fail-stopped must not journal an event that
        was never logged."""
        self._check_available()
        if self._wal is not None:
            self._persist_locked(event, obj)
        with self._journal_cv:
            self._journal.append((obj.metadata.resource_version, event, obj))
            if len(self._journal) > self._journal_size:
                del self._journal[: -self._journal_size]
            self._journal_cv.notify_all()
        if not self._watchers:
            return
        with self._dispatch_cv:
            self._dispatch_q.append((event, obj))
            self._dispatch_enqueued += 1
            self._dispatch_cv.notify_all()

    def _dispatch_loop(self) -> None:
        while True:
            with self._dispatch_cv:
                while not self._dispatch_q:
                    self._dispatch_cv.wait()
                item = self._dispatch_q.pop(0)
                if item is None:
                    return
                event, obj = item
            with self._lock:
                watchers = list(self._watchers)
            for kind, handler in watchers:
                if kind is None or kind == obj.kind:
                    try:
                        handler(event, obj)
                    except Exception:
                        log.exception("watch handler failed for %s %s", event, obj.key)
            with self._dispatch_cv:
                self._dispatch_done += 1
                self._dispatch_cv.notify_all()

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every event emitted so far has reached every
        handler."""
        deadline = time.monotonic() + timeout
        with self._dispatch_cv:
            while self._dispatch_done < self._dispatch_enqueued:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"event dispatch did not drain "
                        f"({self._dispatch_done}/{self._dispatch_enqueued})"
                    )
                self._dispatch_cv.wait(remaining)

    @property
    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def events_since(
        self,
        resource_version: int,
        kind: str | None = None,
        namespace: str | None = None,
    ) -> tuple[list[tuple[int, str, Resource]], int]:
        """Journal entries with rv > resource_version, filtered, and the
        server's current rv (the resume point even when nothing matched).
        Raises Gone when the bookmark predates the journal."""
        with self._lock:
            self._check_available()
            if resource_version < self._floor:
                raise Gone(f"resourceVersion {resource_version} predates this server's "
                           f"history (floor {self._floor}): relist")
            journal = self._journal
            if journal and resource_version < journal[0][0] - 1:
                raise Gone(
                    f"resourceVersion {resource_version} is too old "
                    f"(journal begins at {journal[0][0]})"
                )
            start = bisect.bisect_right(journal, resource_version, key=itemgetter(0))
            out = [
                (rv, event, obj)
                for rv, event, obj in journal[start:]
                if (kind is None or obj.kind == kind)
                and (namespace is None or obj.metadata.namespace == namespace)
            ]
            return out, self._rv

    def wait_events(
        self,
        resource_version: int,
        kind: str | None = None,
        namespace: str | None = None,
        timeout: float = 10.0,
    ) -> tuple[list[tuple[int, str, Resource]], int]:
        """Long-poll form of events_since: block until events land past
        the bookmark or the timeout passes (an empty batch and the
        current rv)."""
        deadline = time.monotonic() + timeout
        with self._journal_cv:
            while True:
                events, rv = self.events_since(resource_version, kind, namespace)
                remaining = deadline - time.monotonic()
                if events or remaining <= 0:
                    return events, rv
                self._journal_cv.wait(remaining)

    # -- admission --------------------------------------------------------

    def register_admission(
        self, mutator: Callable[[Resource], Resource], kind: str | None = None
    ) -> None:
        """An admission hook applied on create AND spec update, inside the
        store lock. It gets a private copy and returns the object to
        store, or raises (`Invalid` for a refusal, which the HTTP facade
        answers with 422). Hooks must be idempotent: an update re-runs
        them over an already-admitted object."""
        with self._lock:
            self._admission.append((kind, mutator))

    def _admit(self, obj: Resource) -> Resource:
        for kind, mutator in list(self._admission):
            if kind is None or kind == obj.kind:
                obj = mutator(obj.deepcopy())
        return obj

    # -- webhook admission (the out-of-process extension point) ------------
    #
    # The reference's admission boundary is a STANDALONE TLS server the
    # apiserver calls out to (`admission-webhook/main.go:443` raw TLS,
    # `:447` mutatePods, `:597` main), registered via a webhook
    # configuration with timeout + failure semantics. Here that boundary
    # is a `WebhookConfiguration` CR:
    #
    #   spec:
    #     url: https://127.0.0.1:9443/mutate   (https only)
    #     caBundle: <inline PEM>               (pins the callee)
    #     kinds: ["Pod"]
    #     namespaces: ["team-a"]               (optional; [] = all — the
    #                                           namespaceSelector analog)
    #     selector: {matchLabels: {...}}       (optional objectSelector)
    #     timeoutSeconds: 5
    #     failurePolicy: Fail | Ignore         (default Fail)
    #
    # Callouts run OUTSIDE the store lock (an HTTP round trip must never
    # stall every writer) and BEFORE the in-process hooks — the K8s
    # ordering (mutating webhooks, then validating admission), which
    # also means quota meters the POST-mutation object and keeps its
    # in-lock check-then-insert atomicity untouched.

    WEBHOOK_KIND = "WebhookConfiguration"

    def _validate_webhook_config(self, obj: Resource) -> None:
        spec = obj.spec
        url = spec.get("url", "")
        if not url.startswith("https://"):
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: url must be "
                f"https:// (the admission callee carries object payloads; "
                f"got {url!r})"
            )
        policy = spec.get("failurePolicy", "Fail")
        if policy not in ("Fail", "Ignore"):
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: "
                f"failurePolicy must be Fail or Ignore, got {policy!r}"
            )
        kinds = spec.get("kinds")
        if not isinstance(kinds, list) or not kinds:
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: spec.kinds "
                "must be a non-empty list of kind names"
            )
        if self.WEBHOOK_KIND in kinds:
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: a webhook "
                "cannot admit WebhookConfigurations (self-bricking loop)"
            )
        timeout = spec.get("timeoutSeconds", 5)
        if not isinstance(timeout, (int, float)) or isinstance(
            timeout, bool
        ) or not timeout > 0:
            # Config-time 422, not a per-write "webhook failure" later.
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: "
                f"timeoutSeconds must be a positive number, got "
                f"{timeout!r}"
            )
        from kubeflow_tpu_torch.web.tls import is_pem_data

        ca = spec.get("caBundle", "")
        if ca and not is_pem_data(ca):
            # Inline PEM only (the K8s caBundle form). A filesystem path
            # here would make the APISERVER open an arbitrary local file
            # chosen by whoever may create webhookconfigurations, and
            # would silently break for remote clients whose path doesn't
            # exist server-side. make_webhook_config inlines a readable
            # local path client-side for the legacy convenience.
            raise Invalid(
                f"WebhookConfiguration {obj.metadata.name!r}: caBundle "
                "must be inline PEM data (paths are resolved client-side)"
            )

    def _call_webhook(
        self, cfg: Resource, obj: Resource, operation: str
    ) -> Resource:
        import json as _json
        import urllib.request

        from kubeflow_tpu_torch.web import tls as tlsmod

        spec = cfg.spec
        timeout = min(float(spec.get("timeoutSeconds", 5)), 30.0)
        ctx = None
        if spec.get("caBundle"):
            ctx = tlsmod.client_context(spec["caBundle"])
        req = urllib.request.Request(
            spec["url"],
            method="POST",
            data=_json.dumps(
                {"object": obj.to_dict(), "operation": operation}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        # The callee is the configured URL itself, never a proxy the
        # environment names.
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}),
                                             urllib.request.HTTPSHandler(context=ctx))
        with opener.open(req, timeout=timeout) as r:
            resp = _json.loads(r.read())
        if not resp.get("allowed", False):
            # A DENIAL is an admission decision, not a webhook failure:
            # it rejects under BOTH failure policies.
            raise Invalid(
                f"admission webhook {cfg.metadata.name!r} denied "
                f"{obj.kind} {obj.metadata.namespace}/"
                f"{obj.metadata.name}: {resp.get('message', 'denied')}"
            )
        if "object" not in resp:
            return obj
        mutated = Resource.from_dict(resp["object"])
        # A mutator only gets to change spec/labels/annotations — never
        # identity or concurrency fields. A swapped kind would bypass
        # the per-kind validation that ran before the callout; a dropped
        # resourceVersion would disable the stale-write Conflict check;
        # a changed name/namespace would write a different store key
        # than the client asked for. (K8s enforces the same immutable
        # fields on webhook patches.)
        before = (
            obj.kind, obj.metadata.name, obj.metadata.namespace,
            obj.metadata.uid, obj.metadata.resource_version,
            obj.api_version, obj.status,
        )
        after = (
            mutated.kind, mutated.metadata.name,
            mutated.metadata.namespace, mutated.metadata.uid,
            mutated.metadata.resource_version, mutated.api_version,
            # status too: the facade strips status from clients without
            # the <resource>/status grant BEFORE admission runs — a
            # webhook forging phase=Succeeded would bypass that guard.
            mutated.status,
        )
        if before != after:
            raise Invalid(
                f"admission webhook {cfg.metadata.name!r} altered "
                f"immutable fields of {obj.kind} "
                f"{obj.metadata.namespace}/{obj.metadata.name} "
                f"({before} -> {after}) — mutation rejected"
            )
        return mutated

    def _webhook_admit(self, obj: Resource, operation: str) -> Resource:
        """Run matching webhook callouts over `obj` (lock NOT held
        during the HTTP round trips)."""
        if obj.kind == self.WEBHOOK_KIND:
            self._validate_webhook_config(obj)
            return obj
        if not self._webhook_keys:
            return obj  # the common case costs one set check

        def _matches_cfg(spec: dict) -> bool:
            if obj.kind not in (spec.get("kinds") or []):
                return False
            namespaces = spec.get("namespaces") or []
            if namespaces and obj.metadata.namespace not in namespaces:
                return False  # the namespaceSelector analog
            selector = (spec.get("selector") or {}).get("matchLabels") or {}
            return _matches(obj.metadata.labels, selector)  # objectSelector

        with self._lock:
            # Frozen snapshots — the callout only reads cfg.spec.
            configs = [
                self._objects[k]
                for k in sorted(self._webhook_keys)
                if k in self._objects
                and _matches_cfg(self._objects[k].spec)
            ]
        for cfg in configs:  # key-sorted: deterministic order
            try:
                obj = self._call_webhook(cfg, obj, operation)
            except Invalid:
                raise  # an explicit denial, under either policy
            except Exception as e:
                if cfg.spec.get("failurePolicy", "Fail") == "Ignore":
                    log.warning(
                        "admission webhook %s unreachable (%s); "
                        "failurePolicy=Ignore — admitting unmodified",
                        cfg.metadata.name, e,
                    )
                    continue
                raise Invalid(
                    f"admission webhook {cfg.metadata.name!r} failed "
                    f"({e}) and failurePolicy=Fail — rejecting "
                    f"{obj.kind} {obj.metadata.name!r}"
                ) from e
        return obj

    # -- CRUD -------------------------------------------------------------

    def _check_lease_guard(self, guard, kind: str) -> None:
        """`check_lease_guard` against this store (the caller holds the
        lock, so check and commit are atomic)."""

        def lookup(ns: str, name: str):
            lease = self._objects.get(("Lease", ns, name))
            return lease.spec if lease is not None else None

        check_lease_guard(lookup, guard, kind)

    def _commit(self, stored: Resource, event: str) -> Resource:
        """THE commit point: stamp a fresh rv, freeze, install (or, for
        DELETED, leave out), emit."""
        self._rv += 1
        stored.metadata.resource_version = self._rv
        stored.freeze()
        if event != "DELETED":
            self._objects[stored.key] = stored
            if stored.kind == self.WEBHOOK_KIND:
                self._webhook_keys.add(stored.key)
        else:
            self._webhook_keys.discard(stored.key)
        self._emit(event, stored)
        return stored

    def _normalize_version(self, obj: Resource) -> Resource:
        """A write at any served version in storage form; an unserved
        version of a registered kind is a client error."""
        try:
            return versioning.registry.normalize(obj)
        except versioning.ConversionError as e:
            raise Invalid(str(e)) from e

    def convert_to(self, obj: Resource, version: str) -> Resource:
        """A stored (hub-version) object rendered at another served
        version."""
        try:
            return versioning.registry.convert(obj, version)
        except versioning.ConversionError as e:
            raise Invalid(str(e)) from e

    def create(self, obj: Resource, *, lease_guard=None) -> Resource:
        self._check_available()
        obj = self._normalize_version(obj)
        # Webhook callouts outside the lock (an HTTP round trip must not
        # stall writers), before the in-process hooks (mutating, then
        # validating: quota meters the mutated object).
        obj = self._webhook_admit(obj, "CREATE")
        with self._lock:
            self._check_available()
            self._check_lease_guard(lease_guard, obj.kind)
            if obj.key in self._objects:
                raise AlreadyExists(f"{obj.key} already exists")
            if obj.metadata.namespace in self._drained:
                raise NotFound(f"namespace {obj.metadata.namespace!r} is gone: "
                               f"{obj.kind} {obj.metadata.name} not created")
            if obj.kind == "Namespace":
                self._drained.discard(obj.metadata.name)
            stored = self._admit(obj).deepcopy()
            stored.metadata.uid = fresh_uid()
            stored.metadata.generation = 1
            stored.metadata.creation_timestamp = now()
            return self._commit(stored, "ADDED")

    def get(self, kind: str, name: str, namespace: str = "default") -> Resource:
        with self._lock:
            self._check_available()
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return obj  # frozen shared snapshot; .thaw() to mutate

    def kinds(self) -> list[str]:
        """The distinct kinds with live objects (quota's count/<resource>
        inverse: `resource_for_kind` is lossy for CamelCase kinds)."""
        with self._lock:
            self._check_available()
            return sorted({k[0] for k in self._objects})

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[Resource]:
        """Frozen shared snapshots, (namespace, name)-ordered."""
        with self._lock:
            self._check_available()
            return [
                obj for key, obj in sorted(self._objects.items())
                if key[0] == kind
                and (namespace is None or key[1] == namespace)
                and (not label_selector or _matches(obj.metadata.labels, label_selector))
            ]

    def _update(self, obj: Resource, *, status_only: bool, lease_guard=None) -> Resource:
        with self._lock:
            self._check_available()
            self._check_lease_guard(lease_guard, obj.kind)
            current = self._objects.get(obj.key)
            if current is None:
                raise NotFound(f"{obj.key} not found")
            rv = obj.metadata.resource_version
            if rv and rv != current.metadata.resource_version:
                raise Conflict(
                    f"{obj.key}: stale resourceVersion {rv} != "
                    f"{current.metadata.resource_version}"
                )
            stored = current.deepcopy()
            incoming = Resource.from_dict(obj.to_dict())
            if status_only:
                stored.status = incoming.status
            else:
                if incoming.spec != stored.spec:
                    stored.metadata.generation += 1
                stored.spec = incoming.spec
                stored.metadata.labels = incoming.metadata.labels
                stored.metadata.annotations = incoming.metadata.annotations
                stored.metadata.finalizers = incoming.metadata.finalizers
                stored.metadata.owner_references = incoming.metadata.owner_references
            if self._maybe_finalize(stored):
                return stored
            return self._commit(stored, "MODIFIED")

    def update(self, obj: Resource, *, lease_guard=None) -> Resource:
        # A fail-stopped store must not keep calling webhooks for writes
        # that cannot commit.
        self._check_available()
        obj = self._webhook_admit(self._normalize_version(obj), "UPDATE")
        with self._lock:  # in-process admission atomic with the write
            self._check_available()
            return self._update(self._admit(obj), status_only=False, lease_guard=lease_guard)

    def update_status(self, obj: Resource, *, lease_guard=None) -> Resource:
        return self._update(obj, status_only=True, lease_guard=lease_guard)

    def delete(
        self, kind: str, name: str, namespace: str = "default", *, lease_guard=None
    ) -> None:
        with self._lock:
            self._check_available()
            self._check_lease_guard(lease_guard, kind)
            key = (kind, namespace, name)
            obj = self._objects.get(key)
            if obj is None:
                raise NotFound(f"{key} not found")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    # Marking the deletion is a commit of its own.
                    stored = obj.thaw()
                    stored.metadata.deletion_timestamp = now()
                    self._commit(stored, "MODIFIED")
                return
            self._remove_locked(key)

    def _maybe_finalize(self, stored: Resource) -> bool:
        """Remove an object whose deletion was pending and whose last
        finalizer was just cleared, emitting its DELETED; True if it
        was removed. The DELETED is journaled before the cascade runs:
        the cascaded dependents get later rvs, so the journal stays
        rv-sorted, which the bisect in `events_since` relies on."""
        if stored.metadata.deletion_timestamp is None or stored.metadata.finalizers:
            return False
        self._commit(stored, "DELETED")
        self._remove_locked(stored.key, emit_delete=False)
        return True

    def _remove_locked(self, key: tuple[str, str, str], *, emit_delete: bool = True) -> None:
        obj = self._objects.pop(key)
        if emit_delete:
            # The DELETED event gets a fresh rv of its own, so a watcher
            # resuming from the object's last-seen version still sees it.
            self._commit(obj.thaw(), "DELETED")
        self._cascade(obj)
        if obj.kind == "Namespace":
            self._drain_namespace(obj.metadata.name)

    def _drain_namespace(self, namespace: str) -> None:
        """Deleting a Namespace deletes every object inside it, not only
        its owner-reference dependents, and closes it to creates."""
        self._drained.add(namespace)
        for kind, ns, name in [k for k in self._objects if k[1] == namespace]:
            try:
                self.delete(kind, name, ns)
            except NotFound:
                pass

    def _cascade(self, owner: Resource) -> None:
        """Delete the dependents whose ownerReference names `owner`."""
        uid = owner.metadata.uid
        for key in [
            o.key for o in list(self._objects.values())
            if any(ref.get("uid") == uid for ref in o.metadata.owner_references)
        ]:
            if key in self._objects:
                try:
                    self.delete(key[0], key[2], key[1])
                except NotFound:
                    pass

    # -- conveniences ------------------------------------------------------

    def apply(self, obj: Resource, *, lease_guard=None) -> Resource:
        """Create-or-update by (kind, namespace, name): a no-op when the
        desired fields, once admitted (webhooks and in-process hooks,
        which must be idempotent), already match the stored ones, so
        level-triggered reconcilers don't re-trigger their own watches
        and injected fields don't defeat the comparison. Each webhook is
        called once: the update reuses the comparison's mutation."""
        try:
            self.get(obj.kind, obj.metadata.name, obj.metadata.namespace)
        except NotFound:
            return self.create(obj, lease_guard=lease_guard)
        # Compared post-conversion: a spoke-version apply of the stored
        # object is a no-op.
        obj = self._webhook_admit(self._normalize_version(obj), "UPDATE")
        with self._lock:
            self._check_available()
            current = self._objects.get(obj.key)
            if current is not None:
                return self._apply_locked(current, obj, lease_guard)
        # Deleted since the first read: create it (outside the lock, for
        # the create's own callouts).
        return self.create(obj, lease_guard=lease_guard)

    def _apply_locked(self, current: Resource, obj: Resource, lease_guard) -> Resource:
        admitted = self._admit(obj)
        if (
            current.spec == admitted.spec
            and current.metadata.labels == admitted.metadata.labels
            and current.metadata.annotations == admitted.metadata.annotations
        ):
            return current
        merged = admitted.deepcopy()
        merged.metadata.resource_version = current.metadata.resource_version
        merged.metadata.uid = current.metadata.uid
        return self._update(self._admit(merged), status_only=False, lease_guard=lease_guard)

    def record_event(
        self, about: Resource, reason: str, message: str, *, type_: str = "Normal"
    ) -> Resource:
        """Emit a K8s-style Event object; a repeat of the same occurrence
        lands on the existing Event (see `event_name`)."""
        ev = event_resource(about, reason, message, type_=type_)
        try:
            return self.create(ev)
        except AlreadyExists:
            return self.get("Event", ev.metadata.name, about.metadata.namespace)
