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
- owner references: deleting an object deletes its dependents
- `apply` (create-or-update, a no-op when nothing changed) and
  `record_event`

Storage is copy-on-write: each commit deep-copies the incoming object
once, freezes it and shares that snapshot with the object map, the
journal, every watch handler and get/list results. `.thaw()` gives a
private mutable copy.

Not copied (no ported caller needs them): persistence (WAL and
snapshots), mutating admission hooks and admission webhooks, lease-guard
write fencing, multi-version conversion, finalizers and the Namespace
drain. A deleted object is removed at once.
"""

from __future__ import annotations

import bisect
import hashlib
import logging
import threading
import time
from operator import itemgetter
from typing import Callable

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


class Gone(ApiError):
    """The requested resourceVersion predates the journal's oldest entry
    (HTTP 410 on an expired watch bookmark). Clients recover the way
    informers do: re-list, then watch from the list's resourceVersion."""


class Unavailable(ApiError):
    """The store refused the operation (HTTP 503)."""


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


class FakeApiServer:
    def __init__(self, *, journal_size: int = 10_000):
        self._objects: dict[tuple[str, str, str], Resource] = {}
        self._rv = 0
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
        """End watch delivery: drop every handler and stop the dispatcher
        thread. The thread otherwise lives as long as the process and
        keeps every handler alive, with what it holds (a controller, its
        runtime, the fleet). Reads, writes and the journal go on
        working; a later `watch` raises. The JAX store's `close` only
        checkpoints its WAL, so its dispatcher never ends."""
        with self._lock:
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

    def _emit(self, event: str, obj: Resource) -> None:
        """Journal and queue one committed snapshot (caller holds the
        lock, so journal order is rv order)."""
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

    # -- CRUD -------------------------------------------------------------

    def _commit(self, stored: Resource, event: str) -> Resource:
        """THE commit point: stamp a fresh rv, freeze, install (or, for
        DELETED, leave out), emit."""
        self._rv += 1
        stored.metadata.resource_version = self._rv
        stored.freeze()
        if event != "DELETED":
            self._objects[stored.key] = stored
        self._emit(event, stored)
        return stored

    def create(self, obj: Resource) -> Resource:
        with self._lock:
            if obj.key in self._objects:
                raise AlreadyExists(f"{obj.key} already exists")
            stored = obj.deepcopy()
            stored.metadata.uid = fresh_uid()
            stored.metadata.generation = 1
            stored.metadata.creation_timestamp = now()
            return self._commit(stored, "ADDED")

    def get(self, kind: str, name: str, namespace: str = "default") -> Resource:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return obj  # frozen shared snapshot; .thaw() to mutate

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[Resource]:
        """Frozen shared snapshots, (namespace, name)-ordered."""
        with self._lock:
            return [
                obj for key, obj in sorted(self._objects.items())
                if key[0] == kind
                and (namespace is None or key[1] == namespace)
                and (not label_selector or _matches(obj.metadata.labels, label_selector))
            ]

    def _update(self, obj: Resource, *, status_only: bool) -> Resource:
        with self._lock:
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
                stored.metadata.owner_references = incoming.metadata.owner_references
            return self._commit(stored, "MODIFIED")

    def update(self, obj: Resource) -> Resource:
        return self._update(obj, status_only=False)

    def update_status(self, obj: Resource) -> Resource:
        return self._update(obj, status_only=True)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is None:
                raise NotFound(f"{(kind, namespace, name)} not found")
            # The DELETED event gets a fresh rv of its own, so a watcher
            # resuming from the object's last-seen version still sees it.
            self._commit(obj.thaw(), "DELETED")
            uid = obj.metadata.uid
            for key in [
                k for k, o in self._objects.items()
                if any(ref.get("uid") == uid for ref in o.metadata.owner_references)
            ]:
                if key in self._objects:
                    self.delete(key[0], key[2], key[1])

    # -- conveniences ------------------------------------------------------

    def apply(self, obj: Resource) -> Resource:
        """Create-or-update by (kind, namespace, name): a no-op when the
        desired fields already match, so level-triggered reconcilers
        don't re-trigger their own watches."""
        with self._lock:
            try:
                current = self.get(obj.kind, obj.metadata.name, obj.metadata.namespace)
            except NotFound:
                return self.create(obj)
            if (
                current.spec == obj.spec
                and current.metadata.labels == obj.metadata.labels
                and current.metadata.annotations == obj.metadata.annotations
            ):
                return current
            merged = obj.deepcopy()
            merged.metadata.resource_version = current.metadata.resource_version
            merged.metadata.uid = current.metadata.uid
            return self.update(merged)

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
