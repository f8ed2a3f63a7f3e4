"""The native API server: FakeApiServer's API over the compiled store.

Counterpart of `kubeflow_tpu/native/apiserver.py` (a module with no JAX
in it): `NativeApiServer` keeps `testing/fake_apiserver.FakeApiServer`'s
API while its storage semantics (resourceVersion concurrency, spec and
status surfaces, finalizers, the owner-reference cascade, the namespace
drain, label selectors) live in the port's copy of ``store.cc``
(`native/core.NativeStore`).

Watch delivery is synchronous and ordered: every mutating call drains
the store's event journal and dispatches to subscribers before it
returns, so `flush()` is trivially satisfied. In-process admission hooks
run on the Python side, as in FakeApiServer. Writes carry
FakeApiServer's lease fencing (`check_lease_guard`, atomic under the
dispatch lock every mutation takes).

Reads are copy-on-write: a Python-side mirror of frozen Resources per
(kind, namespace, name), fed from the store's own journal, serves
get/list/kinds and every watch delivery one shared snapshot per commit,
with no ctypes round trip or JSON parse per read. The same journal feeds
the bounded resumable event journal (`current_rv`, `events_since`,
`wait_events`) that the HTTP facade's watch and long-poll serve, so the
store serves behind `testing/apiserver_http.ApiServerApp` as
FakeApiServer does. Delivered objects are frozen; `.thaw()` for a
private mutable copy.

Not served here, as in JAX's: WebhookConfiguration callouts (refused,
never stored, so a failurePolicy Fail cannot fail open), durability (no
WAL: `checkpoint` and `close` are no-ops) and the port store's refusal
of creates into a drained namespace.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from operator import itemgetter
from typing import Callable

from kubeflow_tpu_torch.api import versioning
from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.native import core
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    Conflict,
    Gone,
    Invalid,
    NotFound,
    WatchHandler,
    _matches,
    check_lease_guard,
    event_resource,
)

log = logging.getLogger(__name__)


class KindIndex:
    """kind -> namespace -> name -> frozen Resource, with empty buckets
    pruned; list is (namespace, name)-ordered. Not synchronized: the
    caller holds its lock."""

    def __init__(self):
        self._by_kind: dict[str, dict[str, dict[str, Resource]]] = {}

    def put(self, obj: Resource) -> None:
        self._by_kind.setdefault(obj.kind, {}).setdefault(
            obj.metadata.namespace, {})[obj.metadata.name] = obj

    def pop(self, kind: str, namespace: str, name: str) -> None:
        by_ns = self._by_kind.get(kind)
        if by_ns is None:
            return
        names = by_ns.get(namespace)
        if names is not None:
            names.pop(name, None)
            if not names:
                del by_ns[namespace]
        if not by_ns:
            del self._by_kind[kind]

    def get(self, kind: str, namespace: str, name: str) -> Resource | None:
        return self._by_kind.get(kind, {}).get(namespace, {}).get(name)

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Resource]:
        by_ns = self._by_kind.get(kind, {})
        spaces = ([namespace] if namespace in by_ns else []) if namespace is not None \
            else sorted(by_ns)
        return [obj for ns in spaces for name, obj in sorted(by_ns[ns].items())
                if not label_selector or _matches(obj.metadata.labels, label_selector)]

    def kinds(self) -> list[str]:
        return sorted(self._by_kind)


class NativeApiServer:
    def __init__(self, journal_size: int = 10_000):
        self._store = core.NativeStore()
        self._cursor = 0
        self._watchers: list[tuple[str | None, WatchHandler]] = []
        self._admission: list[tuple[str | None, Callable[[Resource], Resource]]] = []
        # Serializes mutate + dispatch so event order is deterministic
        # under concurrent controller threads (the C++ store is itself
        # thread-safe; this lock is about dispatch order and fencing).
        self._dispatch_lock = threading.RLock()
        # The bounded (resourceVersion, event, object) journal the facade
        # serves, fed from the C++ store's journal in _drain_events.
        self._journal: list[tuple[int, str, Resource]] = []
        self._journal_size = journal_size
        self._journal_cv = threading.Condition(self._dispatch_lock)
        self._rv = 0
        self._floor = 0
        self._mirror = KindIndex()
        self._mirror_lock = threading.Lock()

    # -- admission --------------------------------------------------------

    def register_admission(self, mutator: Callable[[Resource], Resource],
                           kind: str | None = None) -> None:
        with self._dispatch_lock:
            self._admission.append((kind, mutator))

    def _admit(self, obj: Resource) -> Resource:
        for kind, mutator in list(self._admission):
            if kind is None or kind == obj.kind:
                obj = mutator(obj.deepcopy())
        return obj

    # -- watch ------------------------------------------------------------

    def watch(self, handler: WatchHandler, kind: str | None = None) -> None:
        with self._dispatch_lock:
            self._watchers.append((kind, handler))

    def _drain_events(self) -> None:
        events, cursor = self._store.events(self._cursor)
        self._cursor = cursor
        self._store.trim(cursor)
        # Journal the whole batch before any handler runs: the C++ cursor
        # is already advanced and trimmed, so an event that missed the
        # journal here would be gone, and a raising handler must not cost
        # later events their only record.
        batch = []
        with self._journal_cv:
            for ev in events:
                obj = Resource.from_dict(ev["object"]).freeze()
                rv = obj.metadata.resource_version
                self._rv = max(self._rv, rv)
                self._journal.append((rv, ev["type"], obj))
                with self._mirror_lock:
                    if ev["type"] == "DELETED":
                        self._mirror.pop(*obj.key)
                    else:
                        self._mirror.put(obj)
                batch.append((ev["type"], obj))
            if len(self._journal) > self._journal_size:
                del self._journal[: -self._journal_size]
            self._journal_cv.notify_all()
        for etype, obj in batch:
            for kind, handler in list(self._watchers):
                if kind is None or kind == obj.kind:
                    try:
                        handler(etype, obj)
                    except Exception:
                        log.exception("watch handler failed for %s %s", etype, obj.key)

    @property
    def current_rv(self) -> int:
        with self._dispatch_lock:
            return self._rv

    def events_since(self, resource_version: int, kind: str | None = None,
                     namespace: str | None = None) -> tuple[list[tuple[int, str, Resource]], int]:
        """Journal entries with rv > resource_version, filtered, and the
        current rv; Gone when the bookmark predates the journal, as in
        FakeApiServer."""
        with self._dispatch_lock:
            if resource_version < self._floor:
                raise Gone(f"resourceVersion {resource_version} predates this server's "
                           f"history (floor {self._floor}): relist")
            journal = self._journal
            if journal and resource_version < journal[0][0] - 1:
                raise Gone(f"resourceVersion {resource_version} is too old "
                           f"(journal begins at {journal[0][0]})")
            start = bisect.bisect_right(journal, resource_version, key=itemgetter(0))
            return [(rv, event, obj) for rv, event, obj in journal[start:]
                    if (kind is None or obj.kind == kind)
                    and (namespace is None or obj.metadata.namespace == namespace)], self._rv

    def wait_events(self, resource_version: int, kind: str | None = None,
                    namespace: str | None = None,
                    timeout: float = 10.0) -> tuple[list[tuple[int, str, Resource]], int]:
        """Long-poll form of events_since."""
        deadline = time.monotonic() + timeout
        with self._journal_cv:
            while True:
                events, rv = self.events_since(resource_version, kind, namespace)
                remaining = deadline - time.monotonic()
                if events or remaining <= 0:
                    return events, rv
                self._journal_cv.wait(remaining)

    def _translate(self, err: core.StoreError) -> Exception:
        msg = str(err)
        if err.code == core.STORE_NOT_FOUND:
            return NotFound(msg)
        if err.code == core.STORE_ALREADY_EXISTS:
            return AlreadyExists(msg)
        if err.code == core.STORE_CONFLICT:
            return Conflict(msg)
        return err

    # -- CRUD -------------------------------------------------------------

    def _check_lease_guard(self, guard, kind: str) -> None:
        """The caller holds _dispatch_lock, which every mutation through
        this server takes (Lease renewals too): check and commit are
        atomic."""

        def lookup(ns: str, name: str):
            try:
                return Resource.from_dict(self._store.get("Lease", ns, name)).spec
            except core.StoreError:
                return None

        check_lease_guard(lookup, guard, kind)

    def _reject_webhook_config(self, obj: Resource) -> None:
        if obj.kind == "WebhookConfiguration":
            raise Invalid("WebhookConfiguration callouts are not supported on the native "
                          "store backend: serve FakeApiServer for out-of-process admission")

    def _committed(self, stored: dict) -> Resource:
        """The frozen snapshot of a just-committed write: the mirror's
        entry at this rv (the caller holds _dispatch_lock through mutate
        and drain), else the ABI's JSON (a finalizing update, gone again)."""
        meta = stored["metadata"]
        with self._mirror_lock:
            obj = self._mirror.get(stored["kind"], meta.get("namespace", "default"),
                                   meta["name"])
        if obj is not None and obj.metadata.resource_version == meta.get("resourceVersion"):
            return obj
        return Resource.from_dict(stored).freeze()

    def create(self, obj: Resource, *, lease_guard=None) -> Resource:
        self._reject_webhook_config(obj)
        obj = self._admit(obj)
        with self._dispatch_lock:
            self._check_lease_guard(lease_guard, obj.kind)
            try:
                stored = self._store.create(obj.to_dict())
            except core.StoreError as e:
                raise self._translate(e) from None
            self._drain_events()
            return self._committed(stored)

    def get(self, kind: str, name: str, namespace: str = "default") -> Resource:
        with self._mirror_lock:
            obj = self._mirror.get(kind, namespace, name)
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        return obj  # frozen shared snapshot; .thaw() to mutate

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Resource]:
        with self._mirror_lock:
            return self._mirror.list(kind, namespace, label_selector)

    def update(self, obj: Resource, *, lease_guard=None) -> Resource:
        self._reject_webhook_config(obj)
        return self._update(self._admit(obj), status_only=False, lease_guard=lease_guard)

    def update_status(self, obj: Resource, *, lease_guard=None) -> Resource:
        return self._update(obj, status_only=True, lease_guard=lease_guard)

    def _update(self, obj: Resource, *, status_only: bool, lease_guard=None) -> Resource:
        with self._dispatch_lock:
            self._check_lease_guard(lease_guard, obj.kind)
            try:
                stored = self._store.update(obj.to_dict(), status_only=status_only)
            except core.StoreError as e:
                raise self._translate(e) from None
            self._drain_events()
            return self._committed(stored)

    def delete(self, kind: str, name: str, namespace: str = "default", *,
               lease_guard=None) -> None:
        with self._dispatch_lock:
            self._check_lease_guard(lease_guard, kind)
            try:
                self._store.delete(kind, namespace, name)
            except core.StoreError as e:
                raise self._translate(e) from None
            self._drain_events()

    # -- conveniences (FakeApiServer's contracts) -------------------------

    def apply(self, obj: Resource, *, lease_guard=None) -> Resource:
        try:
            current = self.get(obj.kind, obj.metadata.name, obj.metadata.namespace)
        except NotFound:
            return self.create(obj, lease_guard=lease_guard)
        obj = self._admit(obj)
        if (current.spec == obj.spec and current.metadata.labels == obj.metadata.labels
                and current.metadata.annotations == obj.metadata.annotations):
            return current
        merged = obj.deepcopy()
        merged.metadata.resource_version = current.metadata.resource_version
        merged.metadata.uid = current.metadata.uid
        return self.update(merged, lease_guard=lease_guard)

    def record_event(self, about: Resource, reason: str, message: str, *,
                     type_: str = "Normal") -> Resource:
        ev = event_resource(about, reason, message, type_=type_)
        try:
            return self.create(ev)
        except AlreadyExists:
            return self.get("Event", ev.metadata.name, about.metadata.namespace)

    def convert_to(self, obj: Resource, version: str) -> Resource:
        try:
            return versioning.registry.convert(obj, version)
        except versioning.ConversionError as e:
            raise Invalid(str(e)) from e

    def kinds(self) -> list[str]:
        with self._mirror_lock:
            return self._mirror.kinds()

    def flush(self, timeout: float = 30.0) -> None:
        """Dispatch barrier: delivery is synchronous with each mutating
        call, so nothing is ever pending."""

    def checkpoint(self) -> None:
        """No durable tier on this backend."""

    def close(self) -> None:
        """No durable tier and no dispatcher thread on this backend."""
