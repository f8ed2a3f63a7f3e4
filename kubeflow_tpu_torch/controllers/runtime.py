"""Reconcile runtime: work queue, level-triggered controllers, manager.

A copy of `kubeflow_tpu/controllers/runtime.py` (a module with no JAX in
it). Watches enqueue object keys, a worker dedupes and reconciles,
errors requeue with backoff, `requeue_after` drives periodic work.
Reconcilers are functions of observed state only: they read the API
server fresh each pass, so a reconcile is idempotent and crash-safe.

The work queue is the compiled one (`make_workqueue`: the port's copy
of ``workqueue.cc``, `native/core.WorkQueue`), as the JAX package's is.
If it cannot be built or loaded, `make_workqueue` raises: the JAX
package falls back to its Python queue with a warning, the port does
not. `PyWorkQueue`, the Python twin with the same semantics, is reached
only by name (``Controller(workqueue=PyWorkQueue(...))``); it alone
takes a `clock`, for scripted tests. Each reconcile is a tracing span
(`utils/tracing.py`: "reconcile", its controller and key; an exception
sets the span's error), and the client calls inside it carry its trace
id.

Objects delivered by watches and returned by get/list are shared frozen
snapshots: take a private copy with `.thaw()` before mutating (the
read-modify-write is `fresh = api.get(...).thaw()`).
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import random
import threading
import time
from typing import Callable, Iterable

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.native.core import WorkQueue, backend_of
from kubeflow_tpu_torch.testing.fake_apiserver import Conflict
from kubeflow_tpu_torch.utils import tracing
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

Key = tuple[str, str]  # (namespace, name)


@dataclasses.dataclass(frozen=True)
class Result:
    requeue_after: float | None = None


def retry_on_conflict(
    fn: Callable[[], object],
    *,
    attempts: int = 4,
    base_delay: float = 0.01,
):
    """client-go's RetryOnConflict for read-modify-write status updates:
    `fn` must RE-READ the object each call (a conflict means the cached
    copy is stale — replaying the same body would just conflict again).
    Retries only `Conflict`, with short jittered backoff; the final
    conflict propagates so the workqueue's error backoff takes over.
    Under fault injection this keeps routine rv races from burning
    whole reconcile passes."""
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except Conflict:
            if attempt == attempts - 1:
                raise
            time.sleep(random.uniform(0, delay))
            delay = min(delay * 2, 0.25)


class PyWorkQueue:
    """The compiled work queue's Python twin (JAX's `_PyWorkQueue`), with
    its interface and semantics: keyed dedup, sooner-wins supersede, an
    in-flight dirty set, per-key exponential error backoff. `clock`
    (default `time.monotonic`) says when a delayed item comes due: a
    scripted test passes its own, so a `requeue_after` fires when the
    script moves time and never because a pass ran slowly."""

    tier = "python"

    def __init__(self, base_backoff: float = 0.02, max_backoff: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._heap: list[tuple[float, int, str]] = []
        self._queued: dict[str, float] = {}
        self._inflight: set[str] = set()
        self._dirty: set[str] = set()
        self._failures: dict[str, int] = {}
        self._cv = threading.Condition()
        self._seq = 0
        self._base = base_backoff
        self._max = max_backoff
        self._down = False

    def add(self, key: str, *, after: float = 0.0) -> None:
        ready = self._clock() + max(0.0, after)
        with self._cv:
            if self._down:
                return
            if key in self._inflight:
                self._dirty.add(key)
                return
            current = self._queued.get(key)
            if current is not None and current <= ready:
                return
            self._queued[key] = ready
            self._seq += 1
            heapq.heappush(self._heap, (ready, self._seq, key))
            self._cv.notify_all()

    def _prune(self) -> None:
        while self._heap:
            ready, _, key = self._heap[0]
            if self._queued.get(key) == ready:
                return
            heapq.heappop(self._heap)

    def get(self, timeout: float = 0.0) -> str | None:
        deadline = self._clock() + timeout
        with self._cv:
            while True:
                if self._down:
                    return None
                self._prune()
                now = self._clock()
                if self._heap:
                    ready, _, key = self._heap[0]
                    if ready <= now:
                        heapq.heappop(self._heap)
                        del self._queued[key]
                        self._inflight.add(key)
                        return key
                    until = min(ready, deadline)
                    if until <= now:
                        return None
                    self._cv.wait(until - now)
                else:
                    if timeout == 0 or now >= deadline:
                        return None
                    self._cv.wait(deadline - now)

    def done(self, key: str) -> None:
        with self._cv:
            self._inflight.discard(key)
            if key in self._dirty:
                self._dirty.discard(key)
                if not self._down:
                    ready = self._clock()
                    current = self._queued.get(key)
                    if current is None or current > ready:
                        self._queued[key] = ready
                        self._seq += 1
                        heapq.heappush(self._heap, (ready, self._seq, key))
                        self._cv.notify_all()

    def requeue_error(self, key: str) -> float:
        with self._cv:
            n = self._failures[key] = self._failures.get(key, 0) + 1
            backoff = min(self._max, self._base * 2 ** (n - 1))
            if not self._down:
                ready = self._clock() + backoff
                current = self._queued.get(key)
                if current is None or current > ready:
                    self._queued[key] = ready
                    self._seq += 1
                    heapq.heappush(self._heap, (ready, self._seq, key))
                    self._cv.notify_all()
                self._dirty.discard(key)
            return backoff

    def forget(self, key: str) -> None:
        with self._cv:
            self._failures.pop(key, None)

    def __len__(self) -> int:
        with self._cv:
            return len(self._queued)

    def next_ready_in(self) -> float | None:
        with self._cv:
            self._prune()
            if not self._heap:
                return None
            return max(0.0, self._heap[0][0] - self._clock())

    def shutdown(self) -> None:
        with self._cv:
            self._down = True
            self._cv.notify_all()


def make_workqueue(base_backoff: float = 0.02, max_backoff: float = 30.0):
    """The compiled work queue; raises if it cannot be built or loaded."""
    return WorkQueue(base_backoff=base_backoff, max_backoff=max_backoff)


def plane_report(built) -> dict:
    """The compiled tier of one manager's controller objects `built`
    (each with a ``.controller``): each controller's work-queue backend,
    and gang placements by scheduler backend summed over the TpuJob
    operators among them (their ``tpujob_gang_placements_total``)."""
    placements = {"native": 0, "python": 0, "custom": 0}
    for ctl in built:
        counter = getattr(ctl, "gang_placements", None)
        if counter is not None:
            for backend in placements:
                placements[backend] += int(counter.value(backend=backend))
    return {"workqueue": {ctl.controller.name: backend_of(ctl.controller._queue)
                          for ctl in built},
            "tpujob_gang_placements_total": placements}


def _encode(key: Key) -> str:
    return f"{key[0]}/{key[1]}"


def _decode(key: str) -> Key:
    ns, _, name = key.partition("/")
    return (ns, name)


class Controller:
    """One reconciler bound to a primary kind and its owned kinds."""

    def __init__(
        self,
        api,
        kind: str,
        reconcile: Callable[[object, Key], Result | None],
        *,
        owns: Iterable[str] = (),
        name: str | None = None,
        metrics: MetricsRegistry | None = None,
        max_backoff: float = 30.0,
        workqueue=None,
    ):
        self.api = api
        self.kind = kind
        self.name = name or f"{kind.lower()}-controller"
        self._reconcile = reconcile
        self._owns = tuple(owns)
        # `is None`, not `or`: an empty queue is falsy (it has __len__),
        # and JAX's `workqueue or ...` drops a caller's empty queue.
        self._queue = workqueue if workqueue is not None else make_workqueue(
            max_backoff=max_backoff)
        metrics = metrics or MetricsRegistry()
        self.reconcile_total = metrics.counter(
            "reconcile_total", "reconcile passes", ("controller", "outcome")
        )
        api.watch(self._on_primary, kind)
        for owned in self._owns:
            api.watch(self._on_owned, owned)
        # Initial sync (an informer's list-then-watch): primaries that
        # already exist get a reconcile; FakeApiServer's in-process watch
        # has no replay. Best-effort for remote clients, whose watch
        # stream does its own list-then-watch resync.
        try:
            for obj in api.list(kind):
                self._on_primary("MODIFIED", obj)
        except Exception:
            log.debug("%s: initial list failed; relying on watch resync",
                      self.name, exc_info=True)

    # -- watch handlers ---------------------------------------------------

    def _on_primary(self, event: str, obj: Resource) -> None:
        self.enqueue((obj.metadata.namespace, obj.metadata.name))

    def _on_owned(self, event: str, obj: Resource) -> None:
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == self.kind and ref.get("controller"):
                self.enqueue((obj.metadata.namespace, ref["name"]))

    def enqueue(self, key: Key, *, after: float = 0.0) -> None:
        """Enqueue; a sooner request supersedes a later pending one (a fresh
        watch event must not wait out an old error backoff)."""
        self._queue.add(_encode(key), after=after)

    # -- processing -------------------------------------------------------

    def process_one(self, timeout: float = 0.0) -> bool:
        """Reconcile one ready key; False if nothing is ready."""
        key_s = self._queue.get(timeout)
        if key_s is None:
            return False
        key = _decode(key_s)
        try:
            with tracing.tracer.span("reconcile", controller=self.name, key="/".join(key)):
                result = self._reconcile(self.api, key) or Result()
        except Exception:
            backoff = self._queue.requeue_error(key_s)
            log.exception(
                "%s: reconcile %s failed, requeue in %.2fs",
                self.name, key, backoff,
            )
            self.reconcile_total.inc(controller=self.name, outcome="error")
            self._queue.done(key_s)
            return True
        self._queue.forget(key_s)
        self.reconcile_total.inc(controller=self.name, outcome="success")
        # done() before the delayed re-add: a dirty in-flight re-add must
        # not swallow the requeue_after delay.
        self._queue.done(key_s)
        if result.requeue_after is not None:
            self._queue.add(key_s, after=result.requeue_after)
        return True

    def _flush_events(self) -> None:
        """Barrier on the store's async event dispatch (no-op for remote
        clients, whose delivery is inherently asynchronous)."""
        flush = getattr(self.api, "flush", None)
        if flush is not None:
            flush()

    def run_until_idle(self, *, max_passes: int = 1000) -> int:
        """Drain everything currently ready (how tests reconcile deterministically).
        Timed requeues that are not yet due are left pending. Each pass
        first drains the store's dispatcher so watch events caused by the
        previous reconcile's writes have landed in the workqueue."""
        done = 0
        for _ in range(max_passes):
            self._flush_events()
            if not self.process_one():
                return done
            done += 1
        raise RuntimeError(
            f"{self.name}: not idle after {max_passes} passes — "
            "likely a reconcile hot-loop (every pass re-enqueues)"
        )

    def has_pending(self) -> bool:
        return len(self._queue) > 0

    # -- threaded mode ----------------------------------------------------

    def run(self, stop: threading.Event, poll: float = 0.05) -> None:
        while not stop.is_set():
            try:
                self.process_one(timeout=poll)
            except Exception:
                # process_one already contains the reconcile; anything
                # escaping it is queue/runtime trouble. A controller
                # thread must survive it — under fault injection a dead
                # worker looks exactly like a converged one until the
                # soak's deadline expires.
                log.exception("%s: worker loop error; continuing", self.name)
                stop.wait(poll)


class ControllerManager:
    """Runs a set of controllers (threaded) — the manager binary analog."""

    def __init__(self):
        self.controllers: list[Controller] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def add(self, controller: Controller) -> None:
        self.controllers.append(controller)

    def start(self) -> None:
        for c in self.controllers:
            t = threading.Thread(
                target=c.run, args=(self._stop,), name=c.name, daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def run_until_idle(self) -> None:
        """Deterministic drain across all controllers (watch events from one
        controller's writes wake the others)."""
        for _ in range(1000):
            for c in self.controllers:
                c._flush_events()
            if not any(c.process_one() for c in self.controllers):
                return
        raise RuntimeError("controllers did not settle")
