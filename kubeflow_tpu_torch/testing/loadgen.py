"""Multi-process open-loop load harness.

The port's copy of `kubeflow_tpu/testing/loadgen.py` (a module with no
JAX in it), speaking the port's `serving/wire.py`. Closed-loop clients
(fire, wait, fire) slow down with the fleet, so offered load sags
exactly when the system is most interesting and coordinated omission
hides the latency a user would have seen. Here arrivals follow a fixed
schedule computed up front (Poisson or uniform inter-arrival at a fixed
offered rate), and a request fires at its scheduled instant whether or
not earlier ones came back.

One Python process cannot tick a fast arrival schedule while also
parsing the responses, so the harness shards the schedule across
WORKER PROCESSES (spawn context: no inherited locks or CUDA state),
each running its own event-driven dispatcher plus a thread pool that
absorbs in-flight requests, with per-request records streamed back to
the parent over a pipe and merged into one report.

Determinism: the arrival schedule and the per-arrival traffic-class
assignment derive from an explicit seed, so two runs with the same seed
offer identical load.

Honesty: the report carries ``offered_rate_error``, how far the
*achieved* arrival rate drifted from the requested one (scheduler
jitter, pool saturation). A harness that cannot hold its offered rate
is measuring itself, not the fleet.

Stdlib-only at module level: worker processes re-import this module
under the spawn context, and a no-op target must not pay a torch
import. An HTTP target imports the wire codec (numpy; the serving
package loads torch only with its servables) inside the worker, in
`_build_target`, before the worker reports ready, so the cost lands
before the shared start instant.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# Outcome codes on the wire between worker and parent (tuples pickle
# cheaper than dicts at 10k+ records).
OK, SHED, ERROR = 0, 1, 2
_OUTCOMES = ("ok", "shed", "error")

# Priority/tenant ride the front door's headers (serving/server.py).
PRIORITY_HEADER = "X-KFTPU-Priority"
TENANT_HEADER = "X-KFTPU-Tenant"


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One stream in the offered mix: which model it hits, at what
    priority, on whose quota, and its share of arrivals."""

    model: str
    priority: str = "standard"
    tenant: str = ""
    weight: float = 1.0


@dataclasses.dataclass
class ClassReport:
    model: str
    priority: str
    tenant: str
    count: int = 0
    ok: int = 0
    shed: int = 0
    error: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0


@dataclasses.dataclass
class LoadReport:
    """Merged result of one open-loop run."""

    offered_rate: float
    achieved_rate: float
    offered_rate_error: float
    fired: int
    ok: int
    shed: int
    error: int
    duration_s: float
    fire_lag_p99_ms: float
    # Aggregate latency over OK requests across every class.
    p50_ms: float
    p99_ms: float
    classes: list[ClassReport]

    def by_model(self) -> dict[str, ClassReport]:
        """Collapse classes onto models (a model may appear in several
        priority streams); percentiles are the worst stream's."""
        out: dict[str, ClassReport] = {}
        for c in self.classes:
            slot = out.setdefault(
                c.model, ClassReport(c.model, c.priority, c.tenant)
            )
            slot.count += c.count
            slot.ok += c.ok
            slot.shed += c.shed
            slot.error += c.error
            slot.p50_ms = max(slot.p50_ms, c.p50_ms)
            slot.p99_ms = max(slot.p99_ms, c.p99_ms)
        return out


def arrival_schedule(
    rate: float, count: int, *, seed: int, process: str = "poisson"
) -> list[float]:
    """Offsets (seconds from start) of `count` arrivals at offered
    `rate`. "poisson" draws exponential inter-arrival gaps (the
    open-system model); "uniform" ticks a metronome (for fidelity
    measurement, where schedule variance would mask harness jitter)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if process not in ("poisson", "uniform"):
        raise ValueError(f"unknown arrival process {process!r}")
    if process == "uniform":
        return [i / rate for i in range(count)]
    rng = random.Random(seed)
    t = 0.0
    out = []
    for _ in range(count):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def assign_classes(
    classes: list[TrafficClass], count: int, *, seed: int
) -> list[int]:
    """Per-arrival class index, weighted + seeded (deterministic mix)."""
    if not classes:
        raise ValueError("need at least one TrafficClass")
    rng = random.Random(seed ^ 0x5EED)
    weights = [c.weight for c in classes]
    return rng.choices(range(len(classes)), weights=weights, k=count)


# -- targets --------------------------------------------------------------
#
# A target spec is a plain picklable dict; the worker process builds the
# actual request callable from it. Two modes:
#   {"mode": "noop", "work_us": 0}          — fidelity runs: measure the
#       harness itself (can it hold the offered rate?), no I/O.
#   {"mode": "http", "addr": "host:port", "shape": [...], "timeout_s": N}
#       — drive a live front door / model server with binary tensor
#       frames; 429 → shed, other non-200 / socket error → error.


def _build_target(spec: dict, classes: list[TrafficClass]):
    """Returns fn(cls_idx) -> outcome code. Called inside the worker."""
    mode = spec.get("mode", "noop")
    if mode == "noop":
        work_us = float(spec.get("work_us", 0))

        def noop(_cls_idx: int) -> int:
            if work_us:
                # Busy-spin, not sleep: models CPU-bound client work
                # without handing the GIL a scheduling excuse.
                end = time.perf_counter() + work_us / 1e6
                while time.perf_counter() < end:
                    pass
            return OK

        return noop
    if mode != "http":
        raise ValueError(f"unknown target mode {mode!r}")

    import http.client

    import numpy as np

    from kubeflow_tpu_torch.serving import wire

    host, _, port = spec["addr"].partition(":")
    timeout_s = float(spec.get("timeout_s", 30.0))
    shape = tuple(spec.get("shape", (1, 32, 32, 3)))
    payload = wire.encode_tensor(
        np.zeros(shape, dtype=spec.get("dtype", "float32"))
    )
    paths = [f"/v1/models/{c.model}:predict" for c in classes]
    headers = [
        {
            "Content-Type": wire.TENSOR_CONTENT_TYPE,
            "Accept": wire.TENSOR_CONTENT_TYPE,
            PRIORITY_HEADER: c.priority,
            **({TENANT_HEADER: c.tenant} if c.tenant else {}),
        }
        for c in classes
    ]
    # One keep-alive connection per pool thread (thread-local), so the
    # server sees a realistic pooled client population rather than a
    # dial per request.
    local = threading.local()

    def send(cls_idx: int) -> int:
        conn = getattr(local, "conn", None)
        for attempt in (0, 1):
            if conn is None:
                conn = http.client.HTTPConnection(
                    host, int(port), timeout=timeout_s
                )
                local.conn = conn
            try:
                conn.request(
                    "POST", paths[cls_idx], body=payload,
                    headers=headers[cls_idx],
                )
                resp = conn.getresponse()
                resp.read()
                if resp.status == 200:
                    return OK
                if resp.status == 429:
                    return SHED
                return ERROR
            except OSError:
                # Stale keep-alive socket: redial once, then call it a
                # real error.
                conn.close()
                local.conn = conn = None
        return ERROR

    return send


# -- worker ---------------------------------------------------------------

_CHUNK = 2000  # records per pipe message — bounds pickling spikes


def _worker_main(conn, wspec: dict) -> None:
    """One load worker: handshake ready, wait for the shared start
    instant, then fire its schedule slice open-loop. Runs under the
    spawn context — everything arrives through `wspec` (picklable)."""
    classes = [TrafficClass(*c) for c in wspec["classes"]]
    arrivals = wspec["arrivals"]  # [(offset_s, cls_idx), ...] sorted
    target = _build_target(wspec["target"], classes)
    records: list[tuple] = []
    rlock = threading.Lock()

    def fire(offset: float, cls_idx: int, t0: float) -> None:
        start = time.monotonic()
        lag = start - (t0 + offset)
        outcome = target(cls_idx)
        latency = time.monotonic() - start
        with rlock:
            records.append((cls_idx, offset, lag, latency, outcome))

    pool = ThreadPoolExecutor(max_workers=int(wspec["concurrency"]))
    try:
        conn.send(("ready", None))
        msg, t0 = conn.recv()  # ("start", shared monotonic instant)
        if msg != "start":
            return
        for offset, cls_idx in arrivals:
            # Event-driven dispatch: sleep to the scheduled instant,
            # then hand off to the pool WITHOUT waiting for earlier
            # requests — the open-loop property. CLOCK_MONOTONIC is
            # system-wide on Linux, so t0 crosses the process boundary.
            delay = (t0 + offset) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            pool.submit(fire, offset, cls_idx, t0)
        pool.shutdown(wait=True)
        for i in range(0, len(records), _CHUNK):
            conn.send(("records", records[i:i + _CHUNK]))
        conn.send(("done", len(records)))
    finally:
        conn.close()


# -- parent ---------------------------------------------------------------


def _percentile(ordered: list[float], q: float) -> float:
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def _merge(
    records: list[tuple],
    classes: list[TrafficClass],
    rate: float,
) -> LoadReport:
    per_class: list[list[tuple]] = [[] for _ in classes]
    for rec in records:
        per_class[rec[0]].append(rec)
    reports = []
    for c, recs in zip(classes, per_class):
        lats = sorted(r[3] for r in recs if r[4] == OK)
        reports.append(
            ClassReport(
                model=c.model,
                priority=c.priority,
                tenant=c.tenant,
                count=len(recs),
                ok=sum(1 for r in recs if r[4] == OK),
                shed=sum(1 for r in recs if r[4] == SHED),
                error=sum(1 for r in recs if r[4] == ERROR),
                p50_ms=round(_percentile(lats, 0.50) * 1000, 3),
                p99_ms=round(_percentile(lats, 0.99) * 1000, 3),
            )
        )
    fires = sorted(r[1] + r[2] for r in records)  # offset + lag
    span = (fires[-1] - fires[0] + 1.0 / rate) if records else 0.0
    achieved = len(records) / span if span > 0 else 0.0
    lags = sorted(max(0.0, r[2]) for r in records)
    all_ok = sorted(r[3] for r in records if r[4] == OK)
    return LoadReport(
        offered_rate=rate,
        achieved_rate=round(achieved, 3),
        offered_rate_error=(
            round(abs(achieved - rate) / rate, 5) if rate else 0.0
        ),
        fired=len(records),
        ok=sum(r.ok for r in reports),
        shed=sum(r.shed for r in reports),
        error=sum(r.error for r in reports),
        duration_s=round(span, 3),
        fire_lag_p99_ms=round(_percentile(lags, 0.99) * 1000, 3),
        p50_ms=round(_percentile(all_ok, 0.50) * 1000, 3),
        p99_ms=round(_percentile(all_ok, 0.99) * 1000, 3),
        classes=reports,
    )


def run_open_loop(
    target: dict,
    classes: list[TrafficClass],
    *,
    rate: float,
    total: int,
    seed: int = 0,
    workers: int = 4,
    concurrency: int = 64,
    process: str = "poisson",
    start_delay_s: float = 0.5,
    timeout_s: float = 600.0,
) -> LoadReport:
    """Fire `total` arrivals at offered `rate` across `workers` spawned
    processes, merged into one LoadReport.

    The parent computes the full schedule and deals arrival i to worker
    i % workers — every worker holds a rate/workers thinning of the
    same point process, so the union reproduces the offered process
    exactly and a straggling worker shows up as fire lag, not as a
    silently reshaped schedule."""
    if total < 1:
        raise ValueError(f"total must be >= 1, got {total}")
    workers = max(1, min(workers, total))
    offsets = arrival_schedule(rate, total, seed=seed, process=process)
    cls_idx = assign_classes(classes, total, seed=seed)
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    cls_tuples = [
        (c.model, c.priority, c.tenant, c.weight) for c in classes
    ]
    for w in range(workers):
        parent_conn, child_conn = ctx.Pipe()
        wspec = {
            "classes": cls_tuples,
            "arrivals": list(
                zip(offsets[w::workers], cls_idx[w::workers])
            ),
            "target": target,
            "concurrency": concurrency,
        }
        p = ctx.Process(
            target=_worker_main, args=(child_conn, wspec), daemon=True
        )
        p.start()
        child_conn.close()
        procs.append(p)
        conns.append(parent_conn)

    deadline = time.monotonic() + timeout_s
    records: list[tuple] = []
    try:
        for conn in conns:
            if not conn.poll(max(0.1, deadline - time.monotonic())):
                raise TimeoutError("loadgen worker never became ready")
            msg, _ = conn.recv()
            if msg != "ready":
                raise RuntimeError(f"unexpected worker message {msg!r}")
        # All workers armed: release them against one shared instant far
        # enough out that the start messages land first.
        t0 = time.monotonic() + start_delay_s
        for conn in conns:
            conn.send(("start", t0))
        pending = set(range(len(conns)))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"loadgen workers {sorted(pending)} still running "
                    f"after {timeout_s}s"
                )
            for i in list(pending):
                while i in pending and conns[i].poll(0.05):
                    # A worker that died mid-run closes its pipe: poll
                    # reports EOF as readable and recv raises — surface
                    # that as a harness failure, not a hang.
                    try:
                        msg, payload = conns[i].recv()
                    except EOFError:
                        raise RuntimeError(
                            f"loadgen worker {i} exited before "
                            f"finishing its schedule"
                        ) from None
                    if msg == "records":
                        records.extend(payload)
                    elif msg == "done":
                        pending.discard(i)
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        for conn in conns:
            conn.close()
    return _merge(records, classes, rate)


def run_open_loop_threaded(
    target,
    classes: list[TrafficClass],
    *,
    rate: float,
    total: int,
    seed: int = 0,
    concurrency: int = 64,
    process: str = "poisson",
) -> LoadReport:
    """In-process variant: same schedule/merge machinery, one dispatcher
    thread, `target` is a direct callable ``fn(TrafficClass) -> "ok" |
    "shed" | "error"``. For tests and for driving an in-process Router
    without the HTTP boundary; the multi-process version is the one
    that scales past the GIL."""
    offsets = arrival_schedule(rate, total, seed=seed, process=process)
    cls_idx = assign_classes(classes, total, seed=seed)
    records: list[tuple] = []
    rlock = threading.Lock()
    code = {name: i for i, name in enumerate(_OUTCOMES)}

    def fire(offset: float, ci: int, t0: float) -> None:
        start = time.monotonic()
        lag = start - (t0 + offset)
        try:
            outcome = code.get(target(classes[ci]), ERROR)
        except Exception:
            outcome = ERROR
        latency = time.monotonic() - start
        with rlock:
            records.append((ci, offset, lag, latency, outcome))

    pool = ThreadPoolExecutor(max_workers=concurrency)
    t0 = time.monotonic() + 0.05
    for offset, ci in zip(offsets, cls_idx):
        delay = (t0 + offset) - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        pool.submit(fire, offset, ci, t0)
    pool.shutdown(wait=True)
    return _merge(records, classes, rate)


def plan_rate(total: int, duration_s: float) -> float:
    """Offered rate that lands `total` arrivals in ~`duration_s`."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    return max(1e-9, total / duration_s)


__all__ = [
    "ClassReport",
    "LoadReport",
    "TrafficClass",
    "arrival_schedule",
    "assign_classes",
    "plan_rate",
    "run_open_loop",
    "run_open_loop_threaded",
]
