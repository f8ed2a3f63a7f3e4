"""Fault plans: the control-plane chaos proxy, the training fault plans
of the kill-and-resume soak, seeded serving replica kills and the RL
soak's faults.

The port's copy of `kubeflow_tpu/testing/chaos.py` (a module with no JAX
in it), whole.

The control-plane part (`FAULT_CLASSES`, `HA_FAULT_CLASSES`, `Fault`,
`FaultSchedule`, `ChaosProxy`): a TCP proxy between `HttpApiClient` and
the apiserver facade that injects faults from a finite, seeded plan, so
a soak under faults reproduces from one integer. The classes are the
failure modes a controller meets between itself and an apiserver:

- ``error_5xx``          a synthesized 503 burst: the request never
                         reached the server (a retry is safe);
- ``reset_mid_response`` the response dies partway: the request WAS
                         processed, only the answer is lost;
- ``stale_gone``         a synthesized 410 on a watch: relist;
- ``slow_stream``        the streaming watch crawls, then recovers;
- ``truncate_stream``    the streaming watch is severed mid-body with no
                         terminal chunk;
- ``delay_write``        a write is held before it is forwarded;
- ``crash_before_ack``   a write is forwarded and COMMITTED but the
                         connection dies before the ack (the
                         duplicate-side-effect trap);
- ``apiserver_kill``     (opt-in, `HA_FAULT_CLASSES`) the caller's
                         `kill_active` callback SIGKILLs the active facade.

A `FaultSchedule(seed)` draws the same plan as the JAX package's from
the same arguments; each entry is consumed by the first eligible
request, and `coverage()` counts only the faults whose effect landed on
the wire, so a soak that exercised nothing fails its own gate.

The training part (`TRAIN_FAULT_CLASSES`, `ELASTIC_FAULT_CLASSES`,
`TrainFault`, `TrainFaultSchedule`, `apply_checkpoint_fault`,
`ResumableWrapper`, `SpikedData`) is injected against a real `fit()`
run: its process (SIGKILL between steps, SIGTERM mid-step), its
checkpoints (a truncated file, flipped bytes, a garbled manifest, each
of which `Checkpointer.restore_latest` must quarantine) and its data
(loss spikes the guard must skip). `testing/workers/resilience.py` is
one incarnation of the soak. `ResumableWrapper.rebind` raises: elastic
resize waits for ROADMAP Queue 1 item 12.

The serving part (`ReplicaKill`, `ReplicaKillSchedule`) kills REPLICAS:
a worker dies mid-request under concurrent clients, and the router's ack
contract (acked == completed + failed, failed == 0 for idempotent
traffic) is the gate. The RL soak's part is `ACTOR_KILL`, `LEARNER_KILL`,
`TRIAL_KILL`, `RL_FAULT_CLASSES`, `RLFault` and `RLFaultSchedule`. Every
plan is finite, seeded and coverage-accounted, and for the same
arguments identical to JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import socket
import struct
import threading
import time

log = logging.getLogger(__name__)


FAULT_CLASSES = (
    "error_5xx",
    "reset_mid_response",
    "stale_gone",
    "slow_stream",
    "truncate_stream",
    "delay_write",
    "crash_before_ack",
)

# Whole-control-plane death (arXiv:2011.03641's canonical failure mode):
# SIGKILL the ACTIVE apiserver facade mid-load and let the standby take
# over (testing/failover.py). Not in FAULT_CLASSES — it needs a process
# to kill, so only callers that can supply one (ChaosProxy's
# `kill_active` callback, or the failover soak consuming the schedule
# directly) opt in via FaultSchedule(classes=HA_FAULT_CLASSES); the
# plain wire-proxy soak keeps its historical 7-class plan.
APISERVER_KILL = "apiserver_kill"
HA_FAULT_CLASSES = FAULT_CLASSES + (APISERVER_KILL,)

_WRITE_METHODS = ("POST", "PUT", "DELETE", "PATCH")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned injection. `param` is class-specific (burst length,
    byte budget, delay seconds, body fraction); `gap` is how many
    eligible requests pass unfaulted afterwards, so the system gets
    breathing room to make progress between injections."""

    cls: str
    param: float
    gap: int


def _eligible(cls: str, method: str, path: str, query: str) -> bool:
    """Which requests a fault class may bind to. Streams and watches are
    identified by their query params (the facade's watch contract)."""
    watch = "watch=true" in query or "watch=1" in query
    stream = "stream=true" in query or "stream=1" in query
    if cls in ("slow_stream", "truncate_stream"):
        return stream
    if cls == "stale_gone":
        return watch
    if cls in ("delay_write", "crash_before_ack"):
        return method in _WRITE_METHODS
    if cls == "reset_mid_response":
        # Mid-body resets of a *stream* are truncate_stream's job.
        return not stream
    return True  # error_5xx / apiserver_kill: anything


class FaultSchedule:
    """A finite, seeded fault plan plus its runtime consumption state.

    Two schedules built from the same seed have identical `plan`s — the
    reproducibility contract the soak pins. The first round contains one
    entry of EVERY class (shuffled) so even a short soak can reach 100%
    class coverage; subsequent rounds are uniformly shuffled.
    """

    def __init__(
        self,
        seed: int,
        *,
        faults_per_class: int = 2,
        max_gap: int = 3,
        classes: tuple[str, ...] = FAULT_CLASSES,
    ):
        self.seed = seed
        self.classes = tuple(classes)
        rng = random.Random(seed)

        def mk(cls: str) -> Fault:
            if cls == "error_5xx":
                param = float(rng.randint(1, 3))  # burst length
            elif cls == "reset_mid_response":
                param = rng.uniform(0.2, 0.8)  # body fraction forwarded
            elif cls == "slow_stream":
                param = rng.uniform(0.02, 0.08)  # per-burst delay (s)
            elif cls == "truncate_stream":
                param = float(rng.randint(80, 400))  # bytes before cut
            elif cls == "delay_write":
                param = rng.uniform(0.05, 0.25)  # hold time (s)
            else:  # stale_gone, crash_before_ack, apiserver_kill
                param = 0.0
            return Fault(cls, param, rng.randint(1, max_gap))

        first = (
            [mk(c) for c in self.classes] if faults_per_class >= 1 else []
        )
        rng.shuffle(first)
        rest = [
            mk(c)
            for _ in range(max(0, faults_per_class - 1))
            for c in self.classes
        ]
        rng.shuffle(rest)
        self.plan: tuple[Fault, ...] = tuple(first + rest)
        self._pending: list[Fault] = list(self.plan)
        self._cooldown = 0
        self._inflight = 0
        self._injected: dict[str, int] = {c: 0 for c in self.classes}
        self._lock = threading.Lock()

    @classmethod
    def from_plan(cls, plan) -> "FaultSchedule":
        """A schedule with an explicit plan (targeted tests that need
        exactly one known fault, not a seeded mix)."""
        sched = cls(0, faults_per_class=0)
        sched.plan = tuple(plan)
        sched._pending = list(sched.plan)
        return sched

    def __repr__(self) -> str:  # shows up in assertion messages
        return (
            f"FaultSchedule(seed={self.seed}, planned={len(self.plan)}, "
            f"pending={len(self._pending)}, coverage={self.coverage()})"
        )

    def next_fault(self, method: str, path: str, query: str) -> Fault | None:
        """The fault (if any) to attempt on this request: the first
        pending plan entry the request is eligible for, rate-limited by
        the previous entry's gap. Thread-safe; consumption order across
        concurrent requests may vary, the plan itself never does.

        Consumption is NOT coverage: the proxy calls `mark_injected`
        only once the fault's effect actually lands, and `requeue` when
        it could not (a stream that ended before the truncation budget,
        an upstream that died first) — so `coverage()` never reports
        robustness the run didn't test."""
        with self._lock:
            if not self._pending:
                return None
            if self._cooldown > 0:
                self._cooldown -= 1
                return None
            for i, fault in enumerate(self._pending):
                if _eligible(fault.cls, method, path, query):
                    del self._pending[i]
                    self._cooldown = fault.gap
                    self._inflight += 1
                    return fault
            return None

    def mark_injected(self, fault: Fault) -> None:
        """The fault's effect happened on the wire."""
        with self._lock:
            # .get: from_plan() may stage classes outside this
            # schedule's seeded set (targeted tests).
            self._injected[fault.cls] = self._injected.get(fault.cls, 0) + 1
            self._inflight -= 1

    def requeue(self, fault: Fault) -> None:
        """The fault bound to a request it could not actually affect —
        put it back at the head so a later eligible request retries it."""
        with self._lock:
            self._pending.insert(0, fault)
            self._inflight -= 1

    def coverage(self) -> dict[str, int]:
        """Injections actually performed, per class. The soak's coverage
        gate: every class must be > 0 or the run proved nothing about
        that failure mode."""
        with self._lock:
            return dict(self._injected)

    @property
    def exhausted(self) -> bool:
        """Every plan entry has taken effect (none pending, none still
        bound to an in-flight request)."""
        with self._lock:
            return not self._pending and self._inflight == 0

    @property
    def remaining(self) -> int:
        with self._lock:
            return len(self._pending)


def _abort(sock: socket.socket) -> None:
    """Hard-close: RST instead of FIN (SO_LINGER 0), so the peer sees a
    connection *failure*, not a clean end-of-stream."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _synth_response(status: int, reason: str, payload: dict) -> bytes:
    """A synthesized HTTP/1.1 response in the facade's error envelope
    (`web.wsgi.error_response`), so injected statuses are
    indistinguishable from server-emitted ones at the client."""
    body = json.dumps(
        {"success": False, "status": status, **payload}
    ).encode()
    head = (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    return head + body


class ChaosProxy:
    """Seeded fault-injecting TCP proxy in front of the apiserver facade.

    One listener; each accepted client connection gets a thread and one
    upstream connection (keep-alive preserved end-to-end when no fault
    intervenes). Requests are parsed just enough to classify them
    (method, path, query, Content-Length body) and to frame upstream
    responses (Content-Length vs chunked) so the proxy can relay
    streaming watches chunk-by-chunk — the surface the stream faults
    need.
    """

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        schedule: FaultSchedule,
        host: str = "127.0.0.1",
        port: int = 0,
        kill_active=None,
    ):
        self.upstream = (upstream_host, upstream_port)
        self.schedule = schedule
        # apiserver_kill executor: a caller-supplied callable that
        # SIGKILLs the active facade (and typically restarts the deposed
        # one as a fresh standby). Return a falsy value when no kill
        # happened (the entry requeues), True when the NEW active serves
        # on the same upstream address, or the new active's
        # (host, port) — the proxy retargets, so an active-passive pair
        # on per-replica ports stays reachable through one proxied
        # address across takeovers. Without a callback, apiserver_kill
        # entries requeue forever — so only schedules built with
        # HA_FAULT_CLASSES should meet a proxy without one, and only in
        # tests asserting that.
        self.kill_active = kill_active
        self.host = host
        self._want_port = port
        self._listener: socket.socket | None = None
        self._closed = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # Remaining synthesized 503s of an active error_5xx burst.
        self._burst = 0
        self._burst_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ChaosProxy":
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self._want_port))
        listener.listen(64)
        listener.settimeout(1.0)
        self._listener = listener
        threading.Thread(
            target=self._accept_loop, name="chaos-proxy", daemon=True
        ).start()
        return self

    @property
    def port(self) -> int:
        assert self._listener is not None, "start() first"
        return self._listener.getsockname()[1]

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._closed.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    # -- request parsing ---------------------------------------------------

    def _read_request(self, sock: socket.socket):
        """One full client request (clients send Content-Length-framed
        JSON bodies only). Returns (method, target, raw_head, body) or
        None on clean EOF."""
        buf = b""
        while b"\r\n\r\n" not in buf:
            try:
                data = sock.recv(65536)
            except OSError:
                return None
            if not data:
                return None
            buf += data
        head, _, tail = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        method, target = lines[0].split(" ", 2)[:2]
        length = 0
        for line in lines[1:]:
            name, _, value = line.partition(":")
            if name.strip().lower() == "content-length":
                try:
                    length = int(value.strip())
                except ValueError:
                    length = 0
        body = tail
        while len(body) < length:
            data = sock.recv(65536)
            if not data:
                return None
            body += data
        return method, target, head + b"\r\n\r\n", body

    # -- response relay ----------------------------------------------------

    def _read_response_head(self, upstream: socket.socket):
        """Status line + headers + any body bytes already received.
        Returns (status, headers_lower, raw_head, extra) or None."""
        buf = b""
        while b"\r\n\r\n" not in buf:
            data = upstream.recv(65536)
            if not data:
                return None
            buf += data
        head, _, extra = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers: dict[str, str] = {}
        for line in lines[1:]:
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        return status, headers, head + b"\r\n\r\n", extra

    def _read_exact(self, upstream: socket.socket, buf: bytes, n: int):
        while len(buf) < n:
            data = upstream.recv(65536)
            if not data:
                break
            buf += data
        return buf

    def _relay_fixed(
        self, client, upstream, raw_head, extra, length, fault
    ) -> bool:
        """Relay a Content-Length response; returns False when the
        connection pair must be dropped."""
        try:
            body = self._read_exact(upstream, extra, length)[:length]
        except OSError:
            if fault is not None:
                self.schedule.requeue(fault)
            raise
        if fault is not None and fault.cls == "reset_mid_response":
            cut = max(1, int(len(body) * fault.param)) if body else 0
            try:
                client.sendall(raw_head + body[:cut])
            except OSError:
                pass
            # Either way the client experienced a severed response.
            self.schedule.mark_injected(fault)
            _abort(client)
            return False
        if fault is not None and fault.cls == "crash_before_ack":
            # The upstream response is fully read — the write COMMITTED.
            # The client never hears the ack.
            self.schedule.mark_injected(fault)
            _abort(client)
            return False
        if fault is not None:
            # A stream-class fault bound to a request whose response
            # turned out non-chunked (e.g. the stream request drew a
            # plain-framed error): it never took effect — retry later.
            self.schedule.requeue(fault)
        client.sendall(raw_head + body)
        return True

    def _relay_chunked(self, client, upstream, raw_head, extra, fault) -> bool:
        """Relay a chunked (streaming watch) response burst-by-burst,
        watching for the terminal 0-chunk so keep-alive survives a
        cleanly-ended stream. Returns False when the pair must drop.
        A bound stream fault is marked injected only when its effect
        actually lands (the sever happened / at least one burst was
        delayed) and requeued when the stream ends first — coverage
        must never claim an injection the wire never carried."""
        try:
            client.sendall(raw_head)
        except OSError:
            if fault is not None:
                self.schedule.requeue(fault)
            raise
        relayed = 0
        slow_bursts = 8 if (fault and fault.cls == "slow_stream") else 0
        slowed = False
        tail = b""
        buf = extra

        def settle(applied: bool) -> None:
            if fault is None:
                return
            if applied:
                self.schedule.mark_injected(fault)
            else:
                self.schedule.requeue(fault)

        while True:
            if buf:
                if fault is not None and fault.cls == "truncate_stream":
                    if relayed + len(buf) >= fault.param:
                        keep = max(0, int(fault.param) - relayed)
                        try:
                            client.sendall(buf[:keep])
                        except OSError:
                            pass
                        # Sever with no terminal chunk: the client's
                        # chunked reader must treat this as a transport
                        # failure, never a clean end.
                        settle(True)
                        _abort(client)
                        return False
                if slow_bursts > 0:
                    time.sleep(fault.param)
                    slow_bursts -= 1
                    slowed = True
                try:
                    client.sendall(buf)
                except OSError:
                    settle(slowed)
                    return False
                relayed += len(buf)
                tail = (tail + buf)[-8:]
                buf = b""
                if tail.endswith(b"0\r\n\r\n"):
                    # Terminal chunk: response complete. A slow fault
                    # that delayed at least one burst took effect; a
                    # truncate fault whose byte budget never arrived
                    # did not.
                    settle(slowed if fault is not None
                           and fault.cls == "slow_stream" else False)
                    return True
            try:
                buf = upstream.recv(65536)
            except OSError:
                buf = b""
            if not buf:
                settle(slowed)
                return False  # upstream died mid-stream: drop the pair

    # -- per-connection loop -----------------------------------------------

    def _serve_conn(self, client: socket.socket) -> None:
        upstream: socket.socket | None = None
        client.settimeout(300.0)
        try:
            while not self._closed.is_set():
                req = self._read_request(client)
                if req is None:
                    return
                method, target, raw_head, body = req
                path, _, query = target.partition("?")

                with self._burst_lock:
                    in_burst = self._burst > 0
                    if in_burst:
                        self._burst -= 1
                if in_burst:
                    # Burst continuation: not a plan entry, no coverage
                    # accounting of its own.
                    fault = Fault("error_5xx", 0.0, 0)
                else:
                    fault = self.schedule.next_fault(method, path, query)

                if fault is not None and fault.cls == "error_5xx":
                    if not in_burst and fault.param > 1:
                        with self._burst_lock:
                            self._burst += int(fault.param) - 1
                    client.sendall(
                        _synth_response(
                            503,
                            "Service Unavailable",
                            {"log": "chaos: injected apiserver outage"},
                        )
                    )
                    if not in_burst:
                        self.schedule.mark_injected(fault)
                    continue
                if fault is not None and fault.cls == "stale_gone":
                    client.sendall(
                        _synth_response(
                            410,
                            "Gone",
                            {
                                "log": (
                                    "chaos: resourceVersion expired — "
                                    "relist"
                                )
                            },
                        )
                    )
                    self.schedule.mark_injected(fault)
                    continue
                if fault is not None and fault.cls == APISERVER_KILL:
                    # Whole-facade death: the caller's callback SIGKILLs
                    # the active. The in-flight request dies with it (an
                    # aborted connection, exactly what a real kill does
                    # to this client), and every other client discovers
                    # the death through its own transport errors.
                    killed = (
                        self.kill_active()
                        if self.kill_active is not None
                        else None
                    )
                    if killed:
                        if isinstance(killed, tuple):
                            # The new active serves elsewhere (per-
                            # replica ports): retarget, so the NEXT
                            # connection through this proxy reaches it.
                            self.upstream = killed
                        self.schedule.mark_injected(fault)
                        _abort(client)
                        return
                    self.schedule.requeue(fault)
                    fault = None
                if fault is not None and fault.cls == "delay_write":
                    # The hold itself is the effect; the write then
                    # proceeds normally.
                    time.sleep(fault.param)
                    self.schedule.mark_injected(fault)
                    fault = None

                if upstream is None:
                    try:
                        upstream = socket.create_connection(
                            self.upstream, timeout=300.0
                        )
                    except OSError:
                        if fault is not None:
                            self.schedule.requeue(fault)
                        _abort(client)
                        return
                    with self._conns_lock:
                        self._conns.add(upstream)
                try:
                    upstream.sendall(raw_head + body)
                    resp = self._read_response_head(upstream)
                except OSError:
                    resp = None
                if resp is None:
                    # Upstream gone mid-request: the bound fault never
                    # took effect — retry it later. Surface a transport
                    # failure to the client and retire both ends.
                    if fault is not None:
                        self.schedule.requeue(fault)
                    _abort(client)
                    return
                status, headers, resp_head, extra = resp
                try:
                    if headers.get("transfer-encoding", "").lower() == \
                            "chunked":
                        ok = self._relay_chunked(
                            client, upstream, resp_head, extra, fault
                        )
                    else:
                        length = int(headers.get("content-length", 0) or 0)
                        ok = self._relay_fixed(
                            client, upstream, resp_head, extra, length,
                            fault,
                        )
                except OSError:
                    ok = False
                if not ok:
                    return
                if headers.get("connection", "").lower() == "close":
                    return
        except Exception:
            log.debug("chaos proxy connection error", exc_info=True)
        finally:
            for sock in (client, upstream):
                if sock is None:
                    continue
                with self._conns_lock:
                    self._conns.discard(sock)
                try:
                    sock.close()
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# Training fault plans
#
# The control-plane proxy above injects faults on the wire; training
# faults are injected against a real `fit()` run instead — the process,
# its checkpoints, and its data. Same discipline: a finite SEEDED plan,
# consumed by a caller that runs subprocess incarnations, with coverage
# accounting so a soak that quietly exercised nothing fails its gate.
# The plans equal JAX's for the same arguments, the elastic ones too;
# the port's `fit(elastic=)` still raises (ROADMAP Queue 1 item 12), so
# an elastic plan has no worker to run it yet.
# ---------------------------------------------------------------------------

TRAIN_FAULT_CLASSES = (
    # process faults — one crash boundary each
    "kill",                  # SIGKILL between steps: no warning, no save
    "sigterm",               # SIGTERM mid-step: fit must exit Preempted
                             # at the boundary after an emergency save
    # storage faults — applied between incarnations, against the newest
    # checkpoint (each exercises a distinct verification path)
    "truncate_checkpoint",   # torn write: a committed file loses its tail
    "corrupt_checkpoint",    # bit rot: same size, flipped bytes
    "corrupt_manifest",      # the verifier's own record is garbage
    # data faults — identical in the baseline run (part of the data)
    "loss_spike",            # a poison batch the AnomalyGuard must skip
)

# Elastic-resize fault classes: the soak variant where
# preemption is ABSORBED instead of fatal. A `preempt_shrink` is a real
# SIGTERM self-delivered at the scheduled position WITH a staged
# shrink-to-fit target (the scheduler's resize proposal): fit() must
# reshape the mesh at the boundary and keep training — the process
# never dies, so steps-lost-per-kill is ~0 instead of a save-interval's
# worth. `grow_back` is the unprompted return to full dp when capacity
# comes back. Built with `TrainFaultSchedule(..., elastic=True)`, which
# swaps the crash/storage classes for resize cycles (the no-death
# story) while keeping the loss spikes (the guard must compose with
# resize).
ELASTIC_FAULT_CLASSES = (
    "preempt_shrink",
    "grow_back",
    "loss_spike",
)

# The accepted steps before the soak worker's guard arms its spike tests;
# the plan puts every loss spike after them.
DEFAULT_GUARD_WARMUP = 3

_PROCESS_CLASSES = ("kill", "sigterm")
_STORAGE_CLASSES = ("truncate_checkpoint", "corrupt_checkpoint", "corrupt_manifest")


@dataclasses.dataclass(frozen=True)
class TrainFault:
    """One planned training fault. `at_step` is the 0-based batch
    position it binds to (process/data faults; 0 for storage faults);
    `after_crash` is the 0-based crash-boundary index a storage fault is
    applied at, and `offset` which checkpoint it targets (0 = newest,
    1 = second-newest, ...) — faults stacked on one boundary get
    distinct offsets so each one's verification path is actually
    exercised by the newest-first fallback walk, not masked by a
    sibling fault on the same step. `dp` is the resize target of an
    elastic fault (preempt_shrink/grow_back; 0 otherwise)."""

    cls: str
    at_step: int = 0
    after_crash: int = 0
    offset: int = 0
    dp: int = 0


class TrainFaultSchedule:
    """A finite, seeded fault plan for a kill-and-resume soak.

    Pure function of (seed, total_steps, save_interval,
    faults_per_class): two schedules from the same arguments have
    identical plans — the reproducibility contract the soak pins, same
    as `FaultSchedule`. The plan always covers EVERY class:

    - `faults_per_class` kills and sigterms, placed at ascending step
      positions spaced >= 3*save_interval + 2 apart (and at least that
      far in), so every incarnation both finds >= 3 prior checkpoints
      (max_to_keep's worth) to fall back through and makes save
      progress before dying;
    - `faults_per_class` of each storage class, distributed round-robin
      over the crash boundaries with per-boundary distinct `offset`s
      (newest, second-newest, ...), so stacked faults damage DIFFERENT
      steps and the fallback walk meets every one;
    - `faults_per_class` loss spikes at positions the guard's EWMA has
      warmed up for, disjoint from the crash steps.

    ``elastic=True`` builds the RESIZE soak's plan instead:
    `faults_per_class` shrink->grow cycles — each a `preempt_shrink`
    (real SIGTERM + staged target ``dp_shrunk``) later undone by a
    `grow_back` to ``dp_full`` — plus the same loss spikes; the crash
    and storage classes are absent because the whole point is that the
    process never dies and the checkpoint directory is never the
    recovery path. Coverage accounting runs over
    `ELASTIC_FAULT_CLASSES`.
    """

    def __init__(
        self,
        seed: int,
        total_steps: int,
        *,
        save_interval: int,
        faults_per_class: int = 1,
        guard_warmup: int = DEFAULT_GUARD_WARMUP,
        elastic: bool = False,
        dp_full: int = 2,
        dp_shrunk: int = 1,
    ):
        self.seed = seed
        self.total_steps = total_steps
        self.save_interval = save_interval
        self.elastic = elastic
        self._injected: dict[str, int] = {
            c: 0
            for c in (
                ELASTIC_FAULT_CLASSES if elastic else TRAIN_FAULT_CLASSES
            )
        }
        self._lock = threading.Lock()
        rng = random.Random(seed)

        if elastic:
            self._init_elastic(
                rng, total_steps, faults_per_class, guard_warmup,
                dp_full, dp_shrunk,
            )
            return

        self.resize_faults: tuple[TrainFault, ...] = ()
        k = faults_per_class
        spacing = 3 * save_interval + 2
        first = spacing
        last = total_steps - 2
        n_crashes = 2 * k
        if first + (n_crashes - 1) * spacing > last:
            raise ValueError(
                f"total_steps={total_steps} too small for {n_crashes} "
                f"crashes spaced {spacing} (save_interval={save_interval})"
            )
        # Ascending crash positions with guaranteed spacing: distribute
        # the slack between the minimum-spacing slots.
        slack = last - (first + (n_crashes - 1) * spacing)
        offsets = sorted(rng.randint(0, slack) for _ in range(n_crashes))
        steps = [first + i * spacing + offsets[i] for i in range(n_crashes)]
        kinds = [_PROCESS_CLASSES[i % 2] for i in range(n_crashes)]
        rng.shuffle(kinds)
        self.crash_faults: tuple[TrainFault, ...] = tuple(
            TrainFault(cls, at_step=s) for cls, s in zip(kinds, steps)
        )

        storage = [cls for cls in _STORAGE_CLASSES for _ in range(k)]
        rng.shuffle(storage)
        per_boundary: dict[int, int] = {}
        storage_faults = []
        for i, cls in enumerate(storage):
            boundary = i % n_crashes
            offset = per_boundary.get(boundary, 0)
            per_boundary[boundary] = offset + 1
            storage_faults.append(
                TrainFault(cls, after_crash=boundary, offset=offset)
            )
        self.storage_faults: tuple[TrainFault, ...] = tuple(storage_faults)

        crash_steps = {f.at_step for f in self.crash_faults}
        candidates = [
            s for s in range(max(guard_warmup + 2, 3), total_steps - 1)
            if s not in crash_steps
        ]
        spikes = sorted(rng.sample(candidates, k))
        self.spike_faults: tuple[TrainFault, ...] = tuple(
            TrainFault("loss_spike", at_step=s) for s in spikes
        )

        self.plan: tuple[TrainFault, ...] = (
            self.crash_faults + self.storage_faults + self.spike_faults
        )

    def _init_elastic(
        self, rng, total_steps: int, k: int, guard_warmup: int,
        dp_full: int, dp_shrunk: int,
    ) -> None:
        """The resize-soak plan: k shrink->grow cycles at ascending,
        spaced positions, plus the usual seeded loss spikes."""
        if dp_shrunk >= dp_full or dp_shrunk < 1:
            raise ValueError(
                f"elastic schedule needs 1 <= dp_shrunk < dp_full, got "
                f"{dp_shrunk} / {dp_full}"
            )
        self.crash_faults = ()
        self.storage_faults = ()
        spacing = max(3, self.save_interval)
        first = max(guard_warmup + 2, spacing)
        last = total_steps - 2
        n_events = 2 * k
        if first + (n_events - 1) * spacing > last:
            raise ValueError(
                f"total_steps={total_steps} too small for {k} "
                f"shrink->grow cycles spaced {spacing}"
            )
        slack = last - (first + (n_events - 1) * spacing)
        offsets = sorted(rng.randint(0, slack) for _ in range(n_events))
        steps = [first + i * spacing + offsets[i] for i in range(n_events)]
        self.resize_faults = tuple(
            TrainFault(
                "preempt_shrink" if i % 2 == 0 else "grow_back",
                at_step=s,
                dp=dp_shrunk if i % 2 == 0 else dp_full,
            )
            for i, s in enumerate(steps)
        )
        resize_steps = {f.at_step for f in self.resize_faults}
        candidates = [
            s for s in range(max(guard_warmup + 2, 3), total_steps - 1)
            if s not in resize_steps
        ]
        spikes = sorted(rng.sample(candidates, k))
        self.spike_faults = tuple(
            TrainFault("loss_spike", at_step=s) for s in spikes
        )
        self.plan = self.resize_faults + self.spike_faults

    @property
    def resize_plan(self) -> tuple[dict, ...]:
        """The resize cycles as the worker's staged-proposal env
        payload (JSON-ready)."""
        return tuple(
            {"at_step": f.at_step, "dp": f.dp, "cls": f.cls}
            for f in self.resize_faults
        )

    @property
    def spike_steps(self) -> tuple[int, ...]:
        return tuple(f.at_step for f in self.spike_faults)

    def storage_after(self, crash_idx: int) -> tuple[TrainFault, ...]:
        """Storage faults the caller applies after crash boundary
        `crash_idx` (the newest checkpoint is the target)."""
        return tuple(
            f for f in self.storage_faults if f.after_crash == crash_idx
        )

    def mark_injected(self, fault: TrainFault) -> None:
        """The fault's effect verifiably happened (the caller observed
        the kill/exit code, mutated a real file, or counted the guard
        skip)."""
        with self._lock:
            self._injected[fault.cls] += 1

    def coverage(self) -> dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def __repr__(self) -> str:
        return (
            f"TrainFaultSchedule(seed={self.seed}, "
            f"planned={len(self.plan)}, coverage={self.coverage()})"
        )


def apply_checkpoint_fault(ckpt_dir, cls: str, offset: int = 0) -> str | None:
    """Mutate the checkpoint `offset` steps back from the newest under
    `ckpt_dir` (0 = newest) per the storage fault class. Returns a
    description of what was damaged, or None when there was nothing to
    damage at that offset (the caller must treat that as a scheduling
    bug — storage faults are planned after >= max_to_keep saves)."""
    from pathlib import Path

    from kubeflow_tpu_torch.train.checkpoint import MANIFEST_NAME

    root = Path(ckpt_dir)
    steps = sorted(
        (int(p.name), p) for p in root.iterdir()
        if p.is_dir() and p.name.isdigit()
    )
    if len(steps) <= offset:
        return None
    step, step_dir = steps[-1 - offset]
    if cls == "corrupt_manifest":
        target = step_dir / MANIFEST_NAME
        # Unparsable JSON: the verifier must treat it as corruption, not
        # crash on it.
        target.write_bytes(b'{"files": {broken')
        return f"corrupt_manifest step={step}"
    files = sorted(
        (p for p in step_dir.rglob("*")
         if p.is_file() and p.name != MANIFEST_NAME),
        key=lambda p: p.stat().st_size,
    )
    if not files:
        return None
    target = files[-1]  # the largest payload file: real tensor bytes
    data = target.read_bytes()
    if cls == "truncate_checkpoint":
        target.write_bytes(data[: max(1, len(data) // 2)])
        return f"truncate_checkpoint step={step} file={target.name}"
    if cls == "corrupt_checkpoint":
        mid = len(data) // 2
        flipped = bytes(b ^ 0xFF for b in data[mid:mid + 16])
        target.write_bytes(data[:mid] + flipped + data[mid + 16:])
        return f"corrupt_checkpoint step={step} file={target.name}"
    raise ValueError(f"unknown storage fault class {cls!r}")


class ResumableWrapper:
    """Base for fault-injecting wrappers over a resumable data iterable:
    forwards the whole resumable-data protocol (`train/loop.py`) so a
    wrapped stream checkpoints/restores/perturbs exactly like the bare
    one, and exposes `position` — the upcoming batch's 0-based index —
    in either state dialect (the synthetic streams count "position",
    RecordDataset counts "batches_delivered")."""

    def __init__(self, data):
        self._data = data

    @property
    def position(self) -> int:
        state = self._data.state_dict()
        if "position" in state:
            return int(state["position"])
        return int(state["batches_delivered"])

    def state_dict(self) -> dict:
        return self._data.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._data.load_state_dict(state)

    def rebind(self, mesh) -> "ResumableWrapper":
        """Elastic resize's re-targeting of the wrapped stream: not
        ported."""
        raise NotImplementedError(
            "ResumableWrapper.rebind follows an elastic mesh resize, which is "
            "not ported yet (ROADMAP Queue 1 item 12)"
        )

    def __getattr__(self, name):
        # `perturb` is OPTIONAL in the protocol: expose it only when
        # the wrapped data actually has one, so capability probes
        # (e.g. fit()'s rollback precondition, which must refuse
        # non-perturbable data rather than run futile identical
        # retries) see the truth through the wrapper.
        if name == "perturb" and "_data" in self.__dict__:
            return getattr(self._data, "perturb")
        raise AttributeError(name)

    def __iter__(self):
        it = iter(self._data)
        while True:
            pos = self.position
            try:
                batch = next(it)
            except StopIteration:
                # PEP 479: a StopIteration escaping a generator body
                # becomes RuntimeError — end cleanly instead, so finite
                # wrapped streams (e.g. bounded-epoch RecordDatasets)
                # still signal exhaustion to the training loop.
                return
            yield self.transform(pos, batch)

    def transform(self, pos: int, batch):
        """Override: the (possibly faulted) batch for position `pos`."""
        return batch


class SpikedData(ResumableWrapper):
    """Deterministic loss-spike injector over a resumable data iterable.

    At each position in `positions`, the yielded batch's float fields
    are scaled by `scale` — a poison batch whose loss/grad-norm the
    AnomalyGuard must reject. The spike is a pure function of the
    position, so a resumed (or baseline) run sees the identical poison
    at the identical step — the spikes are part of the data, which is
    what lets the soak assert exact final-state parity against an
    uninterrupted run."""

    def __init__(self, data, positions, scale: float = 1e4):
        super().__init__(data)
        self.positions = frozenset(int(p) for p in positions)
        self.scale = scale

    def transform(self, pos: int, batch):
        if pos not in self.positions:
            return batch
        return {
            k: v * self.scale if _is_float(v) else v
            for k, v in batch.items()
        }


def _is_float(value) -> bool:
    """A floating-point tensor (the port's streams) or array."""
    is_fp = getattr(value, "is_floating_point", None)
    if callable(is_fp):
        return bool(is_fp())
    return value.dtype.kind == "f"



REPLICA_KILL = "replica_kill"
SERVING_FAULT_CLASSES = (REPLICA_KILL,)


@dataclasses.dataclass(frozen=True)
class ReplicaKill:
    """One planned replica death. `at_fraction` is the point in the
    offered load (completed-requests fraction, 0..1) the kill fires at;
    `victim` indexes into the READY set at fire time (mod its length),
    so the plan stays meaningful however many replicas are still up."""

    cls: str
    at_fraction: float
    victim: int


class ReplicaKillSchedule:
    """A finite, seeded replica-kill plan for a serving chaos run.

    Pure function of (seed, kills, replicas): two schedules from the
    same arguments have identical plans, and the JAX package's schedule
    draws the same plan from the same arguments. Kills land at
    ascending load fractions inside `window` (default mid-run, so every
    kill hits a fleet with requests in flight AND leaves load behind it
    to prove recovery), each targeting a seeded victim index.

    `due(fraction)` is the caller's poll: it pops at most one kill whose
    trigger fraction has passed. Consumption is not coverage —
    `mark_injected` records only kills whose effect landed (the caller
    observed the process die / the queue close), so `coverage()` never
    reports robustness the run didn't test."""

    def __init__(
        self,
        seed: int,
        *,
        kills: int = 1,
        replicas: int = 3,
        window: tuple[float, float] = (0.2, 0.7),
    ):
        self.seed = seed
        rng = random.Random(seed)
        lo, hi = window
        span = (hi - lo) / max(1, kills)
        plan = []
        for i in range(kills):
            at = lo + span * (i + rng.uniform(0.25, 0.75))
            plan.append(
                ReplicaKill(REPLICA_KILL, at, rng.randrange(replicas))
            )
        self.plan: tuple[ReplicaKill, ...] = tuple(plan)
        self._pending: list[ReplicaKill] = list(self.plan)
        self._injected: dict[str, int] = {c: 0 for c in SERVING_FAULT_CLASSES}
        self._lock = threading.Lock()

    @classmethod
    def from_plan(cls, plan) -> "ReplicaKillSchedule":
        """A schedule with an explicit plan (targeted tests that need a
        kill at an exact point, not a seeded mix)."""
        sched = cls(0, kills=0)
        sched.plan = tuple(plan)
        sched._pending = list(sched.plan)
        return sched

    def due(self, fraction: float) -> ReplicaKill | None:
        """The kill (if any) whose trigger point has passed. At most one
        per call so the caller applies each death and lets the router
        react before the next. Thread-safe."""
        with self._lock:
            if self._pending and fraction >= self._pending[0].at_fraction:
                return self._pending.pop(0)
            return None

    def mark_injected(self, kill: ReplicaKill) -> None:
        """The kill verifiably landed (process dead / queue closed)."""
        with self._lock:
            self._injected[kill.cls] = self._injected.get(kill.cls, 0) + 1

    def coverage(self) -> dict[str, int]:
        with self._lock:
            return dict(self._injected)

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return not self._pending

    def __repr__(self) -> str:
        return (
            f"ReplicaKillSchedule(seed={self.seed}, "
            f"planned={len(self.plan)}, coverage={self.coverage()})"
        )


# ---------------------------------------------------------------------------
# RL soak faults.
#
# The RL soak runs a StudyJob of short actor–learner trials and kills
# each layer of the coupled system in a different trial: an ACTOR's
# serving replica mid-study (the fleet must heal and the loop keep
# acting), the LEARNER mid-fit (SIGKILL; the resumed incarnation must
# continue the same replay position), and a whole TRIAL before it
# trains (the study controller must reschedule it). Coverage is gated on
# worker-reported evidence, never on the soak's intent.
# ---------------------------------------------------------------------------

ACTOR_KILL = "actor_kill"
LEARNER_KILL = "learner_kill"
TRIAL_KILL = "trial_kill"
RL_FAULT_CLASSES = (ACTOR_KILL, LEARNER_KILL, TRIAL_KILL)


@dataclasses.dataclass(frozen=True)
class RLFault:
    """One planned RL fault. `trial` is the study trial index it binds
    to; `at_fraction` the point in that trial's learner progress
    (steps-done fraction, 0..1) it fires at. trial_kill fires before
    meaningful training (the reschedule story), learner_kill mid-fit
    (the resume story), actor_kill mid-fit (the heal story)."""

    cls: str
    trial: int
    at_fraction: float


class RLFaultSchedule:
    """A finite, seeded fault plan for the RL study soak.

    Pure function of (seed, trials): the soak and every trial worker
    construct the identical schedule from the env-carried seed,
    so a worker self-derives its own faults from its trial index (read
    off its job's trial label) — no fault channel between processes,
    which is exactly why a kill can't be lost in transit.

    Every class lands on a DISTINCT trial (requires trials >= 3) so one
    trial's recovery can't mask another class going uninjected.
    `mark_injected` is driven by worker-reported evidence only (the
    observation rows carry what actually happened), so `coverage()`
    never reports robustness the run didn't test.
    """

    def __init__(self, seed: int, *, trials: int):
        if trials < len(RL_FAULT_CLASSES):
            raise ValueError(
                f"RL soak needs >= {len(RL_FAULT_CLASSES)} trials for "
                f"distinct per-class victims, got {trials}"
            )
        self.seed = seed
        self.trials = trials
        # A STRING seed: Random(str) seeds via sha512 — stable across
        # processes, which the soak/worker shared-plan contract needs
        # (tuple/other hashables seed via hash(), randomized per
        # process by PYTHONHASHSEED).
        rng = random.Random(f"rl-{seed}")
        victims = rng.sample(range(trials), len(RL_FAULT_CLASSES))
        windows = {
            # Early: the trial dies before training matters.
            TRIAL_KILL: (0.0, 0.1),
            # Mid-fit, past warmup, with room left to prove recovery.
            LEARNER_KILL: (0.35, 0.65),
            ACTOR_KILL: (0.3, 0.6),
        }
        plan = []
        for cls, trial in zip(RL_FAULT_CLASSES, victims):
            lo, hi = windows[cls]
            plan.append(RLFault(cls, trial, rng.uniform(lo, hi)))
        self.plan: tuple[RLFault, ...] = tuple(
            sorted(plan, key=lambda f: f.trial)
        )
        self._injected: dict[str, int] = {c: 0 for c in RL_FAULT_CLASSES}
        self._lock = threading.Lock()

    def for_trial(self, trial: int) -> tuple[RLFault, ...]:
        """The faults bound to one trial (what a worker self-delivers)."""
        return tuple(f for f in self.plan if f.trial == trial)

    def mark_injected(self, cls: str) -> None:
        """Worker-reported evidence says this class's effect landed."""
        with self._lock:
            self._injected[cls] = self._injected.get(cls, 0) + 1

    def coverage(self) -> dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def __repr__(self) -> str:
        return (
            f"RLFaultSchedule(seed={self.seed}, trials={self.trials}, "
            f"planned={len(self.plan)}, coverage={self.coverage()})"
        )
