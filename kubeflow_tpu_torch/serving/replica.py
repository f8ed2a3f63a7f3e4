"""Replica adapters and the replica runtime behind the serving router.

Counterpart of `kubeflow_tpu/serving/replica.py` (a module with no JAX
in it), on the port's batching queue, registry, router and wire. The
router (`serving/router.py`) speaks one small surface (``name``,
``capacity``, ``predict()``, optional ``stats()``) and two exception
contracts (`ReplicaGone`, `ReplicaOverloaded`). Three adapters
implement it:

- `LocalReplica`: a Servable behind its own continuous `BatchingQueue`
  in this process. `kill()` fails in-flight callers exactly the way a
  SIGKILLed process resets its connections.
- `MultiModelReplica`: N servables behind one replica slot, over a
  `ServableRegistry` (per-model queues, LRU weight paging).
- `HttpReplica`: a model-server process reached over a pooled
  keep-alive HTTP transport speaking the binary tensor frames
  (`serving/wire.py`, JSON negotiation fallback); transport failures
  and 5xx map to `ReplicaGone` (and invalidate the pool), 429 maps to
  `ReplicaOverloaded` with the server's own Retry-After hint.

`LocalReplicaRuntime` is the materialization backend a serving
controller drives: ensure/stop/roll replicas against a router,
reporting per-replica readiness and queue stats. The process runtime
(replica mode) is not ported yet.
"""

from __future__ import annotations

import http.client
import json
import select
import threading

import numpy as np

from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.batching import (
    BatchingConfig,
    BatchingQueue,
    QueueClosed,
    QueueFull,
)
from kubeflow_tpu_torch.serving.registry import (
    ModelNotFound,
    PagingConfig,
    ServableRegistry,
)
from kubeflow_tpu_torch.serving.router import (
    ReplicaGone,
    ReplicaOverloaded,
    Router,
)
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry


class LocalReplica:
    """One servable behind one continuous batching queue, in-process."""

    def __init__(
        self,
        name: str,
        servable,
        config: BatchingConfig | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        self.name = name
        self._config = config or BatchingConfig()
        self._metrics = metrics
        self._lock = threading.Lock()
        self._dead = False
        self._queue = BatchingQueue(servable, self._config, metrics)

    @property
    def capacity(self) -> int:
        return self._config.max_pending

    @property
    def version(self) -> int:
        with self._lock:
            return self._queue.servable.version

    @property
    def ready(self) -> bool:
        with self._lock:
            return not self._dead and not self._queue.stats()["closed"]

    def predict(self, instances, *, model: str | None = None) -> np.ndarray:
        with self._lock:
            dead, queue = self._dead, self._queue
        if dead:
            raise ReplicaGone(f"replica {self.name!r} is dead")
        if model is not None and model != queue.servable.name:
            # Single-model replica asked for a different servable: a
            # model error (404 at the boundary), never a retry.
            raise ModelNotFound(model)
        try:
            return queue.predict(instances)
        except QueueFull as e:
            raise ReplicaOverloaded(str(e)) from e
        except QueueClosed as e:
            # Killed or torn down mid-request — to the caller that is
            # indistinguishable from process death.
            raise ReplicaGone(str(e)) from e

    def stats(self) -> dict:
        with self._lock:
            queue = self._queue
        return {
            "ready": self.ready,
            "version": queue.servable.version,
            **queue.stats(),
        }

    def swap(self, servable) -> None:
        """Replace the model (checkpoint roll). The caller must have
        quiesced this replica first (`Router.roll` drains before calling
        swap); the old queue closes after the new one is taking over, so
        a racing direct caller errors with QueueClosed → retry."""
        with self._lock:
            old, self._queue = self._queue, BatchingQueue(
                servable, self._config, self._metrics
            )
        old.close()

    def kill(self) -> None:
        """Chaos: die the way SIGKILL dies — in-flight and queued callers
        all fail immediately with ReplicaGone (via QueueClosed)."""
        with self._lock:
            self._dead = True
            queue = self._queue
        queue.kill()

    def close(self) -> None:
        with self._lock:
            queue = self._queue
        queue.close()


class MultiModelReplica:
    """N servables behind ONE replica slot: the multiplexing adapter
    over a `ServableRegistry` (per-model continuous-batch queues + LRU
    weight paging). The router surface is the same as `LocalReplica`'s
    plus the ``model=`` selector; exception mapping:

    - `ModelNotFound` propagates (a model error → 404 at the boundary,
      never a retry — every replica carries the same catalog);
    - `QueueFull` → `ReplicaOverloaded` (that MODEL's queue is full —
      siblings may still have room, the router respreads);
    - `QueueClosed` out of a killed registry → `ReplicaGone`.

    ``capacity`` is the router backpressure budget for the whole
    replica. The default (one model's ``max_pending``) is deliberately
    conservative — the fleet sheds before any single queue must."""

    def __init__(
        self,
        name: str,
        registry: ServableRegistry,
        *,
        capacity: int | None = None,
    ):
        self.name = name
        self.registry = registry
        self.capacity = (
            capacity
            if capacity is not None
            else registry.batching.max_pending
        )
        self._dead = False

    @property
    def ready(self) -> bool:
        return not self._dead and not self.registry.stats()["closed"]

    def predict(self, instances, *, model: str | None = None) -> np.ndarray:
        if self._dead:
            raise ReplicaGone(f"replica {self.name!r} is dead")
        if model is None:
            models = self.registry.models()
            if len(models) != 1:
                raise ModelNotFound(
                    "multiplexed replica needs an explicit model "
                    f"(serving {len(models)})"
                )
            model = models[0]
        try:
            return self.registry.predict(model, instances)
        except QueueFull as e:
            raise ReplicaOverloaded(str(e)) from e
        except QueueClosed as e:
            raise ReplicaGone(str(e)) from e

    def stats(self) -> dict:
        """Per-model registry snapshot plus the aggregate queue signal
        the autoscaler reads (sum of depths, worst wait)."""
        rstats = self.registry.stats()
        per_model = rstats["models"]
        return {
            "ready": self.ready,
            "models": per_model,
            "resident": rstats["resident"],
            "queue_depth": sum(
                m.get("queue_depth", 0) for m in per_model.values()
            ),
            "queue_wait_ms": max(
                (m.get("queue_wait_ms", 0.0) for m in per_model.values()),
                default=0.0,
            ),
        }

    def roll_model(self, model: str, rspec: dict) -> None:
        """Swap ONE model's generation; the other queues keep serving.
        `LocalReplicaRuntime.roll` calls this with the replica drained —
        per-model rolls ride the existing drain machinery."""
        self.registry.roll(model, rspec)

    def kill(self) -> None:
        """Chaos: replica death fails every model's queued and in-flight
        work with ReplicaGone (via the registry's QueueClosed)."""
        self._dead = True
        self.registry.kill()

    def close(self) -> None:
        self.registry.close()


class HttpReplica:
    """A model-server process (`python -m kubeflow_tpu_torch.serving`)
    behind the router, reached over a POOLED keep-alive transport
    speaking the binary tensor protocol (`serving/wire.py`), with JSON
    as the negotiation fallback.

    One TCP connection per request would keep replica death crisp;
    pooling keeps the death contract crisp another way:

    - Every pooled socket carries the pool's **generation** stamp.
      `invalidate_pool()` (called on any transport failure, on router
      drain, and on close) bumps the generation and closes idle
      sockets; a request returning a socket from an older generation
      discards it instead of re-pooling — a socket from a dead or
      pre-drain incarnation can never serve a later request.
    - A **stale idle socket** — the peer reaped the keep-alive, so the
      socket shows EOF/reset BEFORE any request bytes are written — is
      detected by a zero-timeout readability probe at checkout and
      transparently replaced by one fresh dial. That is the only
      transparent retry.
    - Any failure **after bytes hit the wire** (send error, reset
      mid-response) still raises `ReplicaGone`, exactly as
      conn-per-request did: the router's idempotent-retry accounting
      and the `acked == completed + failed` invariant see the same
      crisp death signal.

    Protocol negotiation: requests go out as
    ``Content-Type: application/x-kftpu-tensor`` frames with a matching
    Accept. A server that has never answered a frame and 4xx's the
    first one is assumed JSON-only and the replica drops to the JSON
    surface for good (`binary=False` forces it from the start)."""

    def __init__(
        self,
        name: str,
        address: str,
        model: str,
        *,
        capacity: int = 256,
        timeout: float = 30.0,
        binary: bool = True,
        pool_size: int = 32,
    ):
        self.name = name
        host, _, port = address.rpartition(":")
        self._host, self._port = host, int(port)
        self._model = model
        self.capacity = capacity
        self._timeout = timeout
        self._pool_size = pool_size
        self._pool_lock = threading.Lock()
        self._idle: list[http.client.HTTPConnection] = []
        self._generation = 0
        self._dials = 0
        self._bytes_sent = 0
        self._bytes_received = 0
        # Negotiation state: try frames until the server rejects one
        # before ever accepting one. Flags are written OUTSIDE the pool
        # lock on purpose — they are monotonic one-way latches.
        self._binary = binary
        self._binary_confirmed = False

    # -- pooled transport --------------------------------------------------

    @staticmethod
    def _sock_idle_alive(conn) -> bool:
        """Zero-timeout staleness probe on an idle pooled socket: a
        readable idle HTTP connection means EOF, reset, or protocol
        garbage — all stale. No request bytes have been written yet, so
        discarding it is invisible to the death contract."""
        sock = conn.sock
        if sock is None:
            return False
        try:
            readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            return False
        return not readable

    def _checkout(self) -> tuple[int, http.client.HTTPConnection]:
        """A healthy connection + the generation it was issued under.
        Stale idle sockets are discarded (see `_sock_idle_alive`) and
        replaced by exactly one fresh dial."""
        while True:
            with self._pool_lock:
                generation = self._generation
                conn = self._idle.pop() if self._idle else None
                if conn is None:
                    self._dials += 1
            if conn is None:
                return generation, http.client.HTTPConnection(
                    self._host, self._port, timeout=self._timeout
                )
            if self._sock_idle_alive(conn):
                return generation, conn
            conn.close()

    def _checkin(self, generation: int, conn, resp) -> None:
        reusable = (
            conn.sock is not None
            and not resp.will_close
            and resp.isclosed()  # body fully read; framing intact
        )
        with self._pool_lock:
            if (
                reusable
                and generation == self._generation
                and len(self._idle) < self._pool_size
            ):
                self._idle.append(conn)
                return
        conn.close()

    def _account(self, sent: int, received: int) -> None:
        with self._pool_lock:
            self._bytes_sent += sent
            self._bytes_received += received

    def invalidate_pool(self) -> None:
        """Mark-dead / drain hook: bump the generation so nothing from
        the old incarnation is ever reused, and close idle sockets."""
        with self._pool_lock:
            self._generation += 1
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()

    def close(self) -> None:
        self.invalidate_pool()

    def transport_stats(self) -> dict:
        """Observability for the bench and tests: dials tells you the
        pool is actually pooling, the byte counters feed the
        serving_wire_bytes_per_request row."""
        with self._pool_lock:
            return {
                "dials": self._dials,
                "idle": len(self._idle),
                "generation": self._generation,
                "bytes_sent": self._bytes_sent,
                "bytes_received": self._bytes_received,
            }

    def _request(
        self, method: str, path: str, body: bytes | None, headers: dict
    ) -> tuple[int, bytes, str | None, str]:
        """One request over the pool. Transport failure = the replica
        is gone: invalidate the pool (no sibling thread may reuse a
        socket into the dead incarnation) and raise `ReplicaGone`."""
        generation, conn = self._checkout()
        try:
            conn.request(method, path, body or b"", headers)
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            retry_after = resp.getheader("Retry-After")
            content_type = resp.getheader("Content-Type") or ""
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            self.invalidate_pool()
            raise ReplicaGone(
                f"replica {self.name!r} unreachable: {e}"
            ) from e
        self._account(len(body or b""), len(data))
        self._checkin(generation, conn, resp)
        return status, data, retry_after, content_type

    # -- request surface ---------------------------------------------------

    def predict(self, instances, *, model: str | None = None) -> np.ndarray:
        arr = np.asarray(instances)
        use_binary = self._binary
        if use_binary:
            body = wire.encode_tensor(arr)
            headers = {
                "Content-Type": wire.TENSOR_CONTENT_TYPE,
                "Accept": wire.TENSOR_CONTENT_TYPE,
            }
        else:
            body = json.dumps({"instances": arr.tolist()}).encode()
            headers = {
                "Content-Type": "application/json",
                "Accept": "application/json",
            }
        # Multiplexed dispatch rides the path, same as TF-Serving: the
        # router's model= selects which servable on the worker serves
        # this request; None keeps the replica's configured default.
        target = model or self._model
        status, data, retry_after, content_type = self._request(
            "POST", f"/v1/models/{target}:predict", body, headers
        )
        if (
            use_binary
            and not self._binary_confirmed
            and status in (400, 415, 501)
        ):
            # Negotiation failure: a server that never spoke a frame
            # rejected one — an old JSON-only surface. Fall back for
            # good; a genuinely bad input gets the same 4xx from the
            # JSON retry and propagates below.
            self._binary = False
            return self.predict(instances, model=model)
        if status == 429:
            raise ReplicaOverloaded(
                f"replica {self.name!r} shed the request",
                retry_after=float(retry_after or 0.05),
            )
        if status >= 500:
            self.invalidate_pool()
            raise ReplicaGone(
                f"replica {self.name!r} failed: HTTP {status}"
            )
        if status != 200:
            raise RuntimeError(
                f"replica {self.name!r} rejected the request: "
                f"HTTP {status}: {data[:200]!r}"
            )
        if wire.is_tensor_request({"content-type": content_type}):
            if use_binary:
                self._binary_confirmed = True
            return wire.decode_tensor(data)
        return np.asarray(json.loads(data)["predictions"])

    def stats(self) -> dict:
        """Honest readiness: probe ``GET /v1/models/<m>`` on the pooled
        connection instead of hardcoding ready. A wedged-but-listening
        worker (model never loaded, repository empty) now reports
        not-ready into the status aggregation instead of vanishing
        behind a hardcoded True."""
        try:
            status, _, _, _ = self._request(
                "GET", f"/v1/models/{self._model}", None, {}
            )
        except ReplicaGone:
            return {"ready": False}
        return {"ready": status == 200}


class LocalReplicaRuntime:
    """In-process replica fleet the serving controller materializes into.

    ``servable_factory(rspec)`` builds a Servable from a replica spec
    dict (`serving.__main__.build_servable_from_rspec` restores it from
    a checkpoint directory); tests pass stand-in servables.
    """

    def __init__(
        self,
        router: Router,
        servable_factory,
        metrics: MetricsRegistry | None = None,
    ):
        self.router = router
        self._factory = servable_factory
        self._metrics = metrics

    @staticmethod
    def _config(rspec: dict) -> BatchingConfig:
        """The rspec's batching knobs. The port's queue always
        late-admits, so ``batching.continuous`` is not read."""
        batching = rspec.get("batching") or {}
        return BatchingConfig(
            max_batch=int(rspec.get("maxBatch", 64)),
            timeout_ms=float(batching.get("timeoutMs", 5.0)),
            max_pending=int(batching.get("maxPending", 1024)),
        )

    def names(self) -> list[str]:
        return self.router.replica_names()

    def apply_model_policy(self, models) -> None:
        """Controller hook: push the CR catalog's admission policy
        (per-model priority class + quota buckets) onto the fleet's
        router on every reconcile."""
        self.router.set_model_policy(models)

    @staticmethod
    def model_rspec(rspec: dict, mspec: dict) -> dict:
        """Render ONE model's replica spec from the fleet rspec + its
        entry in ``models: [...]`` — the same single-model shape the
        servable factory has always consumed, so one factory serves
        both fleet flavors."""
        return {
            "model": mspec["name"],
            "maxBatch": rspec.get("maxBatch", 64),
            "batching": dict(rspec.get("batching") or {}),
            "checkpointDir": mspec.get(
                "checkpointDir", rspec.get("checkpointDir", "")
            ),
            "modelVersion": int(mspec.get("modelVersion", 0) or 0),
        }

    def ensure(self, name: str, rspec: dict) -> None:
        """Idempotent: bring the named replica up if it isn't already.
        An rspec carrying ``models: [...]`` materializes a multiplexed
        replica (ServableRegistry + LRU paging) instead of the
        single-servable shape."""
        if self.router.replica(name) is not None:
            return
        models = rspec.get("models")
        if models:
            paging = rspec.get("paging") or {}
            registry = ServableRegistry(
                self._factory,
                batching=self._config(rspec),
                paging=PagingConfig(
                    max_resident=int(paging.get("maxResident", 0) or 0)
                ),
                metrics=self._metrics,
            )
            for mspec in models:
                registry.ensure(self.model_rspec(rspec, mspec))
            self.router.add(MultiModelReplica(name, registry))
            return
        servable = self._factory(rspec)
        self.router.add(
            LocalReplica(
                name, servable, self._config(rspec), self._metrics
            )
        )

    def stop(self, name: str) -> None:
        """Scale-down teardown: drain first so in-flight work completes,
        then take the replica out of the fleet."""
        replica = self.router.replica(name)
        if replica is None:
            return
        self.router.drain(name)
        self.router.remove(name)
        replica.close()

    def roll(self, name: str, rspec: dict) -> float:
        """Drain-based hot swap to the spec's model version(s); returns
        the seconds the replica was out of rotation. On a multiplexed
        replica only the OUTDATED models reload — per-model rolls ride
        the same drain machinery, one replica at a time."""
        replica = self.router.replica(name)
        if replica is None:
            raise KeyError(f"unknown replica {name!r}")
        if isinstance(replica, MultiModelReplica):
            return self.router.roll(
                name, lambda: self._sync_models(replica, rspec)
            )
        return self.router.roll(
            name, lambda: replica.swap(self._factory(rspec))
        )

    def _sync_models(
        self, replica: MultiModelReplica, rspec: dict
    ) -> None:
        """Converge a (drained) multiplexed replica onto the rspec's
        model list: add new entries, reload models whose desired version
        moved (resident ones eagerly, paged-out ones lazily on their
        next page-in), drop models no longer listed."""
        desired = rspec.get("models") or []
        live = replica.registry.stats()["models"]
        for mspec in desired:
            mr = self.model_rspec(rspec, mspec)
            row = live.get(mspec["name"])
            want = int(mr.get("modelVersion", 0) or 0)
            if (
                row is not None
                and row["state"] == "resident"
                and want
                and row["version"] != want
            ):
                replica.roll_model(mspec["name"], mr)
            else:
                replica.registry.ensure(mr)
        keep = {m["name"] for m in desired}
        for name in replica.registry.models():
            if name not in keep:
                replica.registry.remove(name)

    def stats(self, name: str) -> dict | None:
        replica = self.router.replica(name)
        if replica is None:
            return None
        return replica.stats()
