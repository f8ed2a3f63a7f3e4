"""The port's replica adapters and replica runtime.

`HttpReplica`, by the pooled-transport tests of tests/test_serving_wire.py,
against the port's `ModelServerApp` (a `tiny_resnet` on the CPU) served
on a localhost port: the keep-alive pool actually pools, a stale idle
socket is silently replaced (pre-write only), a failure after bytes hit
the wire raises ReplicaGone and invalidates the pool, readiness is
probed, and a JSON-only server triggers the sticky negotiation fallback.

Then `LocalReplica`, `MultiModelReplica` and `LocalReplicaRuntime` (the
same rspec operations through both packages' runtimes give the same
fleet state), and `ReplicaKillSchedule` (both packages draw the same
plan from a seed; the JAX package's own test of it, against the port's).
"""

import http.client
import socket
import threading

import numpy as np
import pytest

from kubeflow_tpu_torch.models.resnet import tiny_resnet
from kubeflow_tpu_torch.serving import (
    BatchingConfig,
    LocalReplica,
    LocalReplicaRuntime,
    ModelNotFound,
    ModelRepository,
    ModelServerApp,
    MultiModelReplica,
    ReplicaGone,
    Router,
    Servable,
)
from kubeflow_tpu_torch.serving.replica import HttpReplica
from kubeflow_tpu_torch.web import App, HttpError, json_response
from kubeflow_tpu_torch.web.wsgi import serve


@pytest.fixture(scope="module")
def app():
    servable = Servable.from_module(
        "mnist", tiny_resnet(num_classes=10, device="cpu"), max_batch=8, device="cpu")
    return ModelServerApp(ModelRepository([servable]))


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 32, 32, 3).astype(np.float32)


# -- pooled transport over a real server (tests/test_serving_wire.py) --------


@pytest.fixture()
def live_server(app):
    server, thread = serve(app, host="127.0.0.1", port=0)
    try:
        yield f"127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_pool_reuses_one_connection(live_server):
    replica = HttpReplica("r", live_server, "mnist")
    x = _batch(1)
    for _ in range(10):
        out = replica.predict(x)
        assert out.shape == (1, 10)
    stats = replica.transport_stats()
    assert stats["dials"] == 1, stats  # conn-per-request would dial 10x
    assert replica._binary_confirmed  # frames negotiated, not JSON
    replica.close()


def test_stale_idle_socket_replaced_prewrite(live_server):
    """An idle pooled socket the peer closed (readable EOF before any
    request bytes) is silently discarded and redialed — NOT surfaced as
    ReplicaGone, because nothing was ever sent on it."""
    replica = HttpReplica("r", live_server, "mnist")
    a, b = socket.socketpair()
    dead = http.client.HTTPConnection("127.0.0.1", 1)
    dead.sock = a
    b.close()  # EOF pending on a -> checkout must reject it
    with replica._pool_lock:
        replica._idle.append(dead)
    out = replica.predict(_batch(1))
    assert out.shape == (1, 10)
    assert replica.transport_stats()["generation"] == 0  # no death signal
    replica.close()


def test_failure_after_bytes_is_replica_gone():
    """A peer that accepts, reads, and resets mid-exchange is a dead
    replica: ReplicaGone (no transparent retry), pool invalidated."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    port = lst.getsockname()[1]

    def acceptor():
        try:
            while True:
                conn, _ = lst.accept()
                conn.close()  # reset after the request is written
        except OSError:
            pass

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()
    replica = HttpReplica("r", f"127.0.0.1:{port}", "mnist", timeout=5.0)
    try:
        with pytest.raises(ReplicaGone):
            replica.predict(_batch(1))
        assert replica.transport_stats()["generation"] >= 1
        assert replica.transport_stats()["idle"] == 0
    finally:
        lst.close()
        replica.close()


def test_stats_probes_model_state(live_server):
    assert HttpReplica("r", live_server, "mnist").stats() == {
        "ready": True
    }
    # Listening but not serving this model: wedged, not ready — the
    # seed hardcoded {"ready": True} here.
    assert HttpReplica("r", live_server, "absent").stats() == {
        "ready": False
    }


def test_stats_dead_endpoint_not_ready():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    replica = HttpReplica("r", f"127.0.0.1:{port}", "mnist", timeout=2.0)
    assert replica.stats() == {"ready": False}


def test_json_only_server_sticky_fallback():
    """A server that 4xx's tensor frames (the pre-protocol surface) is
    detected on the first exchange; the replica drops to JSON for good
    and the request still succeeds."""

    legacy = App("legacy-model-server")

    def old_predict(req):
        if "json" not in (req.headers.get("content-type") or ""):
            raise HttpError(400, "expected JSON")
        n = len(req.json()["instances"])
        return json_response({"predictions": [[0.0]] * n})

    legacy.add_route("/v1/models/<name>", old_predict, ("POST",))

    server, thread = serve(legacy, host="127.0.0.1", port=0)
    try:
        replica = HttpReplica(
            "r", f"127.0.0.1:{server.server_port}", "mnist:predict"
        )
        out = replica.predict(_batch(2))
        assert out.shape == (2, 1)
        assert replica._binary is False  # sticky: no frame retry per call
        replica.close()
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_router_drain_invalidates_pool():
    calls = []

    class FakeReplica:
        name, capacity = "f", 4

        def predict(self, x):
            return np.asarray(x)

        def invalidate_pool(self):
            calls.append("invalidate")

    router = Router()
    router.add(FakeReplica())
    assert router.drain("f")
    assert calls == ["invalidate"]


# -- in-process replicas and the runtime -------------------------------------


class Doubler:
    def __init__(self, name, version=1):
        self.name, self.version = name, version

    def predict(self, instances):
        return np.asarray(instances, dtype=np.float32) * 2.0


def test_local_replica_serves_swaps_and_dies():
    replica = LocalReplica("r", Doubler("m"), BatchingConfig(max_batch=4, timeout_ms=1.0))
    try:
        x = np.ones((2, 3), np.float32)
        np.testing.assert_array_equal(replica.predict(x), 2 * x)
        np.testing.assert_array_equal(replica.predict(x, model="m"), 2 * x)
        with pytest.raises(ModelNotFound):
            replica.predict(x, model="other")
        replica.swap(Doubler("m", version=2))
        assert replica.version == 2 and replica.stats()["version"] == 2
        assert replica.ready
        replica.kill()
        assert not replica.ready
        with pytest.raises(ReplicaGone):
            replica.predict(x)
    finally:
        replica.close()


def _fleet_rspec(versions: dict, max_resident=2) -> dict:
    return {
        "maxBatch": 4, "batching": {"timeoutMs": 1.0, "maxPending": 64},
        "models": [{"name": n, "modelVersion": v} for n, v in versions.items()],
        "paging": {"maxResident": max_resident},
    }


def _runtime_trace(pkg: str) -> list:
    """One sequence of runtime operations through `pkg`'s ("jax" or
    "torch") `LocalReplicaRuntime` over a recording factory: bring two
    multiplexed replicas up, serve, roll a version bump and a catalog
    change, kill one replica, stop the other. Returns the builds and
    each step's per-replica model states."""
    if pkg == "jax":
        from kubeflow_tpu.serving import replica as rp
        from kubeflow_tpu.serving import router as rt
    else:
        from kubeflow_tpu_torch.serving import replica as rp
        from kubeflow_tpu_torch.serving import router as rt

    builds = []

    def factory(rspec):
        builds.append((rspec["model"], rspec["modelVersion"], rspec["maxBatch"]))
        return Doubler(rspec["model"], rspec["modelVersion"])

    router = rt.Router(retry_jitter_seed=0)
    runtime = rp.LocalReplicaRuntime(router, factory)
    trace = []

    def snapshot(what):
        rows = {}
        for name in runtime.names():
            stats = runtime.stats(name)
            rows[name] = {m: (r["state"], r["version"], r["page_ins"])
                          for m, r in stats["models"].items()}
        trace.append((what, list(builds), rows, router.ready_names()))

    x = np.ones((1, 2), np.float32)
    rspec = _fleet_rspec({"a": 1, "b": 1, "c": 1})
    for name in ("r0", "r1"):
        runtime.ensure(name, rspec)
        runtime.ensure(name, rspec)  # idempotent
    snapshot("up")
    for model in ("a", "b", "c", "a"):
        router.predict(x, model=model)
    snapshot("served")
    runtime.roll("r0", _fleet_rspec({"a": 2, "b": 1, "c": 7}))
    snapshot("rolled a and c")
    runtime.roll("r0", _fleet_rspec({"a": 2, "d": 1}))
    snapshot("b and c dropped, d added")
    router.predict(x, model="d")
    snapshot("served d")
    router.replica("r0").kill()
    router.predict(x, model="a")  # retried on r1
    snapshot("r0 killed")
    runtime.stop("r1")
    snapshot("r1 stopped")
    return trace


def test_runtime_converges_as_the_jax_runtime():
    jax_trace = _runtime_trace("jax")
    assert _runtime_trace("torch") == jax_trace
    # The roll reloaded only the resident, outdated model and dropped
    # what left the catalog.
    rolled = dict(jax_trace[2][2]["r0"])
    assert rolled["a"] == ("resident", 2, 3)  # paged in twice, then rolled
    assert jax_trace[3][2]["r0"].keys() == {"a", "d"}


def test_runtime_single_model_replica_rolls_by_swap():
    router = Router()
    runtime = LocalReplicaRuntime(router, lambda rspec: Doubler(
        rspec["model"], rspec.get("modelVersion", 1)))
    runtime.ensure("solo", {"model": "m", "modelVersion": 1, "maxBatch": 4})
    try:
        assert isinstance(router.replica("solo"), LocalReplica)
        np.testing.assert_array_equal(
            router.predict(np.ones((1, 2), np.float32)), 2 * np.ones((1, 2)))
        assert runtime.roll("solo", {"model": "m", "modelVersion": 5}) >= 0.0
        assert runtime.stats("solo")["version"] == 5
        assert router.ready_names() == ["solo"]
    finally:
        runtime.stop("solo")
    assert runtime.stats("solo") is None and runtime.names() == []


def test_multimodel_replica_needs_a_model_and_maps_errors():
    from kubeflow_tpu_torch.serving import PagingConfig, ServableRegistry

    registry = ServableRegistry(lambda rspec: Doubler(rspec["model"]),
                                batching=BatchingConfig(max_batch=4, timeout_ms=1.0),
                                paging=PagingConfig(max_resident=1))
    replica = MultiModelReplica("mm", registry)
    try:
        registry.ensure({"model": "a"})
        x = np.ones((1, 2), np.float32)
        np.testing.assert_array_equal(replica.predict(x), 2 * x)  # the only model
        registry.ensure({"model": "b"})
        with pytest.raises(ModelNotFound):
            replica.predict(x)  # two models: which?
        with pytest.raises(ModelNotFound):
            replica.predict(x, model="ghost")
        replica.predict(x, model="b")
        stats = replica.stats()
        assert stats["resident"] == 1 and stats["ready"]
        assert replica.capacity == registry.batching.max_pending
        replica.kill()
        with pytest.raises(ReplicaGone):
            replica.predict(x, model="a")
        assert not replica.ready
    finally:
        replica.close()


# -- the replica-kill plan ------------------------------------------------------


def test_replica_kill_schedule_reproducible_and_coverage_honest():
    """tests/test_chaos.py's test of the plan, against the port's copy:
    same seed → identical plan; kills fire only when the load fraction
    passes their trigger; coverage counts landed kills only."""
    from kubeflow_tpu_torch.testing.chaos import ReplicaKill, ReplicaKillSchedule

    a = ReplicaKillSchedule(97, kills=3, replicas=4)
    b = ReplicaKillSchedule(97, kills=3, replicas=4)
    assert a.plan == b.plan
    assert len(a.plan) == 3
    fractions = [k.at_fraction for k in a.plan]
    assert fractions == sorted(fractions)
    assert all(0.2 <= f <= 0.7 for f in fractions)
    assert all(0 <= k.victim < 4 for k in a.plan)
    assert ReplicaKillSchedule(98, kills=3, replicas=4).plan != a.plan

    assert a.due(0.0) is None
    first = a.due(a.plan[0].at_fraction + 0.01)
    assert first == a.plan[0]
    assert a.coverage() == {"replica_kill": 0}
    a.mark_injected(first)
    assert a.coverage() == {"replica_kill": 1}
    assert not a.exhausted
    assert a.due(1.0) == a.plan[1]
    assert a.due(1.0) == a.plan[2]
    assert a.due(1.0) is None
    assert a.exhausted

    targeted = ReplicaKillSchedule.from_plan(
        [ReplicaKill("replica_kill", 0.5, 1)]
    )
    assert targeted.due(0.4) is None
    assert targeted.due(0.6).victim == 1


@pytest.mark.parametrize("seed,kills,replicas", [(0, 1, 2), (7, 3, 4), (12345, 5, 3)])
def test_kill_plan_is_the_jax_plan(seed, kills, replicas):
    from kubeflow_tpu.testing import chaos as jax_chaos
    from kubeflow_tpu_torch.testing import chaos

    want = jax_chaos.ReplicaKillSchedule(seed, kills=kills, replicas=replicas).plan
    got = chaos.ReplicaKillSchedule(seed, kills=kills, replicas=replicas).plan
    assert [(k.cls, k.at_fraction, k.victim) for k in got] == [
        (k.cls, k.at_fraction, k.victim) for k in want]
