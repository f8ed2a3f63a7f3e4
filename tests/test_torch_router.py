"""The port's drain-aware router, by the JAX package's own tests.

Every test of tests/test_serving_router.py, run against
`kubeflow_tpu_torch.serving.router` (and its admission controller) on
the same scriptable stand-in replicas: spread by least-outstanding,
idempotent retry on replica death, honest load shedding with
Retry-After, the drain / roll choreography (in-flight completes, no new
admissions, re-admit after swap, kill-mid-drain falls back to a
survivor), priority headroom, tenant and per-model quotas, and the
seeded Retry-After jitter. Then a parity test: one seeded request
sequence through both packages' routers gives the same verdicts, the
same messages and the same Retry-After values (exact: both draw the
jitter from `random.Random` with the same seed).
"""

import threading
import time

import pytest

from kubeflow_tpu_torch.serving.router import (
    NoReadyReplicas,
    Overloaded,
    ReplicaGone,
    ReplicaOverloaded,
    Router,
)


class FakeReplica:
    """Scriptable replica: gate to hold requests in flight, kill to make
    every (current and future) call die with ReplicaGone, fail_once to
    script a single scripted exception."""

    def __init__(self, name, capacity=8):
        self.name = name
        self.capacity = capacity
        self.calls = 0
        self.gate = None
        self.fail_once = None
        self._killed = threading.Event()
        self._lock = threading.Lock()

    def kill(self):
        self._killed.set()
        if self.gate is not None:
            self.gate.set()

    def predict(self, x, model=None):
        with self._lock:
            self.calls += 1
            fail, self.fail_once = self.fail_once, None
        if fail is not None:
            raise fail
        if self.gate is not None:
            self.gate.wait(10)
        if self._killed.is_set():
            raise ReplicaGone(f"{self.name} killed")
        return ("ok", self.name, x)

    def stats(self):
        return {"ready": not self._killed.is_set()}


def make_fleet(n=2, capacity=8):
    router = Router()
    replicas = [FakeReplica(f"r{i}", capacity) for i in range(n)]
    for r in replicas:
        router.add(r)
    return router, replicas


def counts(router):
    return {
        "acked": router.acked_total.value(),
        "completed": router.completed_total.value(),
        "failed": router.failed_total.value(),
        "shed": router.shed_total.value(),
    }


def test_spread_prefers_least_outstanding():
    router, (a, b) = make_fleet(2)
    a.gate = threading.Event()  # first request parks on a replica...

    t = threading.Thread(target=router.predict, args=(1,))
    t.start()
    deadline = time.monotonic() + 5
    while a.calls + b.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    busy, idle = (a, b) if a.calls else (b, a)

    idle.gate = None
    # ...so the next one lands on the idle sibling, not round-robin luck.
    _, served_by, _ = router.predict(2)
    assert served_by == idle.name
    busy.gate.set()
    t.join(timeout=5)


def test_retry_on_replica_death_idempotent():
    router, (a, b) = make_fleet(2)
    a.fail_once = ReplicaGone("connection reset")
    b.fail_once = None

    results = {router.predict(i)[1] for i in range(4)}
    # Whichever replica died, everything completed on the survivor.
    assert results  # no exception escaped
    c = counts(router)
    assert c["acked"] == 4 and c["completed"] == 4
    assert c["failed"] == 0
    assert router.retried_total.value() == 1
    # The dead replica is out of the ready set.
    assert len(router.ready_names()) == 1


def test_non_idempotent_death_fails_fast():
    router, (a, b) = make_fleet(2)
    a.fail_once = ReplicaGone("reset")
    b.fail_once = ReplicaGone("reset")
    with pytest.raises(ReplicaGone):
        router.predict(1, idempotent=False)
    c = counts(router)
    assert c["failed"] == 1 and c["completed"] == 0
    assert c["acked"] == 1  # acked, then honestly accounted as failed


def test_model_error_propagates_without_retry():
    router, (a, b) = make_fleet(2)
    a.fail_once = ValueError("bad input shape")
    b.fail_once = ValueError("bad input shape")
    with pytest.raises(ValueError):
        router.predict(1)
    # Exactly one replica executed: a request failing on its merits must
    # not burn the fleet retrying it.
    assert a.calls + b.calls == 1
    assert counts(router)["failed"] == 1


def test_no_replicas_raises_no_ready():
    router = Router()
    with pytest.raises(NoReadyReplicas):
        router.predict(1)


def test_shed_with_retry_after_when_at_capacity():
    router, (a, b) = make_fleet(2, capacity=1)
    a.gate = threading.Event()
    b.gate = threading.Event()
    threads = [
        threading.Thread(target=router.predict, args=(i,))
        for i in range(2)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while a.calls + b.calls < 2 and time.monotonic() < deadline:
        time.sleep(0.005)

    with pytest.raises(Overloaded) as exc:
        router.predict(99)
    assert exc.value.retry_after > 0
    c = counts(router)
    assert c["shed"] == 1
    assert c["acked"] == 2  # the shed request was never acknowledged
    a.gate.set()
    b.gate.set()
    for t in threads:
        t.join(timeout=5)
    assert counts(router)["completed"] == 2


def test_replica_overloaded_tries_sibling():
    router, (a, b) = make_fleet(2)
    a.fail_once = ReplicaOverloaded("queue full")
    b.fail_once = ReplicaOverloaded("queue full")
    # One of them refuses; the other (whose fail already fired or not)
    # may refuse too — but a second pass succeeds within the deadline.
    assert router.predict(1)[0] == "ok"
    assert counts(router)["failed"] == 0


# -- the drain matrix -------------------------------------------------------


def test_drain_waits_for_inflight_then_blocks_admission():
    router, (a, b) = make_fleet(2)
    a.gate = threading.Event()
    t = threading.Thread(target=router.predict, args=(1,))
    t.start()
    deadline = time.monotonic() + 5
    while a.calls + b.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    busy, other = (a, b) if a.calls else (b, a)

    drained = []
    dt = threading.Thread(
        target=lambda: drained.append(router.drain(busy.name, timeout=10))
    )
    dt.start()
    time.sleep(0.05)
    assert not drained  # in-flight work pins the drain

    # No new admissions to the draining replica: traffic flows to the
    # sibling the whole time.
    before = busy.calls
    for i in range(3):
        assert router.predict(i)[1] == other.name
    assert busy.calls == before

    busy.gate.set()  # in-flight request completes...
    dt.join(timeout=5)
    assert drained == [True]  # ...and the drain observes it
    assert counts(router)["failed"] == 0


def test_roll_swaps_quiesced_and_readmits():
    router, (a, b) = make_fleet(2)
    a.gate = threading.Event()
    t = threading.Thread(target=router.predict, args=(1,))
    t.start()
    deadline = time.monotonic() + 5
    while a.calls + b.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    busy = a if a.calls else b

    quiesced = []

    def swap():
        # Router.roll's contract: swap_fn runs with zero in-flight work.
        quiesced.append(router.stats()["replicas"][busy.name]["outstanding"])

    threading.Timer(0.05, busy.gate.set).start()
    out_of_rotation = router.roll(busy.name, swap, timeout=10)
    t.join(timeout=5)
    assert quiesced == [0]
    assert out_of_rotation >= 0.0
    # Re-admitted: the rolled replica serves traffic again.
    assert busy.name in router.ready_names()
    busy.gate = None
    served = {router.predict(i)[1] for i in range(8)}
    assert busy.name in served


def test_kill_mid_drain_falls_back_to_survivor():
    router, (a, b) = make_fleet(2)
    a.gate = threading.Event()
    results = []
    t = threading.Thread(
        target=lambda: results.append(router.predict(1))
    )
    t.start()
    deadline = time.monotonic() + 5
    while a.calls + b.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    busy, other = (a, b) if a.calls else (b, a)
    other.gate = None

    drained = []
    dt = threading.Thread(
        target=lambda: drained.append(router.drain(busy.name, timeout=10))
    )
    dt.start()
    time.sleep(0.05)
    busy.kill()  # SIGKILL mid-drain: in-flight dies with ReplicaGone

    t.join(timeout=5)
    dt.join(timeout=5)
    # The in-flight request failed over to the survivor — acked work is
    # never dropped — and the drain still completed.
    assert results and results[0][1] == other.name
    assert drained == [True]
    c = counts(router)
    assert c["acked"] == c["completed"] == 1
    assert c["failed"] == 0
    assert router.retried_total.value() == 1


def test_all_draining_is_overloaded_not_dead():
    router, (a, b) = make_fleet(2)
    router.drain(a.name, timeout=1)
    router.drain(b.name, timeout=1)
    with pytest.raises(Overloaded):
        router.predict(1)
    router.admit(a.name)
    assert router.predict(1)[0] == "ok"


# -- priority admission + quotas + jittered backoff ---------------------------


def test_unknown_priority_class_is_value_error():
    from kubeflow_tpu_torch.serving import AdmissionController

    router, _ = make_fleet(n=1)
    router.admission = AdmissionController()
    with pytest.raises(ValueError, match="unknown priority"):
        router.predict("x", priority="vip")


def test_batch_sheds_at_its_ceiling_while_critical_passes():
    """Headroom ladder: with fleet occupancy parked at the batch
    ceiling (0.5x slots), batch sheds pre-ack while critical still
    dispatches — the reserved slots are critical's to spend."""
    from kubeflow_tpu_torch.serving import AdmissionController

    router, replicas = make_fleet(n=1, capacity=8)
    router.admission = AdmissionController()
    gate = threading.Event()
    replicas[0].gate = gate
    holders = [
        threading.Thread(target=lambda: router.predict("x"))
        for _ in range(4)
    ]
    try:
        for t in holders:
            t.start()
        deadline = time.monotonic() + 5
        while (
            router.stats()["outstanding"] < 4
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        assert router.stats()["outstanding"] == 4  # == 0.5 * 8 slots

        shed_before = counts(router)["shed"]
        with pytest.raises(Overloaded) as excinfo:
            router.predict("x", priority="batch")
        assert "headroom" in str(excinfo.value)
        assert excinfo.value.retry_after > 0
        after = counts(router)
        assert after["shed"] == shed_before + 1
        # An honest shed is never acked.
        assert after["acked"] == 4

        done = []
        t = threading.Thread(
            target=lambda: done.append(
                router.predict("x", priority="critical")
            )
        )
        t.start()
        time.sleep(0.1)
        gate.set()
        t.join(timeout=10)
        assert done and done[0][0] == "ok"
    finally:
        gate.set()
        for t in holders:
            t.join(timeout=10)


def test_tenant_quota_bucket_charges_once_per_request():
    """Token-bucket quota: burst tokens spend one per REQUEST — a
    dispatch retry after a replica death must not double-charge — and
    an empty bucket sheds with a time-to-next-token hint."""
    from kubeflow_tpu_torch.serving import AdmissionController, QuotaSpec

    clock = [100.0]
    admission = AdmissionController(
        quotas={"acme": QuotaSpec(rate=1.0, burst=2.0)},
        clock=lambda: clock[0],
    )
    router, replicas = make_fleet(n=2)
    router.admission = admission

    # First request eats a token AND a dispatch retry (replica death
    # mid-flight, respread to the survivor) — still one token.
    replicas[0].fail_once = ReplicaGone("boom")
    replicas[1].fail_once = ReplicaOverloaded("full")
    out = router.predict("x", tenant="acme")
    assert out[0] == "ok"
    router.predict("x", tenant="acme")  # second token
    with pytest.raises(Overloaded) as excinfo:
        router.predict("x", tenant="acme")
    assert "over quota" in str(excinfo.value)
    # Hint ~1s to the next token, spread [0.5, 1.5]x by the jitter.
    assert 0.4 <= excinfo.value.retry_after <= 1.6

    clock[0] += 1.0  # refill exactly one token
    router.predict("x", tenant="acme")
    with pytest.raises(Overloaded):
        router.predict("x", tenant="acme")
    # Untenanted traffic is uncapped throughout.
    assert router.predict("x")[0] == "ok"


def test_retry_after_jitter_is_seeded_and_spread():
    """Shed hints are deterministic per seed (chaos replays) but spread
    across [0.5, 1.5]x base (no synchronized retry wave)."""

    def shed_sequence(seed, n=8):
        router = Router(retry_jitter_seed=seed)
        hints = []
        for _ in range(n):
            try:
                router.predict("x")
            except NoReadyReplicas:
                pass
            try:
                raise Overloaded("probe", retry_after=router._retry_hint())
            except Overloaded as e:
                hints.append(e.retry_after)
        return hints

    a, b, c = shed_sequence(7), shed_sequence(7), shed_sequence(11)
    assert a == b  # same seed -> same schedule
    assert a != c
    base = Router().retry_after_s
    assert all(0.5 * base <= h <= 1.5 * base for h in a)
    spread = max(a) - min(a)
    assert spread > 0.1 * base  # actually jittered, not constant


def test_model_policy_wires_catalog_quota_and_priority():
    """CR catalog → router: `set_model_policy` turns models[].quotaRate
    into a live per-model bucket (key "model:<name>") and models[].
    priority into the default class for requests that name none — the
    wiring the ServingDeployment controller pushes on every reconcile,
    so a quotaRate in the CR is enforcement, not decoration."""
    from kubeflow_tpu.api.serving import ModelEntry  # a catalog row (no JAX)

    clock = [100.0]
    router, _ = make_fleet(n=2)
    router.set_model_policy([
        ModelEntry("alpha", quota_rate=1.0, quota_burst=2.0),
        ModelEntry("beta", priority="batch"),
    ])
    assert router.admission is not None
    router.admission._clock = lambda: clock[0]
    # Re-stamp the bucket onto the injected clock.
    router.admission.set_quota(
        "model:alpha", router.admission.quotas["model:alpha"]
    )

    router.predict("x", model="alpha")
    router.predict("x", model="alpha")  # burst spent
    with pytest.raises(Overloaded) as excinfo:
        router.predict("x", model="alpha")
    assert "over quota" in str(excinfo.value)
    router.predict("x", model="beta")  # no quota on beta

    # Resync idempotence: an unchanged catalog must NOT refill the
    # bucket (set_quota would re-grant the burst every 50ms resync).
    router.set_model_policy([
        ModelEntry("alpha", quota_rate=1.0, quota_burst=2.0),
        ModelEntry("beta", priority="batch"),
    ])
    with pytest.raises(Overloaded):
        router.predict("x", model="alpha")

    # priority=None defers to the catalog class; beta declared "batch",
    # which check_priority sheds first under pressure — here just pin
    # that the resolved class reaches the headroom gate (unknown class
    # would raise ValueError, "standard" fallback for alpha).
    router.predict("x", model="beta", priority=None)
    clock[0] += 10.0
    router.predict("x", model="alpha", priority=None)

    # Dropping the quota from the catalog removes the bucket.
    router.set_model_policy([ModelEntry("alpha"), ModelEntry("beta")])
    assert "model:alpha" not in router.admission.quotas
    for _ in range(5):
        router.predict("x", model="alpha")


def test_model_quota_shed_refunds_tenant_token():
    """All-or-nothing multi-bucket charge: when the model bucket sheds,
    the tenant token charged first is refunded — a capped model must
    not silently drain its tenants' quotas."""
    from kubeflow_tpu_torch.serving import AdmissionController, QuotaSpec

    clock = [100.0]
    admission = AdmissionController(
        quotas={
            "acme": QuotaSpec(rate=1.0, burst=5.0),
            "model:m": QuotaSpec(rate=0.001, burst=1.0),
        },
        clock=lambda: clock[0],
    )
    router, _ = make_fleet(n=2)
    router.admission = admission

    router.predict("x", model="m", tenant="acme")  # spends both
    for _ in range(3):  # model bucket empty; tenant must NOT drain
        with pytest.raises(Overloaded) as excinfo:
            router.predict("x", model="m", tenant="acme")
        assert "model:m" in str(excinfo.value)
    # 4 tenant tokens remain: all spent on an uncapped model.
    for _ in range(4):
        router.predict("x", model="other", tenant="acme")
    with pytest.raises(Overloaded) as excinfo:
        router.predict("x", model="other", tenant="acme")
    assert "'acme' over quota" in str(excinfo.value)


# -- parity with the JAX package's router --------------------------------------


def _router_trace(pkg: str, seed: int) -> list:
    """One seeded request sequence through `pkg`'s router ("jax" or
    "torch"): tenants and per-model quotas on an injected clock, four
    priority classes (one unknown), replica deaths and refusals retried
    on a sibling, drains that leave no replica admitting, and nested
    requests issued from inside a replica (so that one and two requests
    are outstanding: the batch ceiling and the capacity shed). Returns
    each request's verdict: the result, or the error's type, message and
    Retry-After."""
    import random

    if pkg == "jax":
        from kubeflow_tpu.serving import admission as adm
        from kubeflow_tpu.serving import router as rt
    else:
        from kubeflow_tpu_torch.serving import admission as adm
        from kubeflow_tpu_torch.serving import router as rt

    clock = [100.0]
    admission = adm.AdmissionController(
        quotas={"acme": adm.QuotaSpec(rate=2.0, burst=3.0),
                "model:m1": adm.QuotaSpec(rate=0.5, burst=1.0)},
        clock=lambda: clock[0],
    )
    router = rt.Router(admission=admission, retry_jitter_seed=seed,
                       dispatch_timeout_s=0.0)
    rng = random.Random(seed)
    trace: list = []

    def request(tenant, model, priority, depth):
        try:
            result = router.predict(
                (depth, tenant, model, priority), model=model,
                priority=priority, tenant=tenant,
            )
            return ("ok", result)
        except rt.Overloaded as e:
            return ("shed", str(e), e.retry_after)
        except (rt.NoReadyReplicas, rt.ReplicaGone, ValueError) as e:
            return (type(e).__name__, str(e))

    class Replica:
        def __init__(self, name):
            self.name, self.capacity, self.script = name, 1, []

        def predict(self, x, model=None):
            if self.script:
                raise self.script.pop(0)
            depth, tenant, _, _ = x
            if depth > 0:
                # Issued while this request is outstanding.
                inner = rng.choice(["critical", "standard", "batch"])
                trace.append(("inner", inner,
                              request(tenant, "m0", inner, depth - 1)))
            return (self.name, model)

    replicas = [Replica("r0"), Replica("r1")]
    for r in replicas:
        router.add(r)
    for _ in range(120):
        clock[0] += rng.choice([0.0, 0.1, 0.5, 2.0])
        event = rng.random()
        if event < 0.05:
            for r in replicas:
                router.drain(r.name)
            trace.append(("drained",))
        elif event < 0.15:
            for r in replicas:
                router.admit(r.name)
            trace.append(("admitted",))
        elif event < 0.25:
            victim = rng.choice(replicas)
            victim.script.append(rng.choice(
                [rt.ReplicaGone("died"), rt.ReplicaOverloaded("full", 0.3)]))
        trace.append(request(
            rng.choice([None, "acme", "other"]), rng.choice(["m0", "m1"]),
            rng.choice(["critical", "standard", "batch", "vip", None]),
            rng.choice([0, 0, 1, 2]),
        ))
    trace.append({"acked": router.acked_total.value(),
                  "completed": router.completed_total.value(),
                  "failed": router.failed_total.value(),
                  "shed": router.shed_total.value(),
                  "retried": router.retried_total.value()})
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_requests_same_verdicts_as_the_jax_router(seed):
    jax_trace = _router_trace("jax", seed)
    torch_trace = _router_trace("torch", seed)
    assert torch_trace == jax_trace
    verdicts = {v[0] for v in jax_trace if isinstance(v, tuple)}
    # The sequence reaches every verdict it is there to compare.
    assert {"ok", "shed", "ValueError", "inner", "drained"} <= verdicts
    assert any(v[0] == "shed" and v[2] > 0 for v in jax_trace
               if isinstance(v, tuple))
