"""The port's batching scheduler, by the JAX package's own tests.

Every test of tests/test_serving_batching.py that needs no
`ServableRegistry` (all but the two per-model isolation tests), run
against `kubeflow_tpu_torch.serving`'s `BatchingQueue` and
`ModelServerApp(batching=...)` on the same stand-in servables: concurrent
callers share one execution, each gets exactly its rows, the timeout
bounds latency, errors stay inside their flush, backpressure rejects
(429 with Retry-After at the server), continuous batching admits late
arrivals, and `kill()` strands no caller. Plus one parity test that runs
the same concurrent traffic through both packages' queues.
"""

import threading
import time

import numpy as np
import pytest

from kubeflow_tpu.serving import batching as jax_batching
from kubeflow_tpu_torch.serving import (
    BatchingConfig,
    BatchingQueue,
    ModelRepository,
    ModelServerApp,
    QueueClosed,
    QueueFull,
    Servable,
)
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import TestClient
from test_torch_serving import TOL as LM_TOL  # noqa: E402
from test_torch_serving import _instances as _lm_instances  # noqa: E402
from test_torch_serving import _last_logits  # noqa: E402
from test_torch_serving import models  # noqa: E402,F401 (a fixture)


class CountingServable:
    """Identity 'model' that records every underlying execution."""

    name = "ident"
    version = 1

    def __init__(self, fail_batches=()):
        self.calls: list[int] = []
        self.fail_batches = set(fail_batches)
        self._lock = threading.Lock()

    def predict(self, instances):
        batch = np.asarray(instances)
        with self._lock:
            self.calls.append(batch.shape[0])
            if len(self.calls) - 1 in self.fail_batches:
                raise RuntimeError("injected device fault")
        return batch * 2.0


def _concurrent(queue, inputs):
    """Submit each input from its own thread; return results in order."""
    results = [None] * len(inputs)
    errors = [None] * len(inputs)

    def call(i):
        try:
            results[i] = queue.predict(inputs[i])
        except BaseException as e:
            errors[i] = e

    threads = [
        threading.Thread(target=call, args=(i,)) for i in range(len(inputs))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results, errors


def test_concurrent_singles_share_one_execution():
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=8, timeout_ms=50.0)
    )
    try:
        inputs = [np.full((1, 4), float(i)) for i in range(8)]
        results, errors = _concurrent(queue, inputs)
        assert errors == [None] * 8
        # Everyone got exactly their own rows back.
        for i, out in enumerate(results):
            np.testing.assert_array_equal(out, np.full((1, 4), 2.0 * i))
        # ...via far fewer device executions than callers (a full batch
        # flushes as one; stragglers may ride a second flush).
        assert len(model.calls) <= 2, model.calls
        assert sum(model.calls) == 8
    finally:
        queue.close()


def test_timeout_flushes_partial_batch():
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=64, timeout_ms=30.0)
    )
    try:
        t0 = time.monotonic()
        out = queue.predict(np.ones((2, 3)))
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(out, 2 * np.ones((2, 3)))
        # Flushed by the window, not by filling 64.
        assert elapsed < 5.0
        assert model.calls == [2]
    finally:
        queue.close()


def test_multi_instance_requests_batch_and_split():
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=8, timeout_ms=50.0)
    )
    try:
        inputs = [np.full((n, 2), float(n)) for n in (3, 2, 3)]
        results, errors = _concurrent(queue, inputs)
        assert errors == [None] * 3
        for n, out in zip((3, 2, 3), results):
            assert out.shape == (n, 2)
            np.testing.assert_array_equal(out, np.full((n, 2), 2.0 * n))
        assert sum(model.calls) == 8
    finally:
        queue.close()


def test_error_contained_to_its_flush():
    model = CountingServable(fail_batches={0})
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=4, timeout_ms=20.0)
    )
    try:
        _, errors = _concurrent(
            queue, [np.ones((1, 2)) for _ in range(4)]
        )
        assert all(isinstance(e, RuntimeError) for e in errors)
        # The queue survives: the NEXT flush succeeds.
        out = queue.predict(np.ones((1, 2)))
        np.testing.assert_array_equal(out, 2 * np.ones((1, 2)))
    finally:
        queue.close()


def test_backpressure_rejects_when_full():
    gate = threading.Event()

    class SlowServable(CountingServable):
        def predict(self, instances):
            gate.wait(10)
            return super().predict(instances)

    model = SlowServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=2, timeout_ms=1.0, max_pending=4)
    )
    try:
        # Fill the in-flight flush (2) + the pending queue (4), then one
        # more must bounce.
        threads = []
        for _ in range(6):
            t = threading.Thread(
                target=lambda: queue.predict(np.ones((1, 1)))
            )
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 5
        while queue._pending_count < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(QueueFull):
            queue.predict(np.ones((1, 1)))
        gate.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        gate.set()
        queue.close()


def test_oversized_request_passes_through():
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=4, timeout_ms=5.0, max_pending=64)
    )
    try:
        out = queue.predict(np.ones((11, 2)))
        assert out.shape == (11, 2)
    finally:
        queue.close()


def test_server_routes_predict_through_batcher():
    """HTTP tier: concurrent posts to :predict share executions, and the
    batcher's metrics are exposed on /metrics."""
    model = CountingServable()
    repo = ModelRepository([model])
    app = ModelServerApp(
        repo, batching=BatchingConfig(max_batch=8, timeout_ms=50.0)
    )
    client = TestClient(app)
    try:
        outs = [None] * 8

        def post(i):
            outs[i] = client.post(
                "/v1/models/ident:predict",
                {"instances": [[float(i), 0.0]]},
            )

        threads = [
            threading.Thread(target=post, args=(i,)) for i in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i, resp in enumerate(outs):
            assert resp.status == 200, resp.body
            assert resp.json()["predictions"] == [[2.0 * i, 0.0]]
        assert len(model.calls) <= 2, model.calls
        metrics = client.get("/metrics").body.decode()
        assert "serving_batches_total" in metrics
    finally:
        app.close_batchers()


def test_server_without_batching_is_direct():
    model = CountingServable()
    app = ModelServerApp(ModelRepository([model]))
    client = TestClient(app)
    assert client.post(
        "/v1/models/ident:predict", {"instances": [[1.0]]}
    ).status == 200
    assert model.calls == [1]


def test_mixed_signatures_grouped_not_failed():
    """A flush holding incompatible shapes runs one execution per
    signature group — a client's odd shape never fails its neighbors
    (TF-Serving batches per signature the same way)."""
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=8, timeout_ms=50.0)
    )
    try:
        inputs = [
            np.ones((1, 2)), np.ones((1, 3)), np.ones((1, 2)) * 5,
        ]
        results, errors = _concurrent(queue, inputs)
        assert errors == [None] * 3, errors
        assert results[0].shape == (1, 2)
        assert results[1].shape == (1, 3)
        np.testing.assert_array_equal(results[2], np.full((1, 2), 10.0))
        # Two signature groups → at most 2 executions (maybe split by
        # timing, but never a crash or cross-failure).
        assert sum(model.calls) == 3
    finally:
        queue.close()


def test_oversized_request_admitted_when_idle():
    """Backpressure gates on what's already queued: a request larger
    than max_pending on an idle server is admitted and chunked, not
    bounced into a futile retry loop."""
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=4, timeout_ms=5.0, max_pending=8)
    )
    try:
        out = queue.predict(np.ones((20, 2)))
        assert out.shape == (20, 2)
    finally:
        queue.close()


def test_closed_queue_raises_queue_closed():
    model = CountingServable()
    queue = BatchingQueue(model, BatchingConfig(timeout_ms=1.0))
    queue.close()
    with pytest.raises(QueueClosed):
        queue.predict(np.ones((1, 1)))


def test_reload_swaps_queue_to_current_generation():
    """The repository is the authority: after a same-version reload the
    batcher serves the NEW servable, and the old generation's queue is
    replaced exactly once (no ping-pong)."""
    gen1, gen2 = CountingServable(), CountingServable()
    repo = ModelRepository([gen1])
    app = ModelServerApp(
        repo, batching=BatchingConfig(max_batch=4, timeout_ms=5.0)
    )
    client = TestClient(app)
    try:
        assert client.post(
            "/v1/models/ident:predict", {"instances": [[1.0]]}
        ).status == 200
        assert sum(gen1.calls) == 1

        repo.load(gen2)  # same name/version: a rollout reload
        assert client.post(
            "/v1/models/ident:predict", {"instances": [[1.0]]}
        ).status == 200
        assert sum(gen2.calls) == 1  # served by the new generation
        assert sum(gen1.calls) == 1  # old one never touched again
        assert app._batchers[("ident", 1)].servable is gen2
    finally:
        app.close_batchers()


class GatedServable(CountingServable):
    """Blocks executions of a chosen signature until released — the
    choreography hook for deterministic continuous-batching tests."""

    def __init__(self, gate_width):
        super().__init__()
        self.gate = threading.Event()
        self.gate_width = gate_width
        self.shapes: list[tuple] = []

    def predict(self, instances):
        batch = np.asarray(instances)
        with self._lock:
            self.shapes.append(batch.shape)
        if batch.shape[1] == self.gate_width:
            self.gate.wait(10)
        return batch * 2.0


def _drive_continuous():
    """Two-signature choreography: a gated width-2 group executes while
    a width-3 request arrives AFTER the cut — continuous batching has
    the width-3 group about to run admit it late (one (2, 3) call)."""
    model = GatedServable(gate_width=2)
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=2, timeout_ms=2000.0)
    )
    try:
        results, errors = [None] * 3, [None] * 3

        def call(i, x):
            try:
                results[i] = queue.predict(x)
            except BaseException as e:  # pragma: no cover - diagnostics
                errors[i] = e

        t_x = threading.Thread(target=call, args=(0, np.ones((1, 2))))
        t_x.start()
        deadline = time.monotonic() + 5
        while queue._pending_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        t_y1 = threading.Thread(target=call, args=(1, np.ones((1, 3))))
        t_y1.start()  # rows hit max_batch → cut {x, y1}
        while (
            not any(s[1] == 2 for s in model.shapes)
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        # The flush is executing (width-2 gated); y2 arrives post-cut.
        t_y2 = threading.Thread(target=call, args=(2, np.ones((1, 3))))
        t_y2.start()
        while queue._pending_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        model.gate.set()
        for t in (t_x, t_y1, t_y2):
            t.join(timeout=10)
        assert errors == [None] * 3, errors
        for r in results:
            assert r is not None
        return model.shapes
    finally:
        model.gate.set()
        queue.close()


def test_continuous_batching_admits_late_arrival():
    shapes = _drive_continuous()
    # y1 + late-admitted y2 merged into one width-3 execution.
    assert (2, 3) in shapes, shapes


def test_queue_gauges_scrape_through_registry():
    metrics = MetricsRegistry()
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=4, timeout_ms=5.0), metrics
    )
    try:
        queue.predict(np.ones((1, 2)))
        text = metrics.expose_text()
        assert "serving_queue_depth" in text
        assert "serving_inflight_batches" in text
        assert "serving_batch_late_admitted_total" in text
        stats = queue.stats()
        assert stats["queue_depth"] == 0 and stats["inflight"] == 0
        assert stats["queue_wait_ms"] >= 0.0
    finally:
        queue.close()


def test_kill_fails_inflight_and_queued_callers():
    """`kill()` is the SIGKILL analog: in-flight and queued callers all
    fail immediately with QueueClosed (→ ReplicaGone at the router), no
    caller is left waiting on an event that never fires."""
    model = GatedServable(gate_width=2)
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=1, timeout_ms=1000.0)
    )
    try:
        _, errors = [None] * 3, [None] * 3
        done = [None] * 3

        def call(i):
            try:
                done[i] = queue.predict(np.ones((1, 2)))
            except BaseException as e:
                errors[i] = e

        threads = [
            threading.Thread(target=call, args=(i,)) for i in range(3)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while not model.shapes and time.monotonic() < deadline:
            time.sleep(0.005)

        queue.kill()
        for t in threads:
            t.join(timeout=10)
        assert all(isinstance(e, QueueClosed) for e in errors), errors
        with pytest.raises(QueueClosed):
            queue.predict(np.ones((1, 2)))
    finally:
        model.gate.set()
        queue.close()


def test_queue_full_maps_to_429_with_retry_after():
    """Backpressure surfaces as an HTTP 429 carrying Retry-After, not a
    500."""
    gate = threading.Event()
    executing = threading.Event()

    class SlowServable(CountingServable):
        def predict(self, instances):
            executing.set()
            gate.wait(10)
            return super().predict(instances)

    model = SlowServable()
    app = ModelServerApp(
        ModelRepository([model]),
        batching=BatchingConfig(
            max_batch=1, timeout_ms=3000.0, max_pending=1
        ),
    )
    client = TestClient(app)
    try:
        def fill():
            client.post(
                "/v1/models/ident:predict", {"instances": [[1.0]]}
            )

        # Sequenced fill so the slot accounting is deterministic: the
        # first request must be CUT into execution (pending back to 0)
        # before the second is posted, or the second eats the QueueFull
        # the probe below is asserting on.
        threads = [threading.Thread(target=fill) for _ in range(2)]
        threads[0].start()
        assert executing.wait(10)
        threads[1].start()
        queue = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            queue = next(iter(app._batchers.values()), None)
            if queue is not None and queue._pending_count >= 1:
                break
            time.sleep(0.01)
        assert queue is not None and queue._pending_count >= 1

        resp = client.post(
            "/v1/models/ident:predict", {"instances": [[1.0]]}
        )
        assert resp.status == 429, resp.body
        headers = dict(resp.headers)
        # One flush window (3s here) spread ±50% by the seeded jitter —
        # fractional seconds on purpose.
        assert 1.5 <= float(headers["Retry-After"]) <= 4.5
        assert "full" in resp.json()["log"]
        gate.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        gate.set()
        app.close_batchers()


def test_retry_after_jitter_is_seeded_and_spread():
    """Every app draws the same ±50% Retry-After sequence (a fixed seed,
    so a run repeats), and the hints spread over the window instead of
    sending every shed client back at one instant."""
    config = BatchingConfig(max_batch=1, timeout_ms=2000.0)
    apps = [ModelServerApp(ModelRepository(), batching=config) for _ in range(2)]
    hints = [[app._retry_after() for _ in range(32)] for app in apps]
    assert hints[0] == hints[1]
    values = [float(h) for h in hints[0]]
    assert all(1.0 <= v <= 3.0 for v in values), values
    assert max(values) - min(values) > 1.0, values


def test_server_batches_the_lm(models):
    """The tiny LM of tests/test_torch_serving.py behind the batching
    app: concurrent posts share executions and each caller gets the JAX
    servable's logits for its own instances."""
    golden, tmodel = models
    servable = Servable("lm", _last_logits, tmodel, max_batch=4, device="cpu")
    app = ModelServerApp(ModelRepository([servable]),
                         batching=BatchingConfig(max_batch=4, timeout_ms=50.0))
    client = TestClient(app)
    batches = [_lm_instances(n, seed=7 + n) for n in (1, 2, 1)]
    try:
        outs = [None] * len(batches)

        def post(i):
            outs[i] = client.post("/v1/models/lm:predict",
                                  {"instances": batches[i].tolist()})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for batch, resp in zip(batches, outs):
            assert resp.status == 200, resp.body
            np.testing.assert_allclose(np.asarray(resp.json()["predictions"]),
                                       golden.predict(batch), **LM_TOL)
        assert list(app._batchers) == [("lm", 1)]
    finally:
        app.close_batchers()


def test_admit_late_keeps_mismatched_pending_in_order():
    """`_admit_late` pulls ONLY signature-compatible entries; everything
    else must stay pending IN ARRIVAL ORDER, or the next cut would stop
    honoring the oldest caller's timeout deadline."""
    model = CountingServable()
    # Huge window so submitted entries sit pending while the test drives
    # the admission scan directly.
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=8, timeout_ms=10_000.0)
    )
    try:
        inputs = [
            np.full((1, 4), 1.0),  # mismatch, arrived first
            np.full((1, 3), 2.0),  # the only width-3 entry
            np.full((1, 4), 3.0),  # mismatch, arrived last
        ]
        results = [None] * 3
        threads = []
        for i, x in enumerate(inputs):
            t = threading.Thread(
                target=lambda i=i, x=x: results.__setitem__(
                    i, queue.predict(x)
                )
            )
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 5
            while (
                queue._pending_count < i + 1
                and time.monotonic() < deadline
            ):
                time.sleep(0.005)

        taken = queue._admit_late(("ident", 1, (3,), "<f8"), 0)
        assert [e.instances.shape for e in taken] == [(1, 3)]
        with queue._cv:
            kept = [float(e.instances[0, 0]) for e in queue._pending]
            assert kept == [1.0, 3.0]  # arrival order survived the scan
            assert queue._pending_count == 2
            assert taken[0] in queue._inflight  # kill() coverage moved too
        # Complete the admitted caller the way _run_group would, then let
        # close() drain the two kept entries through a normal flush.
        taken[0].result = taken[0].instances * 2.0
        taken[0].event.set()
        queue.close()
        for t in threads:
            t.join(timeout=10)
        for x, out in zip(inputs, results):
            np.testing.assert_array_equal(out, x * 2.0)
    finally:
        queue.close()


def test_admit_late_updates_queue_wait_ewma():
    """Late-admitted entries must feed the queue-wait EWMA the same way
    cut entries do — the autoscaler reads stats()['queue_wait_ms'], and
    a continuous-batching replica whose admissions all ride the late
    path would otherwise report zero wait forever."""
    model = CountingServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=8, timeout_ms=10_000.0)
    )
    try:
        holder = [None]
        t = threading.Thread(
            target=lambda: holder.__setitem__(
                0, queue.predict(np.ones((1, 3)))
            )
        )
        t.start()
        deadline = time.monotonic() + 5
        while queue._pending_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert queue.stats()["queue_wait_ms"] == 0.0
        time.sleep(0.03)  # accrue measurable queue wait
        taken = queue._admit_late(("ident", 1, (3,), "<f8"), 0)
        assert len(taken) == 1
        assert queue.stats()["queue_wait_ms"] > 0.0
        taken[0].result = taken[0].instances * 2.0
        taken[0].event.set()
        t.join(timeout=10)
        np.testing.assert_array_equal(holder[0], np.ones((1, 3)) * 2.0)
    finally:
        queue.close()


def test_kill_racing_late_admission_strands_no_caller():
    """A late-admitted entry is in-flight from the moment it leaves
    pending; a kill() landing while its flush executes must fail it like
    any other in-flight caller — never leave it parked on an event
    nobody will set."""
    class TwoGateServable(CountingServable):
        """Gates BOTH signatures so the test controls exactly when the
        late-admitting width-3 group starts and blocks."""

        def __init__(self):
            super().__init__()
            self.gates = {2: threading.Event(), 3: threading.Event()}
            self.shapes: list[tuple] = []

        def predict(self, instances):
            batch = np.asarray(instances)
            with self._lock:
                self.shapes.append(batch.shape)
            gate = self.gates.get(batch.shape[1])
            if gate is not None:
                gate.wait(10)
            return batch * 2.0

    model = TwoGateServable()
    queue = BatchingQueue(
        model, BatchingConfig(max_batch=2, timeout_ms=2000.0)
    )
    results, errors = [None] * 3, [None] * 3

    def call(i, x):
        try:
            results[i] = queue.predict(x)
        except BaseException as e:
            errors[i] = e

    try:
        deadline = time.monotonic() + 5
        t_x = threading.Thread(target=call, args=(0, np.ones((1, 2))))
        t_x.start()
        while queue._pending_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        t_y1 = threading.Thread(target=call, args=(1, np.ones((1, 3))))
        t_y1.start()  # rows hit max_batch -> cut {x, y1}
        while (
            not any(s[1] == 2 for s in model.shapes)
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        # Width-2 group is executing (gated); y2 arrives post-cut and
        # will be admitted late by the width-3 group.
        t_y2 = threading.Thread(target=call, args=(2, np.ones((1, 3))))
        t_y2.start()
        while queue._pending_count < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        model.gates[2].set()  # width-3 group now admits y2 and executes
        while (
            (2, 3) not in model.shapes and time.monotonic() < deadline
        ):
            time.sleep(0.005)
        assert (2, 3) in model.shapes, model.shapes

        queue.kill()  # lands while the late-admitted flush is gated
        model.gates[3].set()
        for t in (t_x, t_y1, t_y2):
            t.join(timeout=10)
            assert not t.is_alive()  # the stranding regression
        np.testing.assert_array_equal(results[0], np.ones((1, 2)) * 2.0)
        assert isinstance(errors[1], QueueClosed), errors
        assert isinstance(errors[2], QueueClosed), errors
    finally:
        for gate in model.gates.values():
            gate.set()
        queue.close()


def test_unload_prunes_stale_queue():
    """An unloaded version's queue must not pin its weights + scheduler
    thread forever — the next predict prunes it."""
    a = CountingServable()

    class B(CountingServable):
        name = "other"

    b = B()
    repo = ModelRepository([a, b])
    app = ModelServerApp(
        repo, batching=BatchingConfig(max_batch=4, timeout_ms=5.0)
    )
    client = TestClient(app)
    try:
        client.post("/v1/models/ident:predict", {"instances": [[1.0]]})
        client.post("/v1/models/other:predict", {"instances": [[1.0]]})
        assert ("ident", 1) in app._batchers
        repo.unload("ident", 1)
        client.post("/v1/models/other:predict", {"instances": [[1.0]]})
        assert ("ident", 1) not in app._batchers
    finally:
        app.close_batchers()


def test_same_traffic_same_answers_as_the_jax_queue():
    """The port's queue and JAX's, on the same concurrent traffic of
    mixed widths and sizes, give every caller the same rows."""
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((int(rng.integers(1, 4)), int(rng.choice([2, 3]))))
              for _ in range(24)]
    answers = []
    for queue_cls, config_cls in ((BatchingQueue, BatchingConfig),
                                  (jax_batching.BatchingQueue, jax_batching.BatchingConfig)):
        model = CountingServable()
        queue = queue_cls(model, config_cls(max_batch=8, timeout_ms=20.0))
        try:
            results, errors = _concurrent(queue, inputs)
        finally:
            queue.close()
        assert errors == [None] * len(inputs)
        assert sum(model.calls) == sum(x.shape[0] for x in inputs)
        answers.append(results)
    for x, got, want in zip(inputs, *answers):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x * 2.0)
