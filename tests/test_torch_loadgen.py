"""The port's open-loop load harness, by the JAX package's own tests.

Every test of tests/test_loadgen.py, against
`kubeflow_tpu_torch.testing.loadgen`: seeded, monotonic schedules; a
seeded, weighted class mix; exact merge arithmetic; a late start shown
as offered-rate error (the coordinated-omission guard); the threaded
engine; the spawned multi-process engine holding its offered rate.
Then the same schedules and mixes as the JAX package's harness, and the
HTTP target (the port's wire frames) against the port's front door on a
localhost port: every arrival answered, unknown models as errors.
"""

import time

import pytest

from kubeflow_tpu_torch.testing import loadgen
from kubeflow_tpu_torch.testing.loadgen import (
    ERROR,
    OK,
    SHED,
    TrafficClass,
    arrival_schedule,
    assign_classes,
    plan_rate,
)


# -- schedules ---------------------------------------------------------------


def test_poisson_schedule_is_seeded_and_monotonic():
    a = arrival_schedule(100.0, 2000, seed=7)
    b = arrival_schedule(100.0, 2000, seed=7)
    c = arrival_schedule(100.0, 2000, seed=8)
    assert a == b
    assert a != c
    assert all(x <= y for x, y in zip(a, a[1:]))
    # Mean inter-arrival gap ~ 1/rate (law of large numbers, loose).
    mean_gap = a[-1] / (len(a) - 1)
    assert 0.8 / 100.0 < mean_gap < 1.2 / 100.0


def test_uniform_schedule_is_a_metronome():
    assert arrival_schedule(50.0, 5, seed=0, process="uniform") == [
        0.0, 1 / 50.0, 2 / 50.0, 3 / 50.0, 4 / 50.0
    ]


def test_schedule_rejects_bad_inputs():
    with pytest.raises(ValueError, match="rate"):
        arrival_schedule(0.0, 10, seed=0)
    with pytest.raises(ValueError, match="process"):
        arrival_schedule(10.0, 10, seed=0, process="bursty")


def test_class_assignment_is_seeded_and_weighted():
    classes = [
        TrafficClass("hot", weight=4.0),
        TrafficClass("cold", weight=1.0),
    ]
    a = assign_classes(classes, 5000, seed=3)
    assert a == assign_classes(classes, 5000, seed=3)
    assert a != assign_classes(classes, 5000, seed=4)
    hot_share = a.count(0) / len(a)
    assert 0.75 < hot_share < 0.85  # 4:1 weights
    with pytest.raises(ValueError):
        assign_classes([], 10, seed=0)


def test_plan_rate():
    assert plan_rate(600, 30.0) == 20.0


# -- merge arithmetic --------------------------------------------------------


def test_merge_counts_and_rate_are_exact():
    """Hand-built records: a metronome at 10/s with zero lag must merge
    to achieved == offered (error 0), with per-class outcome counts and
    latency percentiles taken only over OK records."""
    classes = [TrafficClass("m", priority="critical")]
    # (cls_idx, offset, lag, latency_s, outcome)
    records = [(0, i / 10.0, 0.0, 0.010, OK) for i in range(20)]
    records[4] = (0, 0.4, 0.0, 0.500, SHED)  # shed latency must not count
    records[9] = (0, 0.9, 0.0, 0.900, ERROR)
    report = loadgen._merge(records, classes, rate=10.0)
    assert report.fired == 20
    assert (report.ok, report.shed, report.error) == (18, 1, 1)
    assert report.offered_rate_error == 0.0
    assert report.achieved_rate == 10.0
    (cls,) = report.classes
    assert (cls.ok, cls.shed, cls.error) == (18, 1, 1)
    assert cls.p50_ms == 10.0 and cls.p99_ms == 10.0  # OK records only


def test_merge_by_model_collapses_priority_streams():
    classes = [
        TrafficClass("m", priority="critical"),
        TrafficClass("m", priority="batch"),
        TrafficClass("other"),
    ]
    records = [
        (0, 0.0, 0.0, 0.010, OK),
        (1, 0.1, 0.0, 0.050, SHED),
        (2, 0.2, 0.0, 0.020, OK),
    ]
    by_model = loadgen._merge(records, classes, rate=10.0).by_model()
    assert set(by_model) == {"m", "other"}
    assert by_model["m"].count == 2
    assert by_model["m"].shed == 1


def test_merge_slow_start_shows_as_rate_error():
    """Coordinated omission guard: arrivals that fired LATE (lag) must
    stretch the measured span and show up as offered-rate error — a
    harness that blames its own stalls on the fleet is lying."""
    classes = [TrafficClass("m")]
    records = [
        (0, i / 100.0, 0.05 * i, 0.001, OK) for i in range(100)
    ]  # each fire 50ms later than the last: 5x the scheduled span
    report = loadgen._merge(records, classes, rate=100.0)
    assert report.achieved_rate < 25.0
    assert report.offered_rate_error > 0.75
    assert report.fire_lag_p99_ms > 1000.0


# -- engines -----------------------------------------------------------------


def test_threaded_run_fires_everything_and_maps_outcomes():
    calls = []

    def target(cls):
        calls.append(cls.model)
        if cls.model == "shedme":
            return "shed"
        if cls.model == "broken":
            raise RuntimeError("kaput")
        return "ok"

    report = loadgen.run_open_loop_threaded(
        target,
        [
            TrafficClass("fine", weight=2.0),
            TrafficClass("shedme"),
            TrafficClass("broken"),
        ],
        rate=500.0, total=200, seed=5, concurrency=16,
    )
    assert report.fired == 200 == len(calls)
    assert report.ok + report.shed + report.error == 200
    by_model = report.by_model()
    assert by_model["shedme"].shed == by_model["shedme"].count
    assert by_model["broken"].error == by_model["broken"].count
    assert by_model["fine"].ok == by_model["fine"].count


def test_multiprocess_noop_holds_offered_rate():
    """The real engine: spawn workers, shared monotonic start, no-op
    target. Everything scheduled fires exactly once, and the achieved
    rate tracks the offered rate (chip_smoke's frontdoor phase gates 5%
    at scale; unit scale on a busy CI box gets a looser 25%)."""
    t0 = time.monotonic()
    report = loadgen.run_open_loop(
        {"mode": "noop", "work_us": 20},
        [TrafficClass("a", weight=3.0), TrafficClass("b")],
        rate=400.0, total=240, seed=11, workers=2, concurrency=8,
        process="uniform", start_delay_s=0.2,
    )
    elapsed = time.monotonic() - t0
    assert report.fired == 240
    assert report.ok == 240
    assert report.offered_rate_error < 0.25, report
    assert report.duration_s > 0.4  # ~240/400s of schedule actually ran
    assert elapsed < 60.0
    assert {c.model for c in report.classes} == {"a", "b"}
    assert sum(c.count for c in report.classes) == 240


# -- parity and the HTTP target ---------------------------------------------


def test_schedules_and_mixes_are_the_jax_harness_s():
    from kubeflow_tpu.testing import loadgen as jax_loadgen

    for process in ("poisson", "uniform"):
        assert arrival_schedule(150.0, 500, seed=3, process=process) == (
            jax_loadgen.arrival_schedule(150.0, 500, seed=3, process=process))
    weights = [4.0, 4.0, 1.0, 1.0]
    ours = [TrafficClass(f"m{i}", weight=w) for i, w in enumerate(weights)]
    theirs = [jax_loadgen.TrafficClass(f"m{i}", weight=w) for i, w in enumerate(weights)]
    assert assign_classes(ours, 1000, seed=9) == jax_loadgen.assign_classes(
        theirs, 1000, seed=9)


def test_http_target_drives_the_port_front_door():
    from kubeflow_tpu_torch.serving import (
        BatchingConfig,
        FrontDoorApp,
        MultiModelReplica,
        PagingConfig,
        Router,
        ServableRegistry,
    )
    from kubeflow_tpu_torch.web import serve

    class Doubler:
        def __init__(self, name):
            self.name, self.version = name, 1

        def predict(self, instances):
            return instances * 2.0

    router = Router()
    registry = ServableRegistry(
        lambda rspec: Doubler(rspec["model"]),
        batching=BatchingConfig(max_batch=8, timeout_ms=2.0),
        paging=PagingConfig(max_resident=1),
    )
    for model in ("a", "b"):
        registry.ensure({"model": model})
    router.add(MultiModelReplica("r0", registry))
    server, thread = serve(FrontDoorApp(router), host="127.0.0.1", port=0)
    try:
        report = loadgen.run_open_loop(
            {"mode": "http", "addr": f"127.0.0.1:{server.server_port}",
             "shape": [1, 4], "timeout_s": 30.0},
            [TrafficClass("a", weight=2.0), TrafficClass("b"),
             TrafficClass("ghost", weight=0.5)],
            rate=100.0, total=60, seed=4, workers=2, concurrency=4,
        )
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        registry.close()
    by_model = report.by_model()
    assert report.fired == 60
    assert by_model["a"].ok == by_model["a"].count > 0
    assert by_model["b"].ok == by_model["b"].count > 0
    assert by_model["ghost"].error == by_model["ghost"].count > 0  # 404
    assert router.acked_total.value() == router.completed_total.value() + (
        router.failed_total.value())
    assert registry.stats()["resident"] == 0  # closed
