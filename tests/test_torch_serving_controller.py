"""The port's ServingDeployment controller (`controllers/serving.py`) and
replica worker loop (`serving/__main__.py`).

First the 23 tests of tests/test_serving_controller.py, run against the
port's controller, store and worker loop with the same scripted runtime:
the CR materializes owned ServingReplica objects, readiness aggregates
into status, replica count converges to the autoscale target (queue
depth and observed p99, scale-down stabilized), a modelVersion bump
rolls one replica at a time, ``runtime: process`` routes to the process
runtime. Then JAX's CR-to-front-door quota test against the port, a
parity run that drives one CR sequence through both packages'
controllers, and the repaired endless roll of a checkpoint directory
that moves past the spec.
"""

import shutil
import threading
import time

import pytest

from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound


class FakeRuntime:
    """Scripted materialization backend: every replica is a dict."""

    def __init__(self):
        self.replicas: dict[str, dict] = {}
        self.rolls: list[str] = []
        self.stopped: list[str] = []

    def names(self):
        return list(self.replicas)

    def ensure(self, name, rspec):
        self.replicas.setdefault(
            name,
            {
                "ready": True,
                "version": int(rspec.get("modelVersion") or 1),
                "queue_depth": 0,
                "inflight": 0,
                "queue_wait_ms": 0.0,
            },
        )

    def stop(self, name):
        self.replicas.pop(name, None)
        self.stopped.append(name)

    def roll(self, name, rspec):
        self.replicas[name]["version"] = int(rspec["modelVersion"])
        self.rolls.append(name)
        return 0.01

    def stats(self, name):
        return self.replicas.get(name)


@pytest.fixture()
def harness():
    api = FakeApiServer()
    runtime = FakeRuntime()
    controller = ServingDeploymentController(api, runtime=runtime)
    return api, runtime, controller


def converge(controller):
    controller.controller.run_until_idle()


def dep_status(api, name="fleet"):
    return api.get(serving_api.KIND, name, "default").status


def test_create_materializes_replicas_and_status(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment("fleet", replicas=3)
    )
    converge(controller)

    names = [serving_api.replica_name("fleet", i) for i in range(3)]
    assert sorted(runtime.replicas) == names
    for rname in names:
        robj = api.get(serving_api.REPLICA_KIND, rname, "default")
        assert (
            robj.metadata.labels[serving_api.LABEL_DEPLOYMENT] == "fleet"
        )
        assert robj.metadata.owner_references[0]["name"] == "fleet"
        assert robj.spec["batching"]["continuous"] is True
        assert robj.status["ready"] is True  # stamped back for kubectl
    status = dep_status(api)
    assert status["phase"] == "Available"
    assert status["readyReplicas"] == 3
    assert [r["name"] for r in status["replicas"]] == names


def test_scale_down_stops_and_deletes(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment("fleet", replicas=3)
    )
    converge(controller)

    dep = api.get(serving_api.KIND, "fleet", "default").thaw()
    spec = dict(dep.spec)
    spec["replicas"] = 1
    dep.spec = spec
    api.update(dep)
    converge(controller)

    assert sorted(runtime.replicas) == [
        serving_api.replica_name("fleet", 0)
    ]
    assert len(runtime.stopped) == 2
    with pytest.raises(NotFound):
        api.get(
            serving_api.REPLICA_KIND,
            serving_api.replica_name("fleet", 2),
            "default",
        )
    assert dep_status(api)["readyReplicas"] == 1


def test_autoscale_tracks_queue_depth(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment(
            "fleet",
            replicas=1,
            autoscale={
                "min_replicas": 1,
                "max_replicas": 4,
                "target_queue_depth": 10,
            },
        )
    )
    converge(controller)
    assert len(runtime.replicas) == 1

    # Queue pressure: 25 queued+executing over target 10 → 3 replicas.
    r0 = serving_api.replica_name("fleet", 0)
    runtime.replicas[r0]["queue_depth"] = 20
    runtime.replicas[r0]["inflight"] = 5
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 3
    assert dep_status(api)["targetReplicas"] == 3

    # Pressure gone → back to min (never below it).
    runtime.replicas[r0]["queue_depth"] = 0
    runtime.replicas[r0]["inflight"] = 0
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 1
    assert dep_status(api)["targetReplicas"] == 1


def test_model_version_bump_rolls_each_replica(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment(
            "fleet", replicas=3, model_version=1
        )
    )
    converge(controller)

    dep = api.get(serving_api.KIND, "fleet", "default").thaw()
    spec = dict(dep.spec)
    spec["modelVersion"] = 2
    dep.spec = spec
    api.update(dep)
    converge(controller)

    assert len(runtime.rolls) == 3
    assert all(
        r["version"] == 2 for r in runtime.replicas.values()
    )
    # The config push rode the replica objects too.
    robj = api.get(
        serving_api.REPLICA_KIND,
        serving_api.replica_name("fleet", 0),
        "default",
    )
    assert robj.spec["modelVersion"] == 2


def test_roll_defers_while_a_sibling_is_down(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment(
            "fleet", replicas=2, model_version=1
        )
    )
    converge(controller)

    # One replica is already not ready: taking another out for the roll
    # would be an outage, so the roll must wait.
    r1 = serving_api.replica_name("fleet", 1)
    runtime.replicas[r1]["ready"] = False
    dep = api.get(serving_api.KIND, "fleet", "default").thaw()
    spec = dict(dep.spec)
    spec["modelVersion"] = 2
    dep.spec = spec
    api.update(dep)
    converge(controller)
    assert runtime.rolls == []

    runtime.replicas[r1]["ready"] = True
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.rolls) == 2


def test_invalid_spec_is_terminal_failed(harness):
    api, runtime, controller = harness
    dep = serving_api.make_serving_deployment("fleet", replicas=1)
    spec = dict(dep.spec)
    spec["replicas"] = -2
    dep.spec = spec
    api.create(dep)
    converge(controller)

    status = dep_status(api)
    assert status["phase"] == "Failed"
    assert "replicas" in status["reason"]
    assert runtime.replicas == {}


def test_delete_tears_down_fleet(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment("fleet", replicas=2)
    )
    converge(controller)
    assert len(runtime.replicas) == 2

    api.delete(serving_api.KIND, "fleet", "default")
    converge(controller)
    assert runtime.replicas == {}
    assert api.list(serving_api.REPLICA_KIND, "default") == []


def test_config_push_updates_replica_spec(harness):
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment(
            "fleet", replicas=1, batch_timeout_ms=5.0
        )
    )
    converge(controller)

    dep = api.get(serving_api.KIND, "fleet", "default").thaw()
    spec = dict(dep.spec)
    spec["batching"] = {**spec["batching"], "timeoutMs": 9.0}
    dep.spec = spec
    api.update(dep)
    converge(controller)

    robj = api.get(
        serving_api.REPLICA_KIND,
        serving_api.replica_name("fleet", 0),
        "default",
    )
    assert robj.spec["batching"]["timeoutMs"] == 9.0


# -- the replica worker loop (`python -m kubeflow_tpu_torch.serving`) -------


class FakeServable:
    def __init__(self, name, version):
        self.name = name
        self.version = version


class FakeRepository:
    def __init__(self):
        self.models: dict[str, FakeServable] = {}
        self.loads = 0

    def get(self, name):
        return self.models[name]

    def load(self, servable):
        self.models[servable.name] = servable
        self.loads += 1

    # The port's worker makes each load the model's one version.
    replace = load


def build_servable(rspec):
    return FakeServable(
        rspec.get("model", "demo"), int(rspec.get("modelVersion") or 1)
    )


def make_replica_object(api, version=1):
    from kubeflow_tpu_torch.api.objects import new_resource

    api.create(
        new_resource(
            serving_api.REPLICA_KIND,
            "r0",
            "default",
            spec={"model": "demo", "modelVersion": version},
        )
    )


def test_sync_replica_once_loads_and_stamps_status():
    from kubeflow_tpu_torch.serving.__main__ import sync_replica_once

    api = FakeApiServer()
    make_replica_object(api, version=3)
    repo = FakeRepository()

    live = sync_replica_once(
        api, "r0", "default", repo,
        build_servable=build_servable,
        endpoint="127.0.0.1:9999",
        queue_stats=lambda: {"queue_depth": 7, "inflight": 2},
    )
    assert live == 3
    assert repo.loads == 1
    status = api.get(serving_api.REPLICA_KIND, "r0", "default").status
    assert status["ready"] is True
    assert status["version"] == 3
    assert status["endpoint"] == "127.0.0.1:9999"
    assert status["queueDepth"] == 7 and status["inflight"] == 2

    # Idempotent: a second sync at the same version does not reload.
    sync_replica_once(
        api, "r0", "default", repo, build_servable=build_servable
    )
    assert repo.loads == 1


def test_sync_replica_once_none_when_object_gone():
    from kubeflow_tpu_torch.serving.__main__ import sync_replica_once

    api = FakeApiServer()
    repo = FakeRepository()
    assert (
        sync_replica_once(
            api, "r0", "default", repo, build_servable=build_servable
        )
        is None
    )


def test_run_replica_hot_swaps_on_config_push_and_exits_on_delete():
    from kubeflow_tpu_torch.serving.__main__ import run_replica

    api = FakeApiServer()
    make_replica_object(api, version=1)
    repo = FakeRepository()
    t = threading.Thread(
        target=run_replica,
        args=(api, "r0", "default", repo),
        kwargs={"build_servable": build_servable, "heartbeat_s": 0.05},
        daemon=True,
    )
    t.start()

    deadline = time.monotonic() + 5
    while repo.loads == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert repo.models["demo"].version == 1

    # The controller bumps modelVersion on the replica object; the
    # worker's watch reacts — the hot-swap config push, no polling.
    robj = api.get(serving_api.REPLICA_KIND, "r0", "default").thaw()
    robj.spec = {**robj.spec, "modelVersion": 2}
    api.update(robj)
    deadline = time.monotonic() + 5
    while (
        repo.models["demo"].version != 2 and time.monotonic() < deadline
    ):
        time.sleep(0.01)
    assert repo.models["demo"].version == 2

    # Deployment deleted → object gone → the worker loop returns.
    api.delete(serving_api.REPLICA_KIND, "r0", "default")
    t.join(timeout=5)
    assert not t.is_alive()


# -- observed-latency autoscale signal ------------------------------------


def test_autoscale_target_latency_and_depth_agreement():
    """Unit contract for the two-signal policy: scale-up wins."""
    spec = serving_api.AutoscaleSpec(
        min_replicas=1, max_replicas=8,
        target_queue_depth=10, target_latency_ms=50.0,
    )
    # Agreement: both signals want 3.
    assert spec.target(25, p99_latency_ms=140.0, current_replicas=1) == 3
    # Conflict, latency higher: shallow queues must not mask a p99
    # breach (slow-drain pathology).
    assert spec.target(5, p99_latency_ms=200.0, current_replicas=2) == 8
    # Conflict, depth higher: fast batches must not mask a backlog.
    assert spec.target(60, p99_latency_ms=10.0, current_replicas=2) == 6
    # Latency signal off (0) or unmeasured (None): depth-only.
    off = serving_api.AutoscaleSpec(
        min_replicas=1, max_replicas=8, target_queue_depth=10,
    )
    assert off.target(5, p99_latency_ms=500.0, current_replicas=2) == 1
    assert spec.target(5, p99_latency_ms=None, current_replicas=2) == 1


def test_autoscale_scales_out_on_observed_latency(harness):
    """Controller path: rolling p99 queue wait above targetLatencyMs
    scales the fleet out even though queues are shallow."""
    api, runtime, controller = harness
    api.create(
        serving_api.make_serving_deployment(
            "fleet",
            replicas=1,
            autoscale={
                "min_replicas": 1,
                "max_replicas": 4,
                "target_queue_depth": 100,
                "target_latency_ms": 50.0,
            },
        )
    )
    converge(controller)
    assert len(runtime.replicas) == 1

    r0 = serving_api.replica_name("fleet", 0)
    runtime.replicas[r0]["queue_wait_ms"] = 150.0  # 3x the target
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    # The fake's wait signal never improves, so the proportional policy
    # keeps compounding until it hits the ceiling — queues stayed at
    # depth 0 the whole time, so this is purely the latency signal.
    assert dep_status(api)["targetReplicas"] == 4
    assert len(runtime.replicas) == 4


def test_scale_down_stabilization_prevents_flap(harness):
    """A transient pressure dip inside the stabilization window must not
    shrink the fleet (flap-free scale-down); once the window drains of
    high targets, scale-down proceeds — and scale-up stays immediate."""
    api, runtime, _ = harness
    now = [1000.0]
    controller = ServingDeploymentController(
        api, runtime=runtime, clock=lambda: now[0]
    )
    api.create(
        serving_api.make_serving_deployment(
            "fleet",
            replicas=1,
            autoscale={
                "min_replicas": 1,
                "max_replicas": 4,
                "target_queue_depth": 10,
                "scale_down_stabilization_s": 30.0,
            },
        )
    )
    converge(controller)
    r0 = serving_api.replica_name("fleet", 0)
    runtime.replicas[r0]["queue_depth"] = 40  # → 4 replicas
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 4

    # The burst pauses for one reconcile: raw target collapses to 1 but
    # the window still holds the 4 — the fleet must not move.
    runtime.replicas[r0]["queue_depth"] = 0
    now[0] += 5.0
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 4
    assert dep_status(api)["targetReplicas"] == 4
    assert runtime.stopped == []

    # Pressure returns mid-window: scale-up needs no window to pass —
    # the fleet is already at 4 and stays there.
    runtime.replicas[r0]["queue_depth"] = 40
    now[0] += 5.0
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 4

    # Quiet past the whole window: the high samples age out and the
    # fleet finally settles to min.
    runtime.replicas[r0]["queue_depth"] = 0
    now[0] += 31.0
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert len(runtime.replicas) == 1
    assert dep_status(api)["targetReplicas"] == 1


def test_stabilization_field_roundtrip_and_validation():
    spec = serving_api.ServingDeploymentSpec(
        autoscale=serving_api.AutoscaleSpec(
            max_replicas=4, scale_down_stabilization_s=30.0
        )
    )
    d = spec.to_dict()
    assert d["autoscale"]["scaleDownStabilizationSeconds"] == 30.0
    parsed = serving_api.ServingDeploymentSpec.from_dict(d)
    assert parsed.autoscale.scale_down_stabilization_s == 30.0
    # Absent field defaults off (existing CRs parse unchanged).
    no_window = serving_api.ServingDeploymentSpec.from_dict(
        {"autoscale": {"maxReplicas": 2}}
    )
    assert no_window.autoscale.scale_down_stabilization_s == 0.0
    with pytest.raises(ValueError, match="scaleDownStabilization"):
        serving_api.AutoscaleSpec(scale_down_stabilization_s=-1).validate()


# -- runtime: process -----------------------------------------------------


def test_runtime_field_roundtrip_and_validation():
    spec = serving_api.ServingDeploymentSpec(runtime="process")
    assert spec.to_dict()["runtime"] == "process"
    parsed = serving_api.ServingDeploymentSpec.from_dict(spec.to_dict())
    assert parsed.runtime == "process"
    # Default stays local (existing CRs parse unchanged).
    assert serving_api.ServingDeploymentSpec.from_dict({}).runtime == "local"
    with pytest.raises(ValueError, match="runtime"):
        serving_api.ServingDeploymentSpec(runtime="docker").validate()
    with pytest.raises(ValueError, match="targetLatency"):
        serving_api.ServingDeploymentSpec.from_dict(
            {"autoscale": {"targetLatency": 5}}
        )


def test_process_spec_routes_to_process_runtime():
    """`spec.runtime: process` materializes via the process runtime;
    local specs keep using the in-process one; teardown sweeps both."""
    api = FakeApiServer()
    local, procs = FakeRuntime(), FakeRuntime()
    controller = ServingDeploymentController(
        api, runtime=local, process_runtime=procs
    )
    api.create(
        serving_api.make_serving_deployment(
            "pfleet", replicas=2, runtime="process"
        )
    )
    api.create(serving_api.make_serving_deployment("lfleet", replicas=1))
    converge(controller)
    assert sorted(procs.replicas) == [
        serving_api.replica_name("pfleet", 0),
        serving_api.replica_name("pfleet", 1),
    ]
    assert sorted(local.replicas) == [serving_api.replica_name("lfleet", 0)]

    api.delete(serving_api.KIND, "pfleet", "default")
    converge(controller)
    assert procs.replicas == {}
    assert local.replicas != {}  # the local fleet is untouched


def test_process_spec_without_process_runtime_degrades_to_local():
    api = FakeApiServer()
    local = FakeRuntime()
    controller = ServingDeploymentController(api, runtime=local)
    api.create(
        serving_api.make_serving_deployment(
            "pfleet", replicas=1, runtime="process"
        )
    )
    converge(controller)
    assert sorted(local.replicas) == [serving_api.replica_name("pfleet", 0)]


# -- multiplexed fleets: CR -> replicas -> status ---------------------------


class MuxRuntime(FakeRuntime):
    """FakeRuntime whose replicas carry per-model registry stats, the
    shape MultiModelReplica.stats() exposes to the controller."""

    def __init__(self):
        super().__init__()
        self.rspecs: dict[str, dict] = {}

    def ensure(self, name, rspec):
        self.rspecs[name] = dict(rspec)
        if name in self.replicas:
            return
        models = {
            m["name"]: {
                "state": "resident",
                "version": int(m.get("modelVersion") or 1),
                "page_ins": 1,
            }
            for m in rspec.get("models", [])
        }
        self.replicas[name] = {
            "ready": True,
            "version": 1,
            "queue_depth": 0,
            "inflight": 0,
            "queue_wait_ms": 0.0,
            "models": models,
            "resident": len(models),
        }

    def roll(self, name, rspec):
        for m in rspec.get("models", []):
            row = self.replicas[name]["models"][m["name"]]
            if row["state"] == "resident":
                row["version"] = int(m.get("modelVersion") or 1)
        self.rolls.append(name)
        return 0.01


def make_mux_deployment(**kwargs):
    return serving_api.make_serving_deployment(
        "mux",
        replicas=2,
        models=[
            {"name": "alpha", "modelVersion": 1},
            {"name": "beta", "modelVersion": 1, "priority": "batch"},
        ],
        **kwargs,
    )


def test_multiplexed_spec_flows_to_replicas():
    api = FakeApiServer()
    runtime = MuxRuntime()
    controller = ServingDeploymentController(api, runtime=runtime)
    api.create(make_mux_deployment(max_resident=1))
    converge(controller)

    assert len(runtime.replicas) == 2
    for rspec in runtime.rspecs.values():
        assert [m["name"] for m in rspec["models"]] == ["alpha", "beta"]
        assert rspec["paging"] == {"maxResident": 1}
    # Replica objects carry the same catalog (the worker's channel).
    robj = api.get(
        serving_api.REPLICA_KIND, serving_api.replica_name("mux", 0),
        "default",
    )
    assert [m["name"] for m in robj.spec["models"]] == ["alpha", "beta"]


def test_multiplexed_status_aggregates_per_model():
    api = FakeApiServer()
    runtime = MuxRuntime()
    controller = ServingDeploymentController(api, runtime=runtime)
    api.create(make_mux_deployment())
    converge(controller)

    status = api.get(serving_api.KIND, "mux", "default").status
    by_name = {m["name"]: m for m in status["models"]}
    assert set(by_name) == {"alpha", "beta"}
    assert by_name["alpha"]["residentReplicas"] == 2
    assert by_name["alpha"]["version"] == 1
    assert by_name["alpha"]["pageIns"] == 2  # one per replica
    assert all(r["resident"] == 2 for r in status["replicas"])


def test_multiplexed_roll_targets_only_stale_resident_models():
    api = FakeApiServer()
    runtime = MuxRuntime()
    controller = ServingDeploymentController(api, runtime=runtime)
    api.create(make_mux_deployment())
    converge(controller)
    assert runtime.rolls == []

    # beta pages out on replica 1: a version bump for beta must NOT
    # roll that replica (its next page-in loads the new version free).
    runtime.replicas[serving_api.replica_name("mux", 1)]["models"][
        "beta"
    ] = {"state": "registered", "version": 0, "page_ins": 1}

    dep = api.get(serving_api.KIND, "mux", "default").thaw()
    dep.spec = dict(dep.spec)
    models = [dict(m) for m in dep.spec["models"]]
    models[1]["modelVersion"] = 2  # bump beta only
    dep.spec["models"] = models
    api.update(dep)
    converge(controller)

    # Only replica 0 (beta resident + stale) rolled.
    assert runtime.rolls == [serving_api.replica_name("mux", 0)]
    events = [
        e.spec for e in api.list("Event", "default")
        if e.spec.get("reason") == "ReplicaRolled"
    ]
    assert events and "beta -> version 2" in events[-1]["message"]
    # And alpha was never named: it is not stale.
    assert "alpha" not in events[-1]["message"]


def test_sync_replica_once_multimodel_loads_catalog():
    from kubeflow_tpu_torch.serving.__main__ import sync_replica_once
    from kubeflow_tpu_torch.api.objects import new_resource

    api = FakeApiServer()
    api.create(
        new_resource(
            serving_api.REPLICA_KIND,
            "r0",
            "default",
            spec={
                "model": "demo",
                "maxBatch": 8,
                "models": [
                    {"name": "alpha", "modelVersion": 3},
                    {"name": "beta", "modelVersion": 5},
                ],
            },
        )
    )
    repo = FakeRepository()
    live = sync_replica_once(
        api, "r0", "default", repo, build_servable=build_servable
    )
    assert live == 5  # max across the catalog
    assert sorted(repo.models) == ["alpha", "beta"]
    assert repo.models["alpha"].version == 3
    status = api.get(serving_api.REPLICA_KIND, "r0", "default").status
    assert status["models"] == {"alpha": 3, "beta": 5}

    # Idempotent: same versions -> no reloads.
    sync_replica_once(
        api, "r0", "default", repo, build_servable=build_servable
    )
    assert repo.loads == 2


def test_models_and_paging_field_roundtrip_and_validation():
    spec = serving_api.ServingDeploymentSpec(
        models=(
            serving_api.ModelEntry(name="alpha", model_version=2),
            serving_api.ModelEntry(
                name="beta", priority="batch", quota_rate=5.0,
                quota_burst=10.0,
            ),
        ),
        max_resident=1,
    )
    d = spec.to_dict()
    assert [m["name"] for m in d["models"]] == ["alpha", "beta"]
    assert d["models"][1]["priority"] == "batch"
    assert d["models"][1]["quotaRate"] == 5.0
    assert d["paging"] == {"maxResident": 1}
    parsed = serving_api.ServingDeploymentSpec.from_dict(d)
    assert parsed.models == spec.models
    assert parsed.max_resident == 1
    # Absent fields default to a single-model spec (old CRs parse).
    legacy = serving_api.ServingDeploymentSpec.from_dict({})
    assert legacy.models == () and legacy.max_resident == 0

    with pytest.raises(ValueError, match="unique"):
        serving_api.ServingDeploymentSpec(
            models=(
                serving_api.ModelEntry(name="a"),
                serving_api.ModelEntry(name="a"),
            )
        ).validate()
    with pytest.raises(ValueError, match="priority"):
        serving_api.ModelEntry(name="a", priority="vip").validate()
    with pytest.raises(ValueError, match="maxResident"):
        serving_api.ServingDeploymentSpec(max_resident=-1).validate()
    # Unknown fields inside a model entry are rejected (fat-finger
    # protection, same policy as the spec root).
    with pytest.raises(ValueError, match="unknown"):
        serving_api.ServingDeploymentSpec.from_dict(
            {"models": [{"name": "a", "quotaRte": 1}]}
        )
    with pytest.raises(ValueError, match="unknown"):
        serving_api.ServingDeploymentSpec.from_dict(
            {"paging": {"maxResidnt": 1}}
        )


# -- the CR's catalog reaches the port's front door --------------------------


class Doubler:
    def __init__(self, name):
        self.name = name
        self.version = 1

    def predict(self, instances):
        import numpy as np

        return np.asarray(instances, dtype=np.float32) * 2.0


def test_cr_catalog_quota_reaches_the_front_door():
    """tests/test_serving_front_door.py's wiring test against the port: a
    `quotaRate` declared in the CR's models[] sheds at the HTTP boundary,
    through the controller, the LocalReplicaRuntime hook and the
    router's per-model bucket."""
    from kubeflow_tpu_torch.serving import FrontDoorApp, LocalReplicaRuntime, Router
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
    from kubeflow_tpu_torch.web import TestClient

    metrics = MetricsRegistry()
    router = Router(metrics, retry_jitter_seed=7)
    runtime = LocalReplicaRuntime(
        router, lambda rspec: Doubler(rspec["model"]), metrics
    )
    api = FakeApiServer()
    controller = ServingDeploymentController(
        api, runtime=runtime, metrics=metrics
    )
    api.create(serving_api.make_serving_deployment(
        "fd", replicas=1,
        models=[
            {"name": "alpha", "quotaRate": 0.001, "quotaBurst": 1.0},
            {"name": "beta", "priority": "batch"},
        ],
    ))
    controller.controller.run_until_idle()
    try:
        app = FrontDoorApp(router, metrics=metrics)
        client = TestClient(app)
        body = {"instances": [[1.0]]}

        # Burst of 1: first request lands, second sheds honestly.
        assert client.post(
            "/v1/models/alpha:predict", body
        ).status == 200
        resp = client.post("/v1/models/alpha:predict", body)
        assert resp.status == 429
        assert float(dict(resp.headers)["Retry-After"]) > 0
        # beta carries no quota, and its catalog-declared "batch" class
        # resolves when the request names none.
        assert client.post(
            "/v1/models/beta:predict", body
        ).status == 200
    finally:
        for name in list(router.replica_names()):
            replica = router.replica(name)
            router.remove(name)
            replica.close()


# -- parity: one CR sequence through both packages' controllers ---------------


def _jax_stack():
    from kubeflow_tpu.api import serving as jax_serving_api
    from kubeflow_tpu.controllers.serving import (
        ServingDeploymentController as JaxController,
    )
    from kubeflow_tpu.testing import FakeApiServer as JaxApiServer

    return jax_serving_api, JaxController, JaxApiServer


def _port_stack():
    return serving_api, ServingDeploymentController, FakeApiServer


def _snapshot(api, sapi, runtime):
    """What a CR sequence left behind: the replica objects' specs and
    statuses, the CR's status, the events' reasons and messages in
    order, and the runtime's rolls."""
    replicas = {
        r.metadata.name: (r.to_dict()["spec"], r.to_dict()["status"])
        for r in api.list(sapi.REPLICA_KIND, "default")
    }
    try:
        status = api.get(sapi.KIND, "fleet", "default").to_dict()["status"]
    except Exception:
        status = None
    events = [
        (e.spec["reason"], e.spec["message"])
        for e in sorted(api.list("Event", "default"),
                        key=lambda e: e.metadata.resource_version)
    ]
    return {
        "replicas": replicas, "status": status, "events": events,
        "rolls": list(runtime.rolls), "stopped": list(runtime.stopped),
        "runtime": {k: dict(v) for k, v in runtime.replicas.items()},
    }


def _edit_spec(api, sapi, **changes):
    dep = api.get(sapi.KIND, "fleet", "default").thaw()
    dep.spec = {**dep.spec, **changes}
    api.update(dep)


def _cr_sequence(stack):
    """create at 2 replicas, scale to 3, autoscale on (queue depth with
    a 30 s scale-down window on an injected clock: a burst, a pause
    inside the window, quiet past it), a modelVersion bump, delete."""
    sapi, controller_cls, api_cls = stack
    api, runtime, now = api_cls(), FakeRuntime(), [1000.0]
    controller = controller_cls(api, runtime=runtime, clock=lambda: now[0])
    trace = []

    def step():
        controller.controller.enqueue(("default", "fleet"))
        controller.controller.run_until_idle()
        trace.append(_snapshot(api, sapi, runtime))

    api.create(sapi.make_serving_deployment("fleet", replicas=2, model_version=1))
    step()
    _edit_spec(api, sapi, replicas=3)
    step()
    _edit_spec(api, sapi, autoscale={
        "minReplicas": 1, "maxReplicas": 4, "targetQueueDepth": 10,
        "targetLatencyMs": 0.0, "scaleDownStabilizationSeconds": 30.0,
    })
    step()
    r0 = sapi.replica_name("fleet", 0)
    for depth, wait, advance in ((35, 4.0, 1.0), (0, 0.0, 5.0), (0, 0.0, 31.0)):
        runtime.replicas[r0]["queue_depth"] = depth
        runtime.replicas[r0]["queue_wait_ms"] = wait
        now[0] += advance
        step()
    _edit_spec(api, sapi, modelVersion=2)
    step()
    api.delete(sapi.KIND, "fleet", "default")
    step()
    return trace


def test_cr_sequence_matches_the_jax_controller():
    """The same CR sequence through both packages' controllers (each on
    its own package's store, one scripted runtime class) leaves the same
    ServingReplica specs and statuses, CR statuses, events, roll order
    and runtime state after every step. The port's CR status also holds
    ``servedVersions`` (the JAX one has no such field): the sorted
    versions of the ready replicas."""
    jax_trace = _cr_sequence(_jax_stack())
    port_trace = _cr_sequence(_port_stack())
    assert len(port_trace) == len(jax_trace) == 8
    # The sequence did what it says: scaled 2 -> 3 -> 4 -> 4 -> 1, rolled
    # the survivor, tore the fleet down.
    sizes = [len(t["runtime"]) for t in port_trace]
    assert sizes == [2, 3, 1, 4, 4, 1, 1, 0]
    assert port_trace[6]["rolls"] == [serving_api.replica_name("fleet", 0)]
    for step, (want, got) in enumerate(zip(jax_trace, port_trace)):
        if got["status"] is not None:
            served = got["status"].pop("servedVersions")
            assert "servedVersions" not in want["status"]
            assert served == sorted({r["version"] for r in got["runtime"].values()
                                     if r["ready"]}), step
        assert got == want, step


# -- a checkpoint directory that moves past spec.modelVersion -----------------


def _commit(directory, *steps):
    """Commit `steps` into a checkpoint directory: a file each and a
    verified manifest, what `holds_step` reads."""
    from kubeflow_tpu_torch.train.checkpoint import write_manifest

    for step in steps:
        step_dir = directory / str(step)
        step_dir.mkdir(parents=True)
        (step_dir / "params.pt").write_bytes(b"step %d" % step)
        write_manifest(step_dir, None)


class CheckpointRuntime(FakeRuntime):
    """Scripted runtime for a checkpoint-backed fleet: a replica restores
    from its directory both when it starts and when it rolls. With
    `spec_step` it restores as the port's `build_servable_from_rspec`
    does (the step modelVersion names while the directory holds it, else
    the newest); without, as the JAX package's does (the newest step,
    whatever modelVersion asks for)."""

    def __init__(self, directory, spec_step):
        super().__init__()
        self.directory, self.spec_step = directory, spec_step

    def restore(self, rspec):
        from kubeflow_tpu_torch.train.checkpoint import holds_step

        want = int(rspec.get("modelVersion") or 0)
        if self.spec_step and want and holds_step(self.directory, want):
            return want
        return max(int(p.name) for p in self.directory.iterdir() if p.name.isdigit())

    def ensure(self, name, rspec):
        if name not in self.replicas:
            self.replicas[name] = {
                "ready": True, "version": self.restore(rspec), "queue_depth": 0,
                "inflight": 0, "queue_wait_ms": 0.0,
            }

    def roll(self, name, rspec):
        self.replicas[name]["version"] = self.restore(rspec)
        self.rolls.append(name)
        return 0.01


def _reconciles(controller, n):
    for _ in range(n):
        controller.controller.enqueue(("default", "ckfleet"))
        controller.controller.run_until_idle()


def _ckfleet(stack, directory, spec_step, model_version=9):
    """A 2-replica checkpoint-backed fleet "ckfleet" on `stack`'s
    controller and store, with `CheckpointRuntime(directory, spec_step)`."""
    sapi, controller_cls, api_cls = stack
    api, runtime = api_cls(), CheckpointRuntime(directory, spec_step)
    controller = controller_cls(api, runtime=runtime)
    api.create(sapi.make_serving_deployment(
        "ckfleet", replicas=2, checkpoint_dir=str(directory),
        model_version=model_version))
    return api, runtime, controller


def _versions(runtime):
    return sorted(r["version"] for r in runtime.replicas.values())


def _set_spec(api, **changes):
    dep = api.get(serving_api.KIND, "ckfleet", "default").thaw()
    dep.spec = {**dep.spec, **changes}
    api.update(dep)


def test_checkpoint_past_the_spec_version_rolls_each_replica_once(tmp_path):
    """A checkpoint-backed fleet whose directory moves past
    spec.modelVersion. The JAX package's replica restores the newest
    step and its controller wants equality: with modelVersion 9 and the
    directory at step 11 it rolls every replica on every reconcile,
    forever (12 rolls in 5 reconciles for 2 replicas: each roll restores
    step 11 again, and the first reconcile's status writes wake a second
    pass). The port's replica restores the step the spec names while the
    directory holds it, so the fleet serves exactly modelVersion and
    converges: no roll while the directory is past the spec, each
    replica rolled exactly once by a bump, none when training then
    commits past the bump, and a replica below the spec still rolls."""
    ckpt = tmp_path / "ckpt"
    _commit(ckpt, 9, 10, 11)  # training committed past the spec's 9
    api, runtime, controller = _ckfleet(_port_stack(), ckpt, spec_step=True)
    _reconciles(controller, 5)
    assert runtime.rolls == [] and _versions(runtime) == [9, 9]

    _commit(ckpt, 12)  # a further step, then the bump to it
    _set_spec(api, modelVersion=12)
    controller.controller.run_until_idle()
    names = [serving_api.replica_name("ckfleet", i) for i in range(2)]
    assert sorted(runtime.rolls) == names  # each replica once
    _commit(ckpt, 13)  # and another after the bump
    _reconciles(controller, 10)
    assert sorted(runtime.rolls) == names
    assert controller.rolls_total.value(deployment="ckfleet") == 2
    assert _versions(runtime) == [12, 12]
    status = api.get(serving_api.KIND, "ckfleet", "default").status
    assert status["readyReplicas"] == 2

    # A replica below the spec still rolls.
    runtime.replicas[names[1]]["version"] = 10
    _reconciles(controller, 1)
    assert runtime.rolls[-1] == names[1]
    assert len(runtime.rolls) == 3 and _versions(runtime) == [12, 12]


def test_endless_roll_of_the_jax_controller_beside_the_port(tmp_path):
    """The same sequence, modelVersion 9 on a directory holding steps 9
    to 11, through both packages' controllers, each with its own
    package's restore rule: the JAX package rolls 12 times in 5
    reconciles (each roll restores step 11 again) and goes on rolling,
    its fleet at 11; the port rolls not at all, its fleet at 9. With
    step 9 evicted, the port's replicas restore 11 and count as current:
    still no roll."""
    ckpt = tmp_path / "ckpt"
    _commit(ckpt, 9, 10, 11)
    _, jax_runtime, jax_controller = _ckfleet(_jax_stack(), ckpt, spec_step=False)
    _reconciles(jax_controller, 5)
    assert len(jax_runtime.rolls) == 12 and _versions(jax_runtime) == [11, 11]
    _reconciles(jax_controller, 5)
    assert len(jax_runtime.rolls) > 12  # it never stops
    _, runtime, controller = _ckfleet(_port_stack(), ckpt, spec_step=True)
    _reconciles(controller, 5)
    assert runtime.rolls == [] and _versions(runtime) == [9, 9]

    shutil.rmtree(ckpt / "9")
    _, runtime, controller = _ckfleet(_port_stack(), ckpt, spec_step=True)
    _reconciles(controller, 10)
    assert runtime.rolls == [] and _versions(runtime) == [11, 11]


def test_lowering_the_version_rolls_back_to_a_held_step(tmp_path):
    """A roll back: modelVersion lowered from 11 to 10, which the
    directory still holds, rolls each replica once to 10 (a version past
    the spec counts as current only when the spec's step is gone)."""
    ckpt = tmp_path / "ckpt"
    _commit(ckpt, 9, 10, 11)
    api, runtime, controller = _ckfleet(_port_stack(), ckpt, spec_step=True, model_version=11)
    _reconciles(controller, 2)
    assert runtime.rolls == [] and _versions(runtime) == [11, 11]
    _set_spec(api, modelVersion=10)
    _reconciles(controller, 5)
    assert len(runtime.rolls) == 2 and _versions(runtime) == [10, 10]


def test_scale_up_serves_the_specs_step_not_the_newest(tmp_path):
    """A replica added by a scale-up restores the spec's own step, not
    the newest one training committed since: the fleet serves one
    version, and nothing rolls."""
    ckpt = tmp_path / "ckpt"
    _commit(ckpt, 9)
    api, runtime, controller = _ckfleet(_port_stack(), ckpt, spec_step=True)
    _reconciles(controller, 1)
    _commit(ckpt, 10, 11)
    _set_spec(api, replicas=3)
    _reconciles(controller, 3)
    assert runtime.rolls == [] and _versions(runtime) == [9, 9, 9]


def test_demo_model_keeps_exact_version_equality(harness):
    """Without a checkpoint directory the version is the spec's own: a
    demo replica above the spec rolls back to it."""
    api, runtime, controller = harness
    api.create(serving_api.make_serving_deployment("fleet", replicas=1, model_version=2))
    converge(controller)
    r0 = serving_api.replica_name("fleet", 0)
    runtime.replicas[r0]["version"] = 3
    controller.controller.enqueue(("default", "fleet"))
    converge(controller)
    assert runtime.rolls == [r0]
    assert runtime.replicas[r0]["version"] == 2


@pytest.mark.parametrize("live,want,ckpt,current", [
    (11, 9, "/ckpt", True), (9, 9, "/ckpt", True), (8, 9, "/ckpt", False),
    (11, 9, "", False), (9, 9, "", True), (5, 0, "", True), (5, 0, "/ckpt", True),
    (11, 9, "holds 9", False), (9, 9, "holds 9", True), (8, 9, "holds 9", False),
    (11, 9, "damaged 9", True),
])
def test_version_current_rule(live, want, ckpt, current, tmp_path):
    """Equality, except that a checkpoint-backed replica past the spec
    is current when the directory does not hold the spec's step valid
    ("/ckpt" does not exist; "holds 9" has steps 9 and 11 verified;
    "damaged 9" has step 9 with a file that no longer matches its
    manifest)."""
    if ckpt.endswith(" 9"):
        _commit(tmp_path, 9, 11)
        if ckpt.startswith("damaged"):
            (tmp_path / "9" / "params.pt").write_bytes(b"flipped")
        ckpt = str(tmp_path)
    assert serving_api.version_current(live, want, ckpt) is current


def test_worker_does_not_reload_a_checkpoint_past_the_spec():
    """The worker loop's side of the same rule: a checkpoint-backed
    model whose live step is past the spec is not restored again at
    every heartbeat (the JAX worker restores it on every sync); a spec
    above the live step loads once."""
    from kubeflow_tpu_torch.api.objects import new_resource
    from kubeflow_tpu_torch.serving.__main__ import sync_replica_once

    api = FakeApiServer()
    api.create(new_resource(serving_api.REPLICA_KIND, "r0", "default", spec={
        "model": "resnet", "checkpointDir": "/ckpt", "modelVersion": 9}))
    repo, newest = FakeRepository(), [11]
    build = lambda rspec: FakeServable(rspec["model"], newest[0])
    for _ in range(3):
        assert sync_replica_once(api, "r0", "default", repo, build_servable=build) == 11
    assert repo.loads == 1
    robj = api.get(serving_api.REPLICA_KIND, "r0", "default").thaw()
    robj.spec = {**robj.spec, "modelVersion": 12}
    api.update(robj)
    newest[0] = 12
    for _ in range(3):
        assert sync_replica_once(api, "r0", "default", repo, build_servable=build) == 12
    assert repo.loads == 2


def test_worker_keeps_one_version_across_bumps():
    """Each load replaces the model's version (the JAX worker keeps every
    version it loaded resident, so a worker on the card grows with each
    bump): after several bumps one version is loaded, and a roll back to
    a lower version serves that version as the default. The card memory
    stamp appears exactly when CUDA is initialized."""
    import torch

    from kubeflow_tpu_torch.serving.__main__ import sync_replica_once
    from kubeflow_tpu_torch.serving.server import ModelRepository

    api = FakeApiServer()
    make_replica_object(api, version=1)
    repo = ModelRepository()
    for version in (1, 2, 3, 2):
        robj = api.get(serving_api.REPLICA_KIND, "r0", "default").thaw()
        robj.spec = {**robj.spec, "modelVersion": version}
        api.update(robj)
        assert sync_replica_once(api, "r0", "default", repo,
                                 build_servable=build_servable) == version
        assert [s.version for s in repo.versions("demo")] == [version]
        assert repo.get("demo").version == version
    status = api.get(serving_api.REPLICA_KIND, "r0", "default").status
    assert ("cudaMemoryMiB" in status) == torch.cuda.is_initialized()


def test_run_replica_wakes_on_spec_changes_not_on_status_writes(monkeypatch):
    """The worker loop syncs again on a spec push or a deletion, not on
    a status write (its own would wake it at once, and a reading that
    moves under load would be written back without end): with a slow
    heartbeat, five status writes cost no sync, a spec push costs one."""
    import kubeflow_tpu_torch.serving.__main__ as binary

    syncs = []
    real_sync = binary.sync_replica_once

    def counted(*args, **kwargs):
        syncs.append(time.monotonic())
        return real_sync(*args, **kwargs)

    monkeypatch.setattr(binary, "sync_replica_once", counted)
    api = FakeApiServer()
    make_replica_object(api, version=1)
    repo = FakeRepository()
    t = threading.Thread(
        target=binary.run_replica, args=(api, "r0", "default", repo),
        kwargs={"build_servable": build_servable, "heartbeat_s": 30.0}, daemon=True,
    )
    t.start()
    deadline = time.monotonic() + 5
    while "ready" not in api.get(serving_api.REPLICA_KIND, "r0", "default").status \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # The first status write may arrive before the worker saw its spec.
    settled = len(syncs)
    assert settled <= 2
    for n in range(5):
        robj = api.get(serving_api.REPLICA_KIND, "r0", "default").thaw()
        robj.status = {**robj.status, "probe": n}
        api.update_status(robj)
    api.flush()
    time.sleep(0.2)
    assert len(syncs) == settled
    robj = api.get(serving_api.REPLICA_KIND, "r0", "default").thaw()
    robj.spec = {**robj.spec, "modelVersion": 2}
    api.update(robj)
    deadline = time.monotonic() + 5
    while repo.models["demo"].version != 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert repo.models["demo"].version == 2 and len(syncs) == settled + 1
    api.delete(serving_api.REPLICA_KIND, "r0", "default")
    t.join(timeout=5)
    assert not t.is_alive()


def test_a_replaced_version_is_let_go_after_the_next_request():
    """On a worker's batched app, the version that a roll replaced is
    freed, without a garbage collection, once the next request prunes
    its batching queue: a rolled worker does not keep the old weights."""
    import weakref

    import numpy as np

    from kubeflow_tpu_torch.models.resnet import tiny_resnet
    from kubeflow_tpu_torch.serving import Servable
    from kubeflow_tpu_torch.serving.batching import BatchingConfig
    from kubeflow_tpu_torch.serving.server import ModelRepository, ModelServerApp
    from kubeflow_tpu_torch.web import TestClient

    def make(version):
        return Servable.from_module(
            "demo", tiny_resnet(num_classes=10, device="cpu"), version=version, max_batch=2,
            warmup_example=np.zeros((32, 32, 3), np.float32), device="cpu")

    app = ModelServerApp(ModelRepository([make(1)]),
                         batching=BatchingConfig(max_batch=2, timeout_ms=1.0))
    client = TestClient(app)
    body = {"instances": np.zeros((1, 32, 32, 3)).tolist()}
    try:
        assert client.post("/v1/models/demo:predict", body).status == 200
        old = weakref.ref(app.repository.get("demo"))
        app.repository.replace(make(2))
        assert client.post("/v1/models/demo:predict", body).status == 200
        deadline = time.monotonic() + 10
        while old() is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert old() is None
    finally:
        app.close_batchers()


def test_closing_the_apiserver_ends_its_dispatcher_and_lets_the_fleet_go():
    """A watched store runs a dispatcher thread that holds every watch
    handler: the controller, its runtime and the fleet behind it live as
    long as the process. `close()` ends the thread and drops the
    handlers; reads and writes go on, a later watch raises, and a second
    close does nothing."""
    import gc
    import weakref

    api, runtime = FakeApiServer(), FakeRuntime()
    controller = ServingDeploymentController(api, runtime=runtime)
    api.create(serving_api.make_serving_deployment("fleet", replicas=2))
    converge(controller)
    dispatcher = api._dispatcher
    assert dispatcher is not None and dispatcher.is_alive()
    refs = [weakref.ref(controller), weakref.ref(runtime)]
    del controller, runtime
    gc.collect()
    assert all(ref() is not None for ref in refs)  # the dispatcher's handlers hold them
    api.close()
    assert not dispatcher.is_alive()
    gc.collect()
    assert [ref() for ref in refs] == [None, None]
    assert dep_status(api)["readyReplicas"] == 2
    api.delete(serving_api.KIND, "fleet", "default")
    assert api.list(serving_api.KIND, "default") == []
    with pytest.raises(RuntimeError, match="closed"):
        api.watch(lambda event, obj: None)
    api.close()
