"""The port's TpuJob operator (`kubeflow_tpu_torch/controllers/tpujob.py`),
and its CRD (`api/tpujob.py`) against the JAX package's.

First JAX's own operator tests (tests/test_tpujob_controller.py) run
against the port: the module's source with its imports pointed at the
port, every test but the pod-env one, whose port version below spells
out the accelerator translation. Then the same CRs go into both
packages' `FakeApiServer` + `TpuJobController` and the objects and
status sequences are held equal, exactly, modulo that translation — the
only difference allowed between the two operators' pods:

- the JAX pod asks ``google.com/tpu: n``, the port's ``nvidia.com/gpu: n``;
- the JAX pod carries libtpu's TPU_WORKER_ID and TPU_WORKER_HOSTNAMES,
  the port's does not.

With Node objects, the port's placement (its compiled scheduler, counted
``native``) gives JAX's nodeNames (JAX's operator is handed its
`PyGangScheduler`); the schedulers themselves are held to each other in
tests/test_torch_native_scheduler.py. The port admits and runs a
gang's priority (its preemption is held against JAX's in
tests/test_torch_tpujob_priority.py) and refuses what it cannot run yet,
elastic resize, at admission and in reconcile, never ignoring it.
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.api import make_tpujob as j_make_tpujob
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import tpujob as j_tpujob
from kubeflow_tpu.native.scheduler import PyGangScheduler as JPyGangScheduler
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.api.tpujob import TpuJobSpec, make_tpujob as t_make_tpujob
from kubeflow_tpu_torch.controllers import tpujob as t_tpujob
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, Invalid
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]
JAX_ONLY_TPU_ENV = ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES")


def _jax_tests_on_the_port(path: Path, skip: tuple[str, ...] = ()) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.` (the port's `testing` package
    exports nothing, so its store is named by module): its test
    functions by name."""
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") and callable(v) and k not in skip}


JAX_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_tpujob_controller.py",
                                   skip=("test_gang_creation_and_env",))


@pytest.mark.parametrize("name", sorted(JAX_TESTS))
def test_jax_operator_tests_on_the_port(name):
    fn = JAX_TESTS[name]
    args = {}
    if "api" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        args["api"] = FakeApiServer()
        args["ctl"] = t_tpujob.TpuJobController(args["api"])
    fn(**args)


def test_gang_creation_and_env_with_the_accelerator_translation():
    api = FakeApiServer()
    ctl = t_tpujob.TpuJobController(api)
    api.create(t_make_tpujob("mnist", replicas=4, tpu_chips_per_worker=4,
                             topology="4x4", num_slices=2))
    ctl.controller.run_until_idle()
    assert len(api.list("Pod", label_selector={t_tpujob.LABEL_JOB: "mnist"})) == 4
    assert api.get("Service", "mnist").spec["clusterIP"] == "None"
    pod = api.get("Pod", "mnist-worker-2")
    env = {e["name"]: e["value"] for e in pod.spec["containers"][0]["env"]}
    assert env["TPUJOB_NUM_PROCESSES"] == "4"
    assert env["TPUJOB_PROCESS_ID"] == "2"
    assert env["TPUJOB_NUM_SLICES"] == "2"
    assert env["TPUJOB_SLICE_ID"] == "1"
    assert env["TPUJOB_COORDINATOR"].startswith("mnist-worker-0.mnist")
    assert env["TPUJOB_NAME"] == "mnist" and env["TPUJOB_NAMESPACE"] == "default"
    assert not set(JAX_ONLY_TPU_ENV) & set(env)
    limits = pod.spec["containers"][0]["resources"]["limits"]
    assert limits == {"nvidia.com/gpu": 4}
    assert pod.spec["nodeSelector"] == {"cloud.google.com/gke-tpu-topology": "4x4"}
    assert api.get("TpuJob", "mnist").status["phase"] == "Pending"


# -- the same CRs through both operators -------------------------------------


def _translate_jax_pod(d: dict) -> dict:
    """JAX's pod dict as the port's operator builds it: the accelerator
    translation, and nothing else."""
    for c in d["spec"]["containers"]:
        c["env"] = [e for e in c["env"] if e["name"] not in JAX_ONLY_TPU_ENV]
        limits = c["resources"]["limits"]
        if "google.com/tpu" in limits:
            limits["nvidia.com/gpu"] = limits.pop("google.com/tpu")
    return d


def _plain(obj) -> dict:
    """An object's dict without what each store stamps on its own (uids,
    resource versions, timestamps, the owner's uid)."""
    d = obj.to_dict()
    meta = d["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation",
              "deletionTimestamp", "finalizers"):
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    d.pop("apiVersion", None)
    return d


class Pair:
    """One JAX and one port operator, each on its own store, driven by
    the same scripted steps; `snapshot()` reads both sides."""

    def __init__(self, nodes=()):
        self.j_api, self.t_api = JFakeApiServer(), FakeApiServer()
        for name, spec in nodes:
            self.j_api.create(j_new_resource("Node", name, "", spec=dict(spec)))
            self.t_api.create(t_new_resource("Node", name, "", spec=dict(spec)))
        self.j_ctl = j_tpujob.TpuJobController(self.j_api, scheduler=JPyGangScheduler)
        self.t_ctl = t_tpujob.TpuJobController(self.t_api)

    def create(self, name, **spec):
        self.j_api.create(j_make_tpujob(name, **spec))
        self.t_api.create(t_make_tpujob(name, **spec))
        return self.drain()

    def drain(self):
        self.j_ctl.controller.run_until_idle()
        self.t_ctl.controller.run_until_idle()
        return self.snapshot()

    def set_phase(self, pod, phase):
        for api in (self.j_api, self.t_api):
            p = api.get("Pod", pod).thaw()
            p.status["phase"] = phase
            api.update_status(p)
        return self.drain()

    def delete(self, kind, name):
        self.j_api.delete(kind, name)
        self.t_api.delete(kind, name)
        return self.drain()

    def snapshot(self):
        def side(api, translate):
            pods = [_plain(p) for p in api.list("Pod")]
            if translate:
                pods = [_translate_jax_pod(p) for p in pods]
            events = sorted((e.spec["reason"], e.spec["message"], e.spec["type"])
                            for e in api.list("Event"))
            return {
                "jobs": [_plain(j) for j in api.list("TpuJob")],
                "pods": pods,
                "services": [_plain(s) for s in api.list("Service")],
                "events": events,
            }

        return side(self.j_api, True), side(self.t_api, False)


def _same(pair_snapshot):
    want, got = pair_snapshot
    assert got == want
    return got


def test_pods_and_service_equal_jax_but_for_the_accelerator():
    pair = Pair()
    spec = dict(replicas=4, tpu_chips_per_worker=2, topology="2x4", num_slices=2,
                command=("python", "-m", "train"), args=("--steps", "8"),
                env=(("KFTPU_X", "1"),), resources=(("cpu", "500m"), ("memory", "2Gi")),
                max_restarts=2, image="worker:1")
    got = _same(pair.create("lm", **spec))
    assert len(got["pods"]) == 4 and len(got["services"]) == 1
    # The difference, spelled out on the raw JAX pod.
    raw = pair.j_api.get("Pod", "lm-worker-3").to_dict()["spec"]["containers"][0]
    assert raw["resources"]["limits"]["google.com/tpu"] == 2
    assert {e["name"] for e in raw["env"]} >= set(JAX_ONLY_TPU_ENV)
    port = pair.t_api.get("Pod", "lm-worker-3").spec["containers"][0]
    assert port["resources"]["limits"] == {"nvidia.com/gpu": 2, "cpu": "500m",
                                           "memory": "2Gi"}
    # No accelerator asked, none named.
    pair2 = Pair()
    got = _same(pair2.create("cpu-job", replicas=1, tpu_chips_per_worker=0))
    assert got["pods"][0]["spec"]["containers"][0]["resources"]["limits"] == {}


def test_status_sequence_restart_then_succeed_equals_jax():
    pair = Pair()
    seq = [_same(pair.create("j", replicas=3, max_restarts=2))]
    for i in range(3):
        seq.append(_same(pair.set_phase(f"j-worker-{i}", "Running")))
    seq.append(_same(pair.set_phase("j-worker-1", "Failed")))
    job = seq[-1]["jobs"][0]
    # Torn down, recreated as incarnation 1 and back to Pending in one drain.
    assert job["status"]["restarts"] == 1 and job["status"]["phase"] == "Pending"
    pods = seq[-1]["pods"]
    assert {p["metadata"]["labels"][t_tpujob.LABEL_INCARNATION] for p in pods} == {"1"}
    for i in range(3):
        seq.append(_same(pair.set_phase(f"j-worker-{i}", "Running")))
    for i in range(3):
        seq.append(_same(pair.set_phase(f"j-worker-{i}", "Succeeded")))
    status = seq[-1]["jobs"][0]["status"]
    assert status["phase"] == "Succeeded"
    assert [c["type"] for c in status["conditions"]] == [
        "Pending", "Running", "Restarting", "Pending", "Running", "Succeeded"]


def test_status_sequence_max_restarts_exhausted_equals_jax():
    pair = Pair()
    _same(pair.create("j", replicas=2, max_restarts=1))
    _same(pair.set_phase("j-worker-0", "Failed"))
    got = _same(pair.set_phase("j-worker-1", "Failed"))
    assert got["jobs"][0]["status"]["phase"] == "Failed"
    assert any(e[0] == "JobFailed" for e in got["events"])
    # Terminal: a later pod event changes nothing on either side.
    _same(pair.set_phase("j-worker-0", "Succeeded"))


def test_partial_gang_torn_down_equals_jax():
    pair = Pair()
    _same(pair.create("j", replicas=3))
    _same(pair.set_phase("j-worker-0", "Running"))
    got = _same(pair.delete("Pod", "j-worker-1"))
    assert len(got["pods"]) == 3
    assert all("phase" not in p["status"] for p in got["pods"])
    assert any(e[0] == "GangTornDown" for e in got["events"])


def test_invalid_stored_spec_fails_equals_jax():
    pair = Pair()
    for api in (pair.j_api, pair.t_api):
        api.create(t_new_resource("TpuJob", "bad", spec={"replicas": 2, "templat": {}})
                   if api is pair.t_api else
                   j_new_resource("TpuJob", "bad", spec={"replicas": 2, "templat": {}}))
    got = _same(pair.drain())
    assert got["jobs"][0]["status"]["phase"] == "Failed"


NODES = [(f"n{i}", {"pool": "v5e-4x2", "x": i % 4, "y": i // 4, "chips": 4})
         for i in range(8)] + [(f"m{i}", {"pool": "line", "x": i, "chips": 8})
                               for i in range(4)]


def test_placement_equals_jax_scheduler():
    pair = Pair(NODES)
    got = _same(pair.create("a", replicas=3, tpu_chips_per_worker=4, topology="v5e-4x2"))
    assert sorted(p["spec"]["nodeName"] for p in got["pods"]) == ["n0", "n1", "n2"]
    _same(pair.create("b", replicas=4, tpu_chips_per_worker=4))  # topology-less
    _same(pair.create("c", replicas=2, tpu_chips_per_worker=2, topology="v5e-4x2"))
    got = _same(pair.create("d", replicas=9, tpu_chips_per_worker=4, topology="v5e-4x2"))
    job = [j for j in got["jobs"] if j["metadata"]["name"] == "d"][0]
    assert job["status"]["reason"] == "Unschedulable"
    assert pair.t_ctl.gang_placements.value(backend="native") == 3
    assert pair.t_ctl.gang_placements.value(backend="python") == 0
    # Finishing "a" frees its nodes; a waiting gang places when retried.
    for i in range(3):
        _same(pair.set_phase(f"a-worker-{i}", "Succeeded"))


# -- what the port refuses ----------------------------------------------------


@pytest.mark.parametrize("field, value, missing", [
    ("elasticMinReplicas", 1, "elastic gang resize"),
    ("elasticMinReplicas", 2, "elastic gang resize"),
])
def test_admission_refuses_unported_fields(field, value, missing):
    api = FakeApiServer()
    t_tpujob.register_admission(api)
    job = t_make_tpujob("j", replicas=2)
    job.spec[field] = value
    with pytest.raises(Invalid, match=missing):
        api.create(job)
    assert api.list("TpuJob") == []
    # The same refusal through the HTTP facade: a 422.
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    client = HttpApiClient(f"http://127.0.0.1:{server.server_port}")
    try:
        with pytest.raises(Invalid, match="not ported"):
            client.create(job)
        # A valid job passes admission, and an update that adds the
        # field is refused too.
        client.create(t_make_tpujob("ok", replicas=2))
        stored = client.get("TpuJob", "ok").thaw()
        stored.spec = {**stored.spec, field: value}
        with pytest.raises(Invalid, match=missing):
            client.update(stored)
    finally:
        client.close()
        server.shutdown()


@pytest.mark.parametrize("priority", [5, -1])
def test_admission_admits_a_priority_and_the_operator_runs_it(priority):
    """A priority is no longer refused: admitted at the store and through
    the facade, then ganged by the operator like any job."""
    api = FakeApiServer()
    t_tpujob.register_admission(api)
    ctl = t_tpujob.TpuJobController(api)
    api.create(t_make_tpujob("j", replicas=2, priority=priority))
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    client = HttpApiClient(f"http://127.0.0.1:{server.server_port}")
    try:
        client.create(t_make_tpujob("k", replicas=1, priority=priority))
        stored = client.get("TpuJob", "k").thaw()
        stored.spec = {**stored.spec, "priority": priority + 1}
        client.update(stored)
    finally:
        client.close()
        server.shutdown()
    ctl.controller.run_until_idle()
    assert api.get("TpuJob", "k").spec["priority"] == priority + 1
    for name, replicas in (("j", 2), ("k", 1)):
        assert api.get("TpuJob", name).status["phase"] == "Pending"
        assert len(api.list("Pod", label_selector={t_tpujob.LABEL_JOB: name})) == replicas
    assert not [e for e in api.list("Event") if e.spec["reason"] == "Unsupported"]


@pytest.mark.parametrize("field, value", [("elasticMinReplicas", 1), ("elasticMinReplicas", 2)])
def test_reconcile_fails_unported_fields_it_was_handed(field, value):
    """A store without the admission hook: the operator fails the job
    with an Unsupported event and creates no pod."""
    api = FakeApiServer()
    ctl = t_tpujob.TpuJobController(api)
    job = t_make_tpujob("j", replicas=2)
    job.spec[field] = value
    api.create(job)
    ctl.controller.run_until_idle()
    assert api.get("TpuJob", "j").status["phase"] == "Failed"
    assert api.list("Pod") == []
    events = [e.spec for e in api.list("Event")]
    assert [e["reason"] for e in events] == ["Unsupported"]
    assert "not ported" in events[0]["message"]


def test_spec_parses_the_jax_fields_and_refuses_a_gpu_resource():
    spec = TpuJobSpec.from_dict({"priority": 2, "elasticMinReplicas": 1, "replicas": 2})
    assert spec.priority == 2 and spec.elastic_min_replicas == 1
    assert len(spec.unported_fields()) == 1
    assert "elasticMinReplicas" in spec.unported_fields()[0]
    assert TpuJobSpec.from_dict({"priority": 7}).unported_fields() == []
    assert TpuJobSpec().unported_fields() == []
    with pytest.raises(ValueError, match="chipsPerWorker"):
        TpuJobSpec.from_dict({"resources": {"nvidia.com/gpu": 1}})
    with pytest.raises(ValueError, match="chipsPerWorker"):
        TpuJobSpec.from_dict({"resources": {"google.com/tpu": 1}})
    with pytest.raises(ValueError, match="quantity"):
        TpuJobSpec.from_dict({"resources": {"cpu": "-1"}})
