"""ResourceQuota admission in the port (`kubeflow_tpu_torch/controllers/
quota.py`, with `api/rbac.resource_for_kind` and
`api/objects.container_resource_total`) against the JAX package's.

- JAX's own tests (tests/test_quota.py, every parametrised case) run
  against the port, the module's source with its imports pointed at the
  port and `google.com/tpu` read as `nvidia.com/gpu`, the accelerator
  translation: compute requests and limits in milli-units, object
  counts, storage, status.used, updates that do not count themselves,
  and the TpuJob operator's QuotaExceeded episode for a gang over its
  accelerator cap and over its memory cap, and the workload
  materializer's containment of a quota rejection (one PodRejected
  Warning, the other workload still materialized).
- One seeded sequence of pod and PVC creates, updates, phase changes and
  deletes under mixed caps goes through both packages' stores with quota
  registered: the same admissions, the same refusals (messages equal
  modulo the translation) and the same status.used, exactly.
- A TpuJob's workers are metered by the accelerator they ask for: a
  tenant capped at one GPU runs one gang of one GPU; a second holds a
  QuotaExceeded episode until the first is gone. A `google.com/tpu` cap
  meters nothing on the port (no pod asks for it), as a cap on any
  resource class the cluster does not run.
"""

import random
import re
import time
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import quota as j_quota
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers import quota
from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB, TpuJobController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.` and the TPU resource read as the
    GPU: each test case by id, as (function, arguments)."""
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    cases = {}
    for name, fn in namespace.items():
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            cases[name] = (fn, {})
            continue
        (argnames, argvalues), = [m.args for m in marks]
        names = [a.strip() for a in argnames.split(",")]
        for i, values in enumerate(argvalues):
            values = values if len(names) > 1 else (values,)
            cases[f"{name}[{i}]"] = (fn, dict(zip(names, values)))
    return cases


JAX_CASES = _jax_tests_on_the_port(REPO / "tests" / "test_quota.py")


def test_all_of_jax_quota_tests_are_collected():
    functions = {case.split("[")[0] for case in JAX_CASES}
    assert len(functions) == 26
    assert len(JAX_CASES) == 25 + 15 + 7 - 1


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_quota_tests_on_the_port(case):
    fn, kwargs = JAX_CASES[case]
    fn(**kwargs)


# -- one seeded sequence through both stores -------------------------------------

CAPS = [
    {"cpu": "2", "pods": 4},
    {"requests.memory": "3Gi", "limits.cpu": "3", "ACC": 3},
    {"requests.ACC": 2, "persistentvolumeclaims": 2, "requests.storage": "25Gi"},
    {"memory": "5Gi", "count/pods": 3},
]


def _rename(value, old: str, new: str):
    """`value` with `old` in its dict keys replaced by `new`: the seeded
    sequence's accelerator ("ACC") as each package names it, and back."""
    if isinstance(value, dict):
        return {k.replace(old, new): _rename(v, old, new) for k, v in value.items()}
    if isinstance(value, list):
        return [_rename(v, old, new) for v in value]
    return value


def _sequence(seed: int, n: int):
    rng = random.Random(seed)
    figures = {"cpu": ["250m", "500m", "1", "1500m"], "memory": ["512Mi", "1Gi", "2Gi"],
               "ACC": [1, 2]}
    ops = []
    for i in range(n):
        ns = f"t{rng.randrange(len(CAPS))}"
        r = rng.random()
        if r < 0.55:
            res = {}
            for src in ("requests", "limits"):
                picked = {k: rng.choice(v) for k, v in figures.items() if rng.random() < 0.5}
                if picked:
                    res[src] = picked
            ops.append(("pod", ns, f"p{i}", res))
        elif r < 0.7:
            ops.append(("pvc", ns, f"v{i}", rng.choice(["5Gi", "10Gi", "20Gi"])))
        elif r < 0.85:
            ops.append(("phase", ns, rng.random(), rng.choice(["Succeeded", "Failed"])))
        else:
            ops.append(("delete", ns, rng.random(), None))
    return ops


def _apply(api, new, accelerator: str, op):
    kind, ns, name, arg = op
    if kind == "pod":
        spec = {"containers": [{"name": "w", "resources": _rename(arg, "ACC", accelerator)}]}
        return api.create(new("Pod", name, ns, spec=spec))
    if kind == "pvc":
        return api.create(new("PersistentVolumeClaim", name, ns,
                              spec={"resources": {"requests": {"storage": arg}}}))
    pods = [p for p in api.list("Pod", ns) if p.status.get("phase") is None]
    if not pods:
        return None
    pod = pods[int(name * len(pods))]
    if kind == "delete":
        return api.delete("Pod", pod.metadata.name, ns)
    pod = pod.thaw()
    pod.status["phase"] = arg
    return api.update_status(pod)


def _outcome(api, new, accelerator: str, op) -> str:
    try:
        _apply(api, new, accelerator, op)
        return "ok"
    except Exception as e:  # each store raises its own ApiError classes
        return f"{type(e).__name__}: {e}".replace(accelerator, "ACC")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_same_admissions_and_usage_as_jax(seed):
    j_api, t_api = JFakeApiServer(), FakeApiServer()
    j_quota.register(j_api)
    quota.register(t_api)
    for i, hard in enumerate(CAPS):
        j_api.create(j_new_resource("ResourceQuota", j_quota.QUOTA_NAME, f"t{i}",
                                    spec={"hard": _rename(hard, "ACC", "google.com/tpu")}))
        t_api.create(new_resource("ResourceQuota", quota.QUOTA_NAME, f"t{i}",
                                  spec={"hard": _rename(hard, "ACC", "nvidia.com/gpu")}))
    outcomes = []
    for op in _sequence(seed, 120):
        want = _outcome(j_api, j_new_resource, "google.com/tpu", op)
        got = _outcome(t_api, new_resource, "nvidia.com/gpu", op)
        assert got == want, op
        outcomes.append(got)
        for i, hard in enumerate(CAPS):
            want_used = j_quota.compute_used(j_api, f"t{i}",
                                             _rename(hard, "ACC", "google.com/tpu"))
            got_used = quota.compute_used(t_api, f"t{i}", _rename(hard, "ACC", "nvidia.com/gpu"))
            assert _rename(got_used, "nvidia.com/gpu", "ACC") == _rename(
                want_used, "google.com/tpu", "ACC")
    assert outcomes.count("ok") >= 20
    assert sum(o.startswith("QuotaExceeded") for o in outcomes) >= 10
    # The published status converges to the same usage on both sides.
    deadline = time.monotonic() + 10
    while True:
        j_api.flush()
        t_api.flush()
        j_used = [j_api.get("ResourceQuota", j_quota.QUOTA_NAME, f"t{i}").status.get("used")
                  for i in range(len(CAPS))]
        t_used = [t_api.get("ResourceQuota", quota.QUOTA_NAME, f"t{i}").status.get("used")
                  for i in range(len(CAPS))]
        t_as_jax = [_rename(u or {}, "nvidia.com/gpu", "google.com/tpu") for u in t_used]
        if t_as_jax == [u or {} for u in j_used] and all(t_used):
            break
        assert time.monotonic() < deadline, (j_used, t_used)
        time.sleep(0.05)
    t_api.close()


# -- the accelerator a TpuJob's workers ask for ---------------------------------


def _gang(name: str, ns: str):
    return make_tpujob(name, namespace=ns, replicas=1, tpu_chips_per_worker=1,
                       command=("true",))


def test_tpujob_workers_are_metered_by_the_gpu_they_ask_for():
    api = FakeApiServer()
    quota.register(api)
    api.create(new_resource("ResourceQuota", quota.QUOTA_NAME, "team-a",
                            spec={"hard": {"nvidia.com/gpu": 1}}))
    ctl = TpuJobController(api, quota_retry_seconds=0.05)
    api.create(_gang("first", "team-a"))
    api.create(_gang("second", "team-a"))
    for _ in range(4):
        ctl.controller.run_until_idle()
    assert len(api.list("Pod", "team-a", label_selector={LABEL_JOB: "first"})) == 1
    second = api.get("TpuJob", "second", "team-a")
    assert (second.status["phase"], second.status["reason"]) == ("Pending", "QuotaExceeded")
    assert api.list("Pod", "team-a", label_selector={LABEL_JOB: "second"}) == []
    warnings = [e.spec for e in api.list("Event", "team-a")
                if e.spec["reason"] == "QuotaExceeded"]
    assert len(warnings) == 1 and "'nvidia.com/gpu'" in warnings[0]["message"]
    rq = api.get("ResourceQuota", quota.QUOTA_NAME, "team-a")
    deadline = time.monotonic() + 5
    while rq.status.get("used", {}).get("nvidia.com/gpu") != 1:
        assert time.monotonic() < deadline, rq.status
        time.sleep(0.02)
        api.flush()
        rq = api.get("ResourceQuota", quota.QUOTA_NAME, "team-a")
    # The first gang finishes: the second starts on its next retry, and
    # the episode ends with no second Warning.
    pod = api.list("Pod", "team-a", label_selector={LABEL_JOB: "first"})[0].thaw()
    pod.status["phase"] = "Succeeded"
    api.update_status(pod)
    ctl.controller.run_until_idle()
    time.sleep(0.1)
    ctl.controller.enqueue(("team-a", "second"))
    for _ in range(4):
        ctl.controller.run_until_idle()
    second = api.get("TpuJob", "second", "team-a")
    assert len(api.list("Pod", "team-a", label_selector={LABEL_JOB: "second"})) == 1
    assert second.status.get("reason") is None and "quotaRetryAt" not in second.status
    assert sum(e.spec["reason"] == "QuotaExceeded" for e in api.list("Event", "team-a")) == 1
    api.close()


def test_a_tpu_cap_meters_nothing_on_the_port():
    api = FakeApiServer()
    quota.register(api)
    api.create(new_resource("ResourceQuota", quota.QUOTA_NAME, "team-a",
                            spec={"hard": {"google.com/tpu": 0, "nvidia.com/gpu": 2}}))
    ctl = TpuJobController(api)
    api.create(_gang("first", "team-a"))
    ctl.controller.run_until_idle()
    assert len(api.list("Pod", "team-a")) == 1
    assert quota.compute_used(api, "team-a", {"google.com/tpu": 0, "nvidia.com/gpu": 2}) == {
        "nvidia.com/gpu": 1}
    api.close()


def test_publisher_thread_ends_when_the_store_closes():
    import threading

    before = set(threading.enumerate())
    api = FakeApiServer()
    quota.register(api)
    ours, = [t for t in set(threading.enumerate()) - before
             if t.name == "quota-status-publisher"]
    api.close()
    ours.join(timeout=5)
    assert not ours.is_alive()
