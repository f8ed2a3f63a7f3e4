"""The port's node-health watchdog (`controllers/nodehealth.py`) against
the JAX package's, and in the controller-manager binary.

First JAX's own tests (tests/test_nodehealth.py, all 6) run against the
port: the module's source with its imports pointed at the port, each
test handed its `world` (store, watchdog, TpuJob operator, fake clock)
built on the port. Then one scripted sequence of Node and Pod events
goes through both packages' `NodeHealthController` on one fake clock:
the same pod statuses, Node stamps, requeues, events and counters, the
failure message's last clause aside (the port's names no TPU slice).
The binary runs ``--controllers tpujob,nodehealth``.
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import nodehealth as j_nodehealth
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.controllers import nodehealth as t_nodehealth
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.testing.job_plane import JobPlane
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: the namespace."""
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return namespace


PORT = _jax_tests_on_the_port(REPO / "tests" / "test_nodehealth.py")
PORT_TESTS = {k: v for k, v in PORT.items() if k.startswith("test_") and callable(v)}


def test_all_of_jax_nodehealth_tests_are_ported():
    assert len(PORT_TESTS) == 6


@pytest.mark.parametrize("name", sorted(PORT_TESTS))
def test_jax_nodehealth_tests_on_the_port(name):
    api = FakeApiServer()
    clock = PORT["FakeClock"]()
    health = t_nodehealth.NodeHealthController(api, grace_seconds=30.0, clock=clock)
    try:
        PORT_TESTS[name]((api, health, TpuJobController(api), clock))
    finally:
        api.close()


# -- one scripted sequence through both watchdogs ------------------------------

# Nodes n0..n2; pods p0 (n0, Running), p1 (n1, Running), p2 (n2,
# Succeeded), p3 (n1, Pending), p4 (unbound), p5 (n2, Running). Steps:
# (seconds later, action, argument).
SCRIPT = [
    (0.0, "reconcile_all", None),
    (1.0, "not_ready", "n0"),          # stamped, requeued after the grace
    (10.0, "recheck", "n0"),           # inside the grace: requeue the rest
    (5.0, "ready", "n0"),              # back before the grace ran out
    (40.0, "recheck", "n0"),
    (1.0, "not_ready", "n1"),
    (31.0, "recheck", "n1"),           # past the grace: p1 and p3 fail
    (1.0, "delete", "n2"),             # vanished: p5 fails, p2 stays Succeeded
    (1.0, "recheck", "n1"),            # nothing left to fail
    (1.0, "recheck", "n0"),            # ready all along since: p0 keeps running
]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _run_script(pkg, new_resource, store):
    api = store()
    clock = _Clock()
    metrics = MetricsRegistry() if pkg is t_nodehealth else None
    health = pkg.NodeHealthController(api, grace_seconds=30.0, clock=clock,
                                      **({"metrics": metrics} if metrics else {}))
    for name in ("n0", "n1", "n2"):
        node = new_resource("Node", name, spec={"pool": "p", "chips": 1})
        api.create(node)
        fresh = api.get("Node", name).thaw()
        fresh.status["ready"] = True
        api.update_status(fresh)
    pods = {"p0": ("n0", "Running"), "p1": ("n1", "Running"), "p2": ("n2", "Succeeded"),
            "p3": ("n1", "Pending"), "p4": (None, "Running"), "p5": ("n2", "Running")}
    for name, (node, phase) in pods.items():
        api.create(new_resource("Pod", name, "ml",
                                spec={"nodeName": node} if node else {}))
        fresh = api.get("Pod", name, "ml").thaw()
        fresh.status["phase"] = phase
        api.update_status(fresh)
    trace = []
    for dt, action, arg in SCRIPT:
        clock.t += dt
        if action in ("not_ready", "ready"):
            fresh = api.get("Node", arg).thaw()
            fresh.status["ready"] = action == "ready"
            api.update_status(fresh)
        elif action == "delete":
            api.delete("Node", arg)
        results = []
        keys = [("default", n) for n in ("n0", "n1", "n2")] if action == "reconcile_all" \
            else [("default", arg)]
        for key in keys:
            results.append(health.reconcile(api, key).requeue_after)
        nodes = {n.metadata.name: (n.status.get("ready"), n.status.get("notReadySince"))
                 for n in api.list("Node")}
        statuses = {p.metadata.name: (p.status.get("phase"), p.status.get("reason"),
                                      p.status.get("message", "").split(";")[0])
                    for p in api.list("Pod", "ml")}
        trace.append((action, arg, results, nodes, statuses))
    events = sorted((e.spec["involvedObject"]["name"], e.spec["reason"], e.spec["type"],
                     e.spec["message"]) for e in api.list("Event", "ml"))
    counters = (health.nodes_lost.value(),
                {n: health.pods_failed.value(node=n) for n in ("n0", "n1", "n2")})
    messages = {p.metadata.name: p.status.get("message") for p in api.list("Pod", "ml")}
    api.close() if hasattr(api, "close") else None
    return trace, events, counters, messages


def test_scripted_sequence_equals_jax():
    want = _run_script(j_nodehealth, j_new_resource, JFakeApiServer)
    got = _run_script(t_nodehealth, t_new_resource, FakeApiServer)
    assert got[:3] == want[:3]
    failed = {name for name, (phase, reason, _) in got[0][-1][-1].items()
              if reason == t_nodehealth.REASON_NODE_LOST}
    assert failed == {"p1", "p3", "p5"}
    assert got[2] == (2.0, {"n0": 0.0, "n1": 2.0, "n2": 1.0})
    for name in failed:
        assert got[3][name].endswith("the gang lost a member")
        assert want[3][name].endswith("TPU slice integrity lost")


# -- the binary ---------------------------------------------------------------


def test_binary_runs_tpujob_and_nodehealth():
    with JobPlane(controllers=("tpujob", "nodehealth"), run_pods=False) as plane:
        assert "manager ready tpujob,nodehealth" in plane.manager_output
        plane.add_node("n0")
        plane.api.create(t_new_resource("Pod", "w0", "default", spec={"nodeName": "n0"}))
        fresh = plane.api.get("Pod", "w0").thaw()
        fresh.status["phase"] = "Running"
        plane.api.update_status(fresh)
        assert plane.lose_node("n0") == []  # no runner process to kill
        plane.run_until(lambda: plane.api.get("Pod", "w0").status.get("reason")
                        == t_nodehealth.REASON_NODE_LOST, 30, "the pod to fail NodeLost")
        assert plane.api.get("Pod", "w0").status["phase"] == "Failed"
        events = [e for e in plane.api.list("Event", "default")
                  if e.spec["reason"] == t_nodehealth.REASON_NODE_LOST]
        assert len(events) == 1 and events[0].spec["type"] == "Warning"
        assert plane.stop_manager() == 0
