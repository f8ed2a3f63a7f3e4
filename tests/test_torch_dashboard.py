"""The port's central dashboard (`apps/dashboard.py`) against the JAX
package's.

- JAX's own tests/test_dashboard.py runs against the port, every case,
  its imports pointed at the port.
- One script of requests (the workgroup flow: exists, create, env-info,
  namespaces, get-all-namespaces, nuke-self; activities, workloads with
  their GPU asks, the metrics series, the links and their ConfigMap
  override, refusals) by two users and an admin goes through both
  packages' dashboards on stores with the Profile controller: the same
  statuses and bodies (the JAX wire names included), and the same
  objects after every request. Two values differ by design: env-info's
  platform provider (``gpu``, not ``tpu``) and the built-in links' text
  (the port's notebooks are PyTorch's).
"""

import re
from pathlib import Path

from kubeflow_tpu.api import make_tpujob as j_make_tpujob
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.api.rbac import make_cluster_role_binding as j_make_cluster_role_binding
from kubeflow_tpu.api.rbac import seed_cluster_roles as j_seed_cluster_roles
from kubeflow_tpu.apps.dashboard import DashboardApp as JDashboardApp
from kubeflow_tpu.controllers.profile import ProfileController as JProfileController
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import make_cluster_role_binding, seed_cluster_roles
from kubeflow_tpu_torch.apps.dashboard import DashboardApp
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import TestClient

REPO = Path(__file__).resolve().parents[1]
HDR = "x-goog-authenticated-user-email"
VOLATILE = {"uid", "creationTimestamp", "resourceVersion", "timestamp", "created", "age",
            "deletionTimestamp", "lastTransitionTime"}


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_dashboard")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_dashboard_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 11


def norm(obj):
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def snapshot(api) -> list:
    """Every object but its ids and clocks (an Event's name is derived
    from its object's uid)."""
    return sorted(
        (kind, o.metadata.namespace, "" if kind == "Event" else o.metadata.name,
         norm(o.spec), norm(o.status), o.metadata.labels, o.metadata.annotations)
        for kind in api.kinds() for o in api.list(kind))


SCRIPT = [
    ("alice@x.co", "GET", "/api/workgroup/exists", None),
    ("alice@x.co", "POST", "/api/workgroup/create", {}),
    ("bob@x.co", "POST", "/api/workgroup/create", {"namespace": "team-b"}),
    ("alice@x.co", "GET", "/api/workgroup/exists", None),
    ("alice@x.co", "GET", "/api/workgroup/env-info", None),
    ("admin@x.co", "GET", "/api/workgroup/env-info", None),
    ("alice@x.co", "GET", "/api/namespaces", None),
    ("alice@x.co", "GET", "/api/activities/alice", None),
    ("bob@x.co", "GET", "/api/activities/alice", None),
    ("alice@x.co", "GET", "/api/workloads/alice", None),
    ("bob@x.co", "GET", "/api/workloads/alice", None),
    ("alice@x.co", "GET", "/api/metrics/tpuduty", None),
    ("alice@x.co", "GET", "/api/metrics/nodecpu?window=5", None),
    ("alice@x.co", "GET", "/api/metrics/gpuduty", None),
    ("alice@x.co", "GET", "/api/metrics/nodemem?window=x", None),
    ("alice@x.co", "GET", "/api/dashboard-links", None),
    ("alice@x.co", "GET", "/api/workgroup/get-all-namespaces", None),
    ("admin@x.co", "GET", "/api/workgroup/get-all-namespaces", None),
    ("admin@x.co", "GET", "/api/dashboard-links", None),
    ("carol@x.co", "DELETE", "/api/workgroup/nuke-self", None),
    ("bob@x.co", "DELETE", "/api/workgroup/nuke-self", None),
    ("bob@x.co", "GET", "/api/workgroup/exists", None),
    (None, "GET", "/api/namespaces", None),
]


def _run(store_cls, new, make_job, seed_roles, make_crb, ctl_cls, app_cls, client_cls,
         provider: str) -> list:
    api = store_cls()
    seed_roles(api)
    api.create(make_crb("adm", "kubeflow-admin", "admin@x.co"))
    for i, duty in enumerate((0.5, None)):
        node = new("Node", f"gpu-node-{i}", "", spec={"chips": 1})
        node.status = {"ready": True, "cpuUtilization": 0.25, "memoryUtilization": 0.5,
                       **({"tpuDutyCycle": duty} if duty is not None else {})}
        api.create(node)
    ctl = ctl_cls(api)
    app = app_cls(api)
    out = []
    for i, (user, method, path, body) in enumerate(SCRIPT):
        if i == 7:  # workloads and an event in alice's namespace
            job = api.create(make_job("train", namespace="alice", replicas=2,
                                      tpu_chips_per_worker=1, command=("python",)))
            api.record_event(job, "Created", "job created")
            api.create(new("Workflow", "ci", "alice", spec={"steps": []}))
        if i == 18:
            api.create(new("ConfigMap", "dashboard-links", "kubeflow",
                           spec={"data": {"menuLinks": [{"link": "/x", "text": "X"}]}}))
        headers = {HDR: f"accounts.google.com:{user}"} if user else {}
        resp = client_cls(app, headers=headers).request(method, path, body=body)
        ctl.controller.run_until_idle()
        payload = norm(resp.json())
        if path == "/api/workgroup/env-info" and resp.status == 200:
            assert payload["platform"].pop("provider") == provider
        if path == "/api/dashboard-links" and "quickLinks" in payload:
            payload = {k: [{f: v for f, v in link.items() if f != "text"} for link in links]
                       for k, links in payload.items()}
        out.append((method, path, resp.status, payload, snapshot(api)))
    api.close()
    return out


def test_dashboard_script_matches_jax():
    port = _run(FakeApiServer, new_resource, make_tpujob, seed_cluster_roles,
                make_cluster_role_binding, ProfileController, DashboardApp, TestClient, "gpu")
    jax = _run(JFakeApiServer, j_new_resource, j_make_tpujob, j_seed_cluster_roles,
               j_make_cluster_role_binding, JProfileController, JDashboardApp, JTestClient,
               "tpu")
    for step, (got, want) in enumerate(zip(port, jax)):
        assert got == want, f"step {step}: {SCRIPT[step]}"
    workloads = port[9][3]
    assert {r["name"]: r["chips"] for r in workloads} == {"train": 2, "ci": None}
    assert [s for _, _, s, _, _ in port] == [200, 200, 200, 200, 200, 200, 200, 200, 403, 200,
                                             403, 200, 200, 400, 400, 200, 403, 200, 200, 404,
                                             200, 200, 401]
