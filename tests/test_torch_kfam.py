"""The port's access management app (`apps/kfam.py`, with
`apps/common.py`) against the JAX package's.

- JAX's own tests/test_kfam.py runs against the port, every case, its
  imports pointed at the port.
- One script of requests by an admin, two profile owners and a
  stranger (profiles created for oneself and for others, contributor
  bindings edit and view, reads scoped and not, unsupported roles,
  deletes, the cluster-admin query) goes through both packages' kfam on
  stores with the Profile controller: the same statuses and bodies, and
  the same objects after every request.
"""

import re
from pathlib import Path

from kubeflow_tpu.api.rbac import make_cluster_role_binding as j_make_cluster_role_binding
from kubeflow_tpu.api.rbac import seed_cluster_roles as j_seed_cluster_roles
from kubeflow_tpu.apps.kfam import KfamApp as JKfamApp
from kubeflow_tpu.controllers.profile import ProfileController as JProfileController
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu_torch.api.rbac import make_cluster_role_binding, seed_cluster_roles
from kubeflow_tpu_torch.apps.kfam import KfamApp
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import TestClient

REPO = Path(__file__).resolve().parents[1]
HDR = "x-goog-authenticated-user-email"
# Fields that differ between any two runs: ids and clocks.
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


JAX_TESTS = _jax_tests_on_the_port("test_kfam")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_kfam_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 11


def norm(obj):
    """`obj` without ids and clocks (and owner uids)."""
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def snapshot(api) -> list:
    return sorted(
        (kind, o.metadata.namespace, o.metadata.name, norm(o.spec), norm(o.status),
         o.metadata.labels, o.metadata.annotations,
         [r.get("kind") for r in o.metadata.owner_references])
        for kind in api.kinds() if kind != "Event" for o in api.list(kind))


SCRIPT = [
    ("alice@x.co", "POST", "/kfam/v1/profiles", {"metadata": {"name": "alice"}}),
    ("bob@x.co", "POST", "/kfam/v1/profiles", {"name": "bob"}),
    ("bob@x.co", "POST", "/kfam/v1/profiles",
     {"metadata": {"name": "evil"}, "spec": {"owner": {"kind": "User", "name": "alice@x.co"}}}),
    ("admin@x.co", "POST", "/kfam/v1/profiles",
     {"metadata": {"name": "team"}, "spec": {"owner": {"kind": "User", "name": "carol@x.co"},
                                            "resourceQuotaSpec": {"hard": {"cpu": "4"}}}}),
    ("alice@x.co", "POST", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "bob@x.co"}, "referredNamespace": "alice",
      "roleRef": {"kind": "ClusterRole", "name": "edit"}}),
    ("alice@x.co", "POST", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "dave@x.co"}, "referredNamespace": "alice",
      "roleRef": {"kind": "ClusterRole", "name": "view"}}),
    ("alice@x.co", "POST", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "dave@x.co"}, "referredNamespace": "alice",
      "roleRef": {"kind": "ClusterRole", "name": "admin"}}),
    ("bob@x.co", "POST", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "bob@x.co"}, "referredNamespace": "team"}),
    ("alice@x.co", "POST", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "x@x.co"}, "referredNamespace": "nowhere"}),
    ("alice@x.co", "GET", "/kfam/v1/bindings?namespace=alice", None),
    ("bob@x.co", "GET", "/kfam/v1/bindings?user=bob@x.co", None),
    ("bob@x.co", "GET", "/kfam/v1/bindings", None),
    ("admin@x.co", "GET", "/kfam/v1/bindings", None),
    ("alice@x.co", "GET", "/kfam/v1/role/clusteradmin", None),
    ("admin@x.co", "GET", "/kfam/v1/role/clusteradmin?user=admin@x.co", None),
    ("alice@x.co", "DELETE", "/kfam/v1/bindings",
     {"user": {"kind": "User", "name": "dave@x.co"}, "referredNamespace": "alice",
      "roleRef": {"kind": "ClusterRole", "name": "view"}}),
    ("bob@x.co", "DELETE", "/kfam/v1/profiles/alice", None),
    ("alice@x.co", "DELETE", "/kfam/v1/profiles/alice", None),
    ("admin@x.co", "DELETE", "/kfam/v1/profiles/team", None),
    ("admin@x.co", "DELETE", "/kfam/v1/profiles/none", None),
    (None, "GET", "/kfam/v1/bindings", None),
    (None, "GET", "/healthz", None),
]


def _run(store_cls, seed_roles, make_crb, ctl_cls, app_cls, client_cls) -> list:
    api = store_cls()
    seed_roles(api)
    api.create(make_crb("admin", "kubeflow-admin", "admin@x.co"))
    ctl = ctl_cls(api)
    app = app_cls(api)
    out = []
    for user, method, path, body in SCRIPT:
        headers = {HDR: f"accounts.google.com:{user}"} if user else {}
        resp = client_cls(app, headers=headers).request(method, path, body=body)
        ctl.controller.run_until_idle()
        out.append((method, path, resp.status, norm(resp.json()), snapshot(api)))
    api.close()
    return out


def test_kfam_script_matches_jax():
    port = _run(FakeApiServer, seed_cluster_roles, make_cluster_role_binding,
                ProfileController, KfamApp, TestClient)
    jax = _run(JFakeApiServer, j_seed_cluster_roles, j_make_cluster_role_binding,
               JProfileController, JKfamApp, JTestClient)
    for step, (got, want) in enumerate(zip(port, jax)):
        assert got == want, f"step {step}: {SCRIPT[step]}"
    assert [s for _, _, s, _, _ in port] == [200, 200, 403, 200, 200, 200, 400, 403, 404,
                                             200, 200, 403, 200, 200, 200, 200, 403, 200,
                                             200, 404, 401, 200]
