"""The port's authentication and authorization against the JAX
package's: header authentication (`web/authn.py`), the handlers' RBAC
gate (`web/authz.py`), the RBAC evaluator (`api/rbac.py`) and the secure
apiserver facade (`testing/apiserver_http.py` with `tokens=`: bearer
tokens, RBAC per operation, the status subresource, the per-event watch
filter, the pod-log route and the trace drain).

- JAX's own tests/test_apiserver_auth.py runs against the port, every
  case, its imports pointed at the port (its two watch cases read the
  long-poll watch).
- Seeded RBAC worlds (cluster roles, namespaced roles, cluster and
  namespaced bindings, users and service accounts) through both
  evaluators: the same SubjectAccessReview answers, cluster-admin
  answers and namespace lists.
- Seeded header-authentication requests through both hooks: the same
  users and the same 401s.
- One script of requests by several identities through both secure
  facades holding the same tokens: the same statuses, the same error
  messages and the same stored objects.
- The handlers' gate asks RBAC and then the mesh policy in both
  packages (`web/mesh.py`; test_torch_mesh_policy.py holds the two
  evaluators to each other).
"""

import json
import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api import rbac as j_rbac
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.api.tokens import TokenRegistry as JTokenRegistry
from kubeflow_tpu.testing.apiserver_http import ApiServerApp as JApiServerApp
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu.web import authz as j_authz
from kubeflow_tpu.web.authn import HeaderAuthn as JHeaderAuthn
from kubeflow_tpu.web.wsgi import HttpError as JHttpError
from kubeflow_tpu.web.wsgi import Request as JRequest
from kubeflow_tpu_torch.api import rbac
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.tokens import TokenRegistry
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import TestClient, authz
from kubeflow_tpu_torch.web.authn import HeaderAuthn
from kubeflow_tpu_torch.web.wsgi import HttpError, Request

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str, patches=()) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_apiserver_auth")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_auth_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 15


# -- the RBAC evaluator ------------------------------------------------------------

USERS = ["alice", "bob", "carol", "system:serviceaccount:team:default-editor"]
NAMESPACES = ["team", "prod", ""]
VERBS = ["get", "list", "watch", "create", "update", "delete", "*"]
RESOURCES = ["pods", "notebooks", "tpujobs", "tpujobs/status", "rolebindings",
             "clusterrolebindings", "webhookconfigurations", "pods/log", "traces", "*"]


def _rbac_world(seed: int, store_cls, new, module):
    rng = random.Random(seed)
    api = store_cls()
    module.seed_cluster_roles(api)
    for i in range(rng.randint(0, 3)):
        rules = [{"verbs": rng.sample(VERBS, rng.randint(1, 3)),
                  "resources": rng.sample(RESOURCES, rng.randint(1, 3))}
                 for _ in range(rng.randint(1, 2))]
        api.create(module.make_cluster_role(f"cr{i}", rules))
    for i in range(rng.randint(1, 5)):
        role = rng.choice(["kubeflow-admin", "kubeflow-edit", "kubeflow-view", "cr0", "cr1"])
        user = rng.choice(USERS)
        if rng.random() < 0.4:
            api.create(module.make_cluster_role_binding(f"crb{i}", role, user))
        else:
            ns = rng.choice(["team", "prod"])
            kind = rng.choice(["User", "ServiceAccount"])
            api.create(new("RoleBinding", f"rb{i}", ns, spec={
                "roleRef": {"kind": "ClusterRole", "name": role},
                "subjects": [{"kind": kind, "name": user}]}))
    if rng.random() < 0.5:
        api.create(new("Role", "local", "team", spec={"rules": [
            {"verbs": ["get", "list"], "resources": ["pods"]}]}))
        api.create(new("RoleBinding", "local", "team", spec={
            "roleRef": {"kind": "Role", "name": "local"},
            "subjects": [{"kind": "User", "name": rng.choice(USERS)}]}))
    for ns in ("team", "prod"):
        api.create(new("Namespace", ns, ""))
    return api


def _answers(seed: int, store_cls, new, module) -> list:
    api = _rbac_world(seed, store_cls, new, module)
    out = [module.subject_access_review(api, u, v, r, ns)
           for u in USERS for v in VERBS for r in RESOURCES for ns in NAMESPACES]
    out += [module.is_cluster_admin(api, u) for u in USERS]
    out += [module.namespaces_for(api, u) for u in USERS]
    api.close()
    return out


@pytest.mark.parametrize("seed", range(8))
def test_rbac_answers_match_jax(seed):
    assert _answers(seed, FakeApiServer, new_resource, rbac) == \
        _answers(seed, JFakeApiServer, j_new_resource, j_rbac)


def test_rbac_constants_match_jax():
    assert rbac.RBAC_RESOURCES == j_rbac.RBAC_RESOURCES
    assert (rbac.CLUSTER_ADMIN_ROLE, rbac.EDIT_ROLE, rbac.VIEW_ROLE) == \
        (j_rbac.CLUSTER_ADMIN_ROLE, j_rbac.EDIT_ROLE, j_rbac.VIEW_ROLE)
    assert [rbac.resource_for_kind(k) for k in ("TpuJob", "Study", "Gateway", "Class")] == \
        [j_rbac.resource_for_kind(k) for k in ("TpuJob", "Study", "Gateway", "Class")]


# -- header authentication -------------------------------------------------------------


def _authn_outcomes(hook_cls, request_cls, seed: int) -> list:
    rng = random.Random(seed)
    hooks = [hook_cls(), hook_cls(anonymous="dev@x.co"),
             hook_cls(header="x-user", prefix="")]
    out = []
    for _ in range(30):
        environ = {"REQUEST_METHOD": "GET",
                   "PATH_INFO": rng.choice(["/api/x", "/healthz", "/metrics"])}
        header = rng.choice(["HTTP_X_GOOG_AUTHENTICATED_USER_EMAIL", "HTTP_X_USER"])
        value = rng.choice(["", "accounts.google.com:a@x.co", "b@x.co",
                            "accounts.google.com:"])
        if value:
            environ[header] = value
        for hook in hooks:
            req = request_cls(environ)
            resp = hook(req)
            out.append((req.user, None if resp is None else (resp.status, resp.json())))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_header_authn_matches_jax(seed):
    assert _authn_outcomes(HeaderAuthn, Request, seed) == \
        _authn_outcomes(JHeaderAuthn, JRequest, seed)


def test_authz_gate_matches_jax_where_no_mesh_policy_applies():
    """401 without a user, 403 with the same message, allowed alike, in
    namespaces that hold no AuthorizationPolicy (where JAX's mesh gate
    admits everyone)."""
    worlds = {}
    for name, store_cls, new, module in (
            ("port", FakeApiServer, new_resource, rbac),
            ("jax", JFakeApiServer, j_new_resource, j_rbac)):
        worlds[name] = _rbac_world(3, store_cls, new, module)

    def outcome(gate, error_cls, api, *args):
        try:
            gate(api, *args)
            return "allowed"
        except error_cls as e:
            return (e.status, e.message)

    for user in USERS + [None]:
        for verb in ("get", "create", "delete"):
            for resource in ("pods", "rolebindings", "tpujobs/status"):
                for ns in NAMESPACES:
                    args = (user, verb, resource, ns)
                    assert outcome(authz.ensure_authorized, HttpError, worlds["port"], *args) \
                        == outcome(j_authz.ensure_authorized, JHttpError, worlds["jax"], *args)


def test_authz_is_rbac_alone_without_the_mesh_gate():
    """A namespace whose AuthorizationPolicy admits no one is closed to an
    RBAC-bound user in both packages: RBAC alone does not open it, the
    mesh gate refuses what RBAC allows."""
    outcomes = []
    for store_cls, new, module, gate, error_cls in (
            (FakeApiServer, new_resource, rbac, authz.ensure_authorized, HttpError),
            (JFakeApiServer, j_new_resource, j_rbac, j_authz.ensure_authorized, JHttpError)):
        api = store_cls()
        module.seed_cluster_roles(api)
        api.create(new("RoleBinding", "edit", "team", spec={
            "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"},
            "subjects": [{"kind": "User", "name": "alice"}]}))
        api.create(new("AuthorizationPolicy", "nobody", "team",
                       spec={"action": "ALLOW", "rules": []}))
        try:
            gate(api, "alice", "list", "notebooks", "team")
            outcomes.append("allowed")
        except error_cls as e:
            outcomes.append(e.status)
    assert outcomes == [403, 403]


# -- the secure facade ---------------------------------------------------------------

IDENTITIES = {"kt-admin": "system:admin", "kt-editor": "erin",
              "kt-viewer": "vera", "kt-sa": "system:serviceaccount:team:default-editor"}


def _facade_script(store_cls, new, module, registry_cls, app_cls, client_cls,
                   tmp_path) -> tuple[list, list]:
    api = store_cls()
    module.seed_cluster_roles(api)
    api.create(module.make_cluster_role_binding("adm", "kubeflow-admin", "system:admin"))
    api.create(module.make_cluster_role_binding("view", "kubeflow-view", "vera"))
    for user in ("erin", "system:serviceaccount:team:default-editor"):
        api.create(new("RoleBinding", f"edit-{len(user)}", "team", spec={
            "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"},
            "subjects": [{"kind": "User", "name": user}]}))
    tokens = registry_cls()
    for token, user in IDENTITIES.items():
        tokens.add(token, user)
    log = tmp_path / f"{store_cls.__module__}.log"
    log.write_text("pod output\n")
    pod = new("Pod", "p", "team", spec={})
    pod.status["logPath"] = str(log)
    api.create(pod)
    app = app_cls(api, log_root=str(tmp_path), tokens=tokens)

    def job(name, ns, **status):
        return {"kind": "TpuJob", "apiVersion": "kubeflow-tpu.org/v1",
                "metadata": {"name": name, "namespace": ns},
                "spec": {"replicas": 1}, "status": status}

    script = [
        (None, "GET", "/apis/TpuJob", None),
        ("kt-nope", "GET", "/apis/TpuJob", None),
        ("kt-viewer", "GET", "/apis/TpuJob", None),
        ("kt-viewer", "POST", "/apis/TpuJob", job("v", "team")),
        ("kt-editor", "POST", "/apis/TpuJob", job("e", "team", phase="Succeeded")),
        ("kt-editor", "POST", "/apis/TpuJob", job("e", "prod")),
        ("kt-editor", "GET", "/apis/TpuJob?namespace=team", None),
        ("kt-editor", "GET", "/apis/TpuJob", None),
        ("kt-sa", "GET", "/apis/TpuJob/team/e", None),
        ("kt-sa", "PUT", "/apis/TpuJob/team/e/status", None),
        ("kt-editor", "POST", "/apis/ClusterRoleBinding",
         {"kind": "ClusterRoleBinding", "apiVersion": "kubeflow-tpu.org/v1",
          "metadata": {"name": "esc", "namespace": ""},
          "spec": {"roleRef": {"kind": "ClusterRole", "name": "kubeflow-admin"},
                   "subjects": [{"kind": "User", "name": "erin"}]}}),
        ("kt-editor", "GET", "/apis/Pod/team/p/log", None),
        ("kt-viewer", "GET", "/apis/Pod/team/p/log", None),
        ("kt-editor", "GET", "/debug/traces", None),
        ("kt-editor", "DELETE", "/apis/TpuJob/team/e", None),
        ("kt-admin", "POST", "/apis/TpuJob?apply=true", job("a", "prod", phase="Running")),
        ("kt-admin", "GET", "/healthz", None),
    ]
    out = []
    for token, method, path, body in script:
        client = client_cls(app, headers={"Authorization": f"Bearer {token}"} if token else {})
        if path.endswith("/status"):
            body = api.get("TpuJob", "e", "team").to_dict()
            body["status"] = {"phase": "Running"}
        resp = client.request(method, path, body=body)
        payload = resp.body if resp.content_type == "text/plain" else resp.json()
        if isinstance(payload, dict) and "items" in payload:
            payload = sorted(i["metadata"]["name"] for i in payload["items"])
        elif isinstance(payload, dict) and "metadata" in payload:
            payload = (payload["kind"], payload["metadata"]["name"], payload["spec"],
                       payload["status"])
        elif isinstance(payload, dict) and "spans" in payload:
            payload = "spans"
        out.append((method, path, resp.status, payload))
    stored = sorted((o.metadata.namespace, o.metadata.name, o.spec, o.status)
                    for o in api.list("TpuJob"))
    api.close()
    return out, stored


def test_secure_facade_answers_as_jax(tmp_path):
    port = _facade_script(FakeApiServer, new_resource, rbac, TokenRegistry, ApiServerApp,
                          TestClient, tmp_path)
    jax = _facade_script(JFakeApiServer, j_new_resource, j_rbac, JTokenRegistry,
                         JApiServerApp, JTestClient, tmp_path)
    assert port == jax
    statuses = [status for _, _, status, _ in port[0]]
    assert statuses == [401, 401, 200, 403, 201, 403, 200, 403, 200, 200, 403, 200, 200,
                        403, 200, 200, 200]


def test_open_facade_stays_open():
    """Without tokens nothing asks for a credential (every earlier caller
    of the facade)."""
    client = TestClient(ApiServerApp(FakeApiServer()))
    assert client.get("/apis/TpuJob").status == 200
    assert client.get("/debug/traces").status == 200
    body = {"kind": "TpuJob", "apiVersion": "kubeflow-tpu.org/v1",
            "metadata": {"name": "x", "namespace": "default"}, "spec": {},
            "status": {"phase": "Running"}}
    assert json.loads(client.post("/apis/TpuJob", body).body)["status"] == {"phase": "Running"}
