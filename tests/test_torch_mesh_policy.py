"""The port's mesh-policy gate (`web/mesh.py`, and the second gate of
`web/authz.ensure_authorized`) against the JAX package's.

- JAX's own tests/test_mesh_policy.py runs against the port, every case,
  its imports pointed at the port: the owner policy the Profile
  controller writes, Istio's evaluation order, RBAC without a mesh rule
  failing closed, kfam's contributor binding restoring access, the
  cluster-admin bypass, method, path and principal matching, DENY first,
  the deny-all idiom, a viewer's POST refused by the Jupyter app, and a
  method-scoped DENY failing closed without a method.
- Seeded worlds of ALLOW and DENY policies (exact, ``prefix*``,
  ``*suffix`` and ``*`` principals and paths, method lists, empty
  clauses, ``rules: []`` and ``rules: [{}]``) through both evaluators:
  the same answer for every user, namespace, method and path, with and
  without a method, and the same 403 message from both gates.
"""

import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import mesh as j_mesh
from kubeflow_tpu.web.authz import ensure_authorized as j_ensure_authorized
from kubeflow_tpu.web.wsgi import HttpError as JHttpError
from kubeflow_tpu_torch.api import rbac
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import mesh
from kubeflow_tpu_torch.web.authz import ensure_authorized
from kubeflow_tpu_torch.web.wsgi import HttpError

REPO = Path(__file__).resolve().parents[1]


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


JAX_TESTS = _jax_tests_on_the_port("test_mesh_policy")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_mesh_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 13


USERS = ["alice@x.co", "bob@y.org", "mallory@x.co", "system:serviceaccount:t:sa", "carol@z.io"]
PRINCIPALS = ["alice@x.co", "*@x.co", "bob*", "*", "system:serviceaccount:*", "nobody"]
PATHS = ["/api/namespaces/team/notebooks", "/api/*", "*/notebooks", "/kfam/v1/bindings", "*"]
METHODS = ["GET", "POST", "PUT", "DELETE", "PATCH"]
REQUEST_PATHS = ["/api/namespaces/team/notebooks", "/api/x", "/kfam/v1/bindings", "/other"]


def _rule(rng):
    rule = {}
    if rng.random() < 0.7:
        rule["from"] = [{"source": {"principals": rng.sample(PRINCIPALS, rng.randint(1, 2))}}
                        for _ in range(rng.randint(1, 2))]
    if rng.random() < 0.6:
        ops = []
        for _ in range(rng.randint(1, 2)):
            op = {}
            if rng.random() < 0.7:
                op["methods"] = rng.sample(METHODS, rng.randint(1, 3))
            if rng.random() < 0.5:
                op["paths"] = rng.sample(PATHS, rng.randint(1, 2))
            ops.append({"operation": op})
        rule["to"] = ops
    return rule


def _world(seed):
    rng = random.Random(seed)
    policies = []
    for ns in ("team", "other"):
        for i in range(rng.randint(0, 3)):
            spec = {}
            action = rng.choice([None, "ALLOW", "ALLOW", "DENY"])
            if action is not None:
                spec["action"] = action
            r = rng.random()
            spec["rules"] = [] if r < 0.1 else [{}] if r < 0.2 else [
                _rule(rng) for _ in range(rng.randint(1, 3))]
            policies.append((ns, f"p{i}", spec))
    return policies


@pytest.mark.parametrize("seed", range(12))
def test_seeded_policies_same_answers_as_jax(seed):
    j_api, t_api = JFakeApiServer(), FakeApiServer()
    for ns, name, spec in _world(seed):
        j_api.create(j_new_resource("AuthorizationPolicy", name, ns, spec=spec))
        t_api.create(new_resource("AuthorizationPolicy", name, ns, spec=spec))
    answers = 0
    for user in USERS:
        for ns in ("team", "other", "empty"):
            for method in [None, *METHODS]:
                for path in [None, *REQUEST_PATHS]:
                    want = j_mesh.mesh_admits(j_api, user, ns, method=method, path=path)
                    got = mesh.mesh_admits(t_api, user, ns, method=method, path=path)
                    assert got == want, (seed, user, ns, method, path)
                    answers += want
    assert answers  # the world admits someone somewhere


def test_both_gates_refuse_with_the_same_message():
    """RBAC edit for every user in "team", and seeded policies: the two
    `ensure_authorized` calls pass or refuse together, with the same
    status and message."""
    from kubeflow_tpu.api import rbac as j_rbac

    seen = set()
    for seed in range(6):
        j_api, t_api = JFakeApiServer(), FakeApiServer()
        j_rbac.seed_cluster_roles(j_api)
        rbac.seed_cluster_roles(t_api)
        # One fixed ALLOW policy beside the seeded ones, so "team" enforces.
        fixed = ("team", "x-co", {"rules": [{"from": [{"source": {"principals": ["*@x.co"]}}]}]})
        for ns, name, spec in [*_world(seed), fixed]:
            j_api.create(j_new_resource("AuthorizationPolicy", name, ns, spec=spec))
            t_api.create(new_resource("AuthorizationPolicy", name, ns, spec=spec))
        for i, user in enumerate(USERS):
            binding = {"roleRef": {"kind": "ClusterRole", "name": rbac.EDIT_ROLE},
                       "subjects": [{"kind": "User", "name": user}]}
            j_api.create(j_new_resource("RoleBinding", f"b{i}", "team", spec=binding))
            t_api.create(new_resource("RoleBinding", f"b{i}", "team", spec=binding))
        for user in USERS:
            for verb in ("get", "list", "create", "update", "delete"):
                outcomes = []
                for gate, err, api in ((j_ensure_authorized, JHttpError, j_api),
                                       (ensure_authorized, HttpError, t_api)):
                    try:
                        gate(api, user, verb, "notebooks", "team")
                        outcomes.append(None)
                    except err as e:
                        outcomes.append((e.status, str(e)))
                assert outcomes[0] == outcomes[1], (seed, user, verb)
                seen.add(outcomes[0] is None)
    assert seen == {True, False}  # RBAC allows all; the mesh admits some, refuses some
