"""The port's OpenAPI drift gate (`web/openapi.py`) and its apps' routes
against `docs/api/*.yaml` and the JAX package's.

- The port's apiserver facade, kfam, deploy service and admission
  webhook apps have zero drift against
  `docs/api/{apiserver,kfam,deploy,webhook}.yaml`, read as data.
- JAX's tests/test_openapi.py cases on the port: the specs' OpenAPI 3
  shape, the gate catching drift both ways, the route table extraction.
- The port's `route_table`, `spec_operations`, `spec_drift` and
  `skeleton` give JAX's answers on the same apps and specs, and each
  port app serves exactly the routes of its JAX counterpart.
"""

import pathlib
import re
import subprocess
import sys

import pytest
import yaml

from kubeflow_tpu.apps.kfam import KfamApp as JKfamApp
from kubeflow_tpu.controllers.webhook import MutatingWebhookApp as JMutatingWebhookApp
from kubeflow_tpu.deploy.provisioner import FakeCloud as JFakeCloud
from kubeflow_tpu.deploy.server import DeployServer as JDeployServer
from kubeflow_tpu.testing.apiserver_http import ApiServerApp as JApiServerApp
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import openapi as j_openapi
from kubeflow_tpu_torch.apps.kfam import KfamApp
from kubeflow_tpu_torch.controllers.webhook import MutatingWebhookApp
from kubeflow_tpu_torch.deploy.provisioner import FakeCloud
from kubeflow_tpu_torch.deploy.server import DeployServer
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.openapi import route_table, skeleton, spec_drift, spec_operations

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs" / "api"
SPECS = ["apiserver.yaml", "kfam.yaml", "deploy.yaml", "webhook.yaml"]


def _apps():
    api = FakeApiServer()
    return {
        "apiserver.yaml": ApiServerApp(api),
        "kfam.yaml": KfamApp(api),
        "deploy.yaml": DeployServer(api, FakeCloud(api)),
        "webhook.yaml": MutatingWebhookApp(lambda obj, op: obj),
    }


def _jax_apps():
    api = JFakeApiServer()
    return {
        "apiserver.yaml": JApiServerApp(api),
        "kfam.yaml": JKfamApp(api),
        "deploy.yaml": JDeployServer(api, JFakeCloud(api)),
        "webhook.yaml": JMutatingWebhookApp(lambda obj, op: obj),
    }


def _spec(spec_file: str) -> dict:
    return yaml.safe_load((DOCS / spec_file).read_text())


@pytest.mark.parametrize("spec_file", SPECS)
def test_spec_matches_routes(spec_file):
    drift = spec_drift(_apps()[spec_file], _spec(spec_file))
    assert not drift, "\n".join(drift)


@pytest.mark.parametrize("spec_file", SPECS)
def test_spec_is_valid_openapi3_shape(spec_file):
    spec = _spec(spec_file)
    assert spec["openapi"].startswith("3.")
    assert spec["info"]["title"] and spec["info"]["version"]
    assert spec_operations(spec)
    for path, ops in spec["paths"].items():
        assert path.startswith("/")
        for method, op in ops.items():
            assert "responses" in op, f"{method} {path} has no responses"
            declared = {p["name"] for p in op.get("parameters", []) if p.get("in") == "path"}
            for param in re.findall(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}", path):
                assert param in declared, f"{method} {path}: path param {param!r} undeclared"


def test_drift_gate_catches_both_directions():
    app = ApiServerApp(FakeApiServer())
    spec = skeleton(app, "t")
    assert spec_drift(app, spec) == []
    broken = yaml.safe_load(yaml.safe_dump(spec))
    broken["paths"].pop("/debug/traces")
    assert any("route not in spec" in d for d in spec_drift(app, broken))
    broken2 = yaml.safe_load(yaml.safe_dump(spec))
    broken2["paths"]["/ghost"] = {"get": {"responses": {"200": {"description": "x"}}}}
    assert any("missing route" in d for d in spec_drift(app, broken2))


def test_route_table_extraction():
    routes = route_table(ApiServerApp(FakeApiServer()))
    assert ("get", "/apis/{kind}") in routes
    assert ("put", "/apis/{kind}/{ns}/{name}/status") in routes
    assert ("get", "/healthz") in routes


@pytest.mark.parametrize("spec_file", SPECS)
def test_routes_and_gate_equal_jax(spec_file):
    app, j_app = _apps()[spec_file], _jax_apps()[spec_file]
    assert route_table(app) == j_openapi.route_table(j_app)
    spec = _spec(spec_file)
    assert spec_operations(spec) == j_openapi.spec_operations(spec)
    assert skeleton(app, "t") == j_openapi.skeleton(j_app, "t")
    # A drifted spec reads the same through both gates.
    drifted = yaml.safe_load(yaml.safe_dump(spec))
    first = sorted(drifted["paths"])[0]
    drifted["paths"].pop(first)
    drifted["paths"]["/ghost/{x}"] = {"get": {"responses": {"200": {"description": "x"}}}}
    assert spec_drift(app, drifted) == j_openapi.spec_drift(j_app, drifted) != []


def test_module_prints_every_skeleton_the_deploy_service_included():
    out = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.web.openapi"],
                         cwd=str(DOCS.parent.parent), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    sections = re.findall(r"^# --- (\S+) ---$", out.stdout, re.M)
    assert sections == ["apiserver", "kfam", "deploy-server", "admission-webhook"]
    deploy = out.stdout.split("# --- deploy-server ---\n")[1].split("# --- ")[0]
    assert spec_operations(yaml.safe_load(deploy)) == spec_operations(_spec("deploy.yaml"))
