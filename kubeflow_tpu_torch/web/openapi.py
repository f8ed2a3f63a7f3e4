"""OpenAPI surface for the platform's HTTP apps, and the drift gate.

A copy of `kubeflow_tpu/web/openapi.py` (a module with no JAX in it).
The specs live in `docs/api/*.yaml`, read as data; `route_table`
extracts an App's live routing table in OpenAPI path form and
`spec_drift` diffs it against a spec, so a route added without a spec
(or a spec entry without a route) fails the tests
(`tests/test_torch_openapi.py` holds the port's facade, kfam, deploy
service and webhook apps against
`docs/api/{apiserver,kfam,deploy,webhook}.yaml`).

`python -m kubeflow_tpu_torch.web.openapi` prints skeletons of those
four apps' specs to diff against when authoring.
"""

from __future__ import annotations

import re

from kubeflow_tpu_torch.web.wsgi import App

_PARAM_RE = re.compile(r"<([a-zA-Z_][a-zA-Z0-9_]*)(:path)?>")

# Probe endpoint — implicitly present on every App; specs document it via
# a shared snippet but the drift gate tolerates either choice.
_IMPLICIT = {("get", "/healthz")}


def _openapi_path(pattern: str) -> str:
    return _PARAM_RE.sub(lambda m: "{" + m.group(1) + "}", pattern)


def route_table(app: App) -> set[tuple[str, str]]:
    """The app's live operations as (lowercase method, OpenAPI path)."""
    out = set()
    for route in app._routes:
        path = _openapi_path(route.pattern)
        for method in route.methods:
            out.add((method.lower(), path))
    return out


def spec_operations(spec: dict) -> set[tuple[str, str]]:
    """The spec's operations as (lowercase method, path)."""
    out = set()
    for path, ops in (spec.get("paths") or {}).items():
        for method in ops:
            if method.lower() in (
                "get", "post", "put", "patch", "delete", "head", "options"
            ):
                out.add((method.lower(), path))
    return out


def spec_drift(app: App, spec: dict) -> list[str]:
    """Human-readable drift between an app's routes and its spec; empty
    means in sync. /healthz may be documented or not."""
    routes = route_table(app) - _IMPLICIT
    documented = spec_operations(spec) - _IMPLICIT
    drift = []
    for method, path in sorted(routes - documented):
        drift.append(f"route not in spec: {method.upper()} {path}")
    for method, path in sorted(documented - routes):
        drift.append(f"spec documents missing route: {method.upper()} {path}")
    return drift


def skeleton(app: App, title: str, version: str = "v1") -> dict:
    """A minimal valid OpenAPI 3 document for the app's current routes —
    the starting point for the checked-in, human-enriched spec."""
    paths: dict[str, dict] = {}
    for method, path in sorted(route_table(app) - _IMPLICIT):
        op = {
            "summary": f"{method.upper()} {path}",
            "responses": {"200": {"description": "OK"}},
        }
        params = re.findall(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}", path)
        if params:
            op["parameters"] = [
                {
                    "name": p,
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for p in params
            ]
        paths.setdefault(path, {})[method] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": version},
        "paths": paths,
    }


def main() -> None:
    import sys

    import yaml

    from kubeflow_tpu_torch.apps.kfam import KfamApp
    from kubeflow_tpu_torch.controllers.webhook import MutatingWebhookApp
    from kubeflow_tpu_torch.deploy.provisioner import FakeCloud
    from kubeflow_tpu_torch.deploy.server import DeployServer
    from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

    api = FakeApiServer()
    for app, title in (
        (ApiServerApp(api), "kubeflow-tpu apiserver facade"),
        (KfamApp(api), "kubeflow-tpu access management (kfam)"),
        (DeployServer(api, FakeCloud(api)), "kubeflow-tpu deploy service"),
        (MutatingWebhookApp(lambda obj, op: obj), "kubeflow-tpu admission webhook"),
    ):
        sys.stdout.write(f"# --- {app.name} ---\n")
        yaml.safe_dump(skeleton(app, title), sys.stdout, sort_keys=False)


if __name__ == "__main__":
    main()
