"""Component manifest bundles — the kustomize-bundle analog.

Counterpart of `kubeflow_tpu/deploy/bundles.py`, whole, its imports
pointed at the port: every bundle, `BUNDLES`, `CORE_DEPLOYMENTS` and
`bundle_resources` give the same resources as JAX's. No bundle asks for
an accelerator (the GPU translation is in `deploy/kfdef.py` and
`deploy/provisioner.py`); the model server it names is the port's
(`kubeflow_tpu_torch.serving`).

The reference applies per-component kustomize bundles (`*/config/` in
every component, applied by kfctl's K8S phase). Each bundle here is a
function `(PlatformSpec) -> [Resource]` producing the CRDs, RBAC,
Deployments and Services for one component. Deployment names mirror the
set the reference's readiness test asserts
(`testing/kfctl/kf_is_ready_test.py:101-115`) so our platform-is-ready
test has line-for-line parity.
"""

from __future__ import annotations

from typing import Callable

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec

KUBEFLOW_NS = "kubeflow"

BundleFn = Callable[[PlatformSpec], list[Resource]]


def _deployment(
    name: str, image: str, *, port: int | None = None, replicas: int = 1
) -> Resource:
    container: dict = {"name": name, "image": image}
    if port is not None:
        container["ports"] = [{"containerPort": port}]
    return new_resource(
        "Deployment",
        name,
        KUBEFLOW_NS,
        labels={"app": name, "app.kubernetes.io/part-of": "kubeflow-tpu"},
        spec={
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {"containers": [container]},
            },
        },
    )


def _service(name: str, port: int, target: int | None = None) -> Resource:
    return new_resource(
        "Service",
        name,
        KUBEFLOW_NS,
        spec={
            "selector": {"app": name},
            "ports": [{"port": port, "targetPort": target or port}],
        },
    )


def _crd(kind: str, plural: str, *, cluster_scoped: bool = False) -> Resource:
    return new_resource(
        "CustomResourceDefinition",
        f"{plural}.kubeflow-tpu.org",
        "",
        spec={
            "group": "kubeflow-tpu.org",
            "names": {"kind": kind, "plural": plural},
            "scope": "Cluster" if cluster_scoped else "Namespaced",
            "versions": [{"name": "v1", "served": True, "storage": True}],
        },
    )


def _vs(
    name: str,
    prefix: str,
    port: int,
    *,
    rewrite: str | None = "/",
    service: str | None = None,
) -> Resource:
    """rewrite=None keeps the matched prefix (for backends whose routes
    include it, e.g. the model server's /v1/models/...). `service` names
    the backing Service when it differs from the VirtualService's name.

    A prefix with no trailing slash gets the segment-safe pair of
    matches (exact "/p" + prefix "/p/") — a bare string prefix would
    also capture sibling paths like "/p-admin"."""
    if prefix.endswith("/"):
        match = [{"uri": {"prefix": prefix}}]
    else:
        match = [
            {"uri": {"exact": prefix}},
            {"uri": {"prefix": prefix + "/"}},
        ]
    http_route: dict = {"match": match}
    if rewrite is not None:
        http_route["rewrite"] = {"uri": rewrite}
    return new_resource(
        "VirtualService",
        name,
        KUBEFLOW_NS,
        spec={
            "gateways": ["kubeflow/kubeflow-gateway"],
            "hosts": ["*"],
            "http": [
                {
                    **http_route,
                    "route": [
                        {
                            "destination": {
                                "host": f"{service or name}.{KUBEFLOW_NS}.svc",
                                "port": {"number": port},
                            }
                        }
                    ],
                }
            ],
        },
    )


def namespace_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        new_resource(
            "Namespace",
            KUBEFLOW_NS,
            "",
            labels={"istio-injection": "enabled"},
        )
    ]


def gateway_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        new_resource(
            "Gateway",
            "kubeflow-gateway",
            KUBEFLOW_NS,
            spec={
                "selector": {"istio": "ingressgateway"},
                "servers": [
                    {
                        "port": {"number": 80, "protocol": "HTTP"},
                        "hosts": ["*"],
                    }
                ],
            },
        )
    ]


def tpujob_operator_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _crd("TpuJob", "tpujobs"),
        _deployment(
            "tpu-job-operator", "kubeflow-tpu/tpujob-operator:v1", port=8443
        ),
    ]


def study_controller_bundle(spec: PlatformSpec) -> list[Resource]:
    """The katib analog (`kf_is_ready_test.py:47-73` asserts the katib
    deployment set): HP-search Studies whose trials are TpuJobs."""
    return [
        _crd("Study", "studies"),
        _deployment(
            "study-controller", "kubeflow-tpu/study-controller:v1", port=8443
        ),
    ]


def workflow_controller_bundle(spec: PlatformSpec) -> list[Resource]:
    """The Argo / ml-pipeline analog (`kf_is_ready_test.py:101-115`
    asserts ml-pipeline's deployments): DAG workflows of step pods."""
    return [
        _crd("Workflow", "workflows"),
        _deployment(
            "workflow-controller", "kubeflow-tpu/workflow-controller:v1",
            port=8443,
        ),
    ]


def notebook_controller_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _crd("Notebook", "notebooks"),
        _deployment(
            "notebook-controller-deployment",
            "kubeflow-tpu/notebook-controller:v1",
        ),
    ]


def profile_controller_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _crd("Profile", "profiles", cluster_scoped=True),
        _deployment(
            "profiles-deployment", "kubeflow-tpu/profile-controller:v1"
        ),
    ]


def tensorboard_controller_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _crd("Tensorboard", "tensorboards"),
        _deployment(
            "tensorboard-controller-deployment",
            "kubeflow-tpu/tensorboard-controller:v1",
        ),
    ]


def admission_webhook_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _crd("PodDefault", "poddefaults"),
        _deployment(
            "admission-webhook-deployment",
            "kubeflow-tpu/admission-webhook:v1",
            port=4443,
        ),
        new_resource(
            "MutatingWebhookConfiguration",
            "admission-webhook-mutating-webhook-configuration",
            "",
            spec={
                "webhooks": [
                    {
                        "name": "poddefaults.kubeflow-tpu.org",
                        "rules": [
                            {
                                "operations": ["CREATE"],
                                "resources": ["pods"],
                            }
                        ],
                    }
                ]
            },
        ),
    ]


def kfam_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _deployment(
            "profiles-kfam", "kubeflow-tpu/access-management:v1", port=8081
        ),
        _service("profiles-kfam", 8081),
    ]


def centraldashboard_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _deployment(
            "centraldashboard", "kubeflow-tpu/centraldashboard:v1", port=8082
        ),
        _service("centraldashboard", 80, 8082),
        _vs("centraldashboard", "/", 80),
    ]


def jupyter_web_app_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _deployment(
            "jupyter-web-app-deployment",
            "kubeflow-tpu/jupyter-web-app:v1",
            port=5000,
        ),
        _service("jupyter-web-app-service", 80, 5000),
        _vs("jupyter-web-app", "/jupyter/", 80,
            service="jupyter-web-app-service"),
        new_resource(
            "ConfigMap",
            "jupyter-web-app-config",
            KUBEFLOW_NS,
            spec={"data": {"spawnerFormDefaults": {}}},
        ),
    ]


def tensorboards_web_app_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _deployment(
            "tensorboards-web-app-deployment",
            "kubeflow-tpu/tensorboards-web-app:v1",
            port=5000,
        ),
        _service("tensorboards-web-app-service", 80, 5000),
        _vs("tensorboards-web-app", "/tensorboards/", 80,
            service="tensorboards-web-app-service"),
    ]


def metrics_collector_bundle(spec: PlatformSpec) -> list[Resource]:
    return [
        _deployment(
            "metrics-collector", "kubeflow-tpu/metrics-collector:v1", port=8000
        )
    ]


def model_serving_bundle(spec: PlatformSpec) -> list[Resource]:
    """The tf-serving analog: the port's model server
    (`kubeflow_tpu_torch.serving`), reached at the same REST surface the
    reference's golden-prediction E2E drives (`test_tf_serving.py:107`)."""
    return [
        _deployment(
            "model-server", "kubeflow-tpu/model-server:v1", port=8500
        ),
        _service("model-server", 8500),
        # No trailing slash: the list endpoint is GET /v1/models itself.
        _vs("model-server", "/v1/models", 8500, rewrite=None),
    ]


BUNDLES: dict[str, BundleFn] = {
    # Order matters: namespace and gateway first, operators before apps.
    "namespace": namespace_bundle,
    "gateway": gateway_bundle,
    "tpujob-operator": tpujob_operator_bundle,
    "study-controller": study_controller_bundle,
    "workflow-controller": workflow_controller_bundle,
    "notebook-controller": notebook_controller_bundle,
    "profile-controller": profile_controller_bundle,
    "tensorboard-controller": tensorboard_controller_bundle,
    "admission-webhook": admission_webhook_bundle,
    "access-management": kfam_bundle,
    "centraldashboard": centraldashboard_bundle,
    "jupyter-web-app": jupyter_web_app_bundle,
    "tensorboards-web-app": tensorboards_web_app_bundle,
    "metrics-collector": metrics_collector_bundle,
    "model-serving": model_serving_bundle,
}

# The deployment set the readiness test asserts — the analog of the
# 15-deployment core list in `kf_is_ready_test.py:101-115`.
CORE_DEPLOYMENTS = [
    "tpu-job-operator",
    "study-controller",
    "workflow-controller",
    "notebook-controller-deployment",
    "profiles-deployment",
    "tensorboard-controller-deployment",
    "admission-webhook-deployment",
    "profiles-kfam",
    "centraldashboard",
    "jupyter-web-app-deployment",
    "tensorboards-web-app-deployment",
    "metrics-collector",
    "model-server",
]


def bundle_resources(
    spec: PlatformSpec, applications: list[str] | None = None
) -> list[Resource]:
    """Expand the spec's application list into concrete resources,
    preserving BUNDLES order regardless of spec order."""
    wanted = applications if applications is not None else spec.applications
    unknown = set(wanted) - set(BUNDLES)
    if unknown:
        raise ValueError(f"unknown applications: {sorted(unknown)}")
    out: list[Resource] = []
    for name, fn in BUNDLES.items():
        if name in wanted:
            out.extend(fn(spec))
    if spec.overlays:
        from kubeflow_tpu_torch.deploy.overlays import Overlay, apply_overlays

        out = apply_overlays(
            out, [Overlay.from_dict(o) for o in spec.overlays]
        )
    return out
