"""Tensorboard controller: a Tensorboard CR becomes a Deployment, a
Service and a VirtualService.

Counterpart of `kubeflow_tpu/controllers/tensorboard.py`, whole: the
Deployment reads `logspath` from a PVC (``<claim>/<sub/path>``: the
claim mounted with a `subPath`, so only that run directory is served)
or from cloud storage (``gs://``, ``s3://``, passed as written); the
VirtualService routes `/tensorboard/<ns>/<name>/`; a pod that must
share a ReadWriteOnce claim gets an affinity to the Running pod that
holds it; `readyReplicas` is mirrored from the Deployment.

The served TensorBoard is also the platform's profiling UI: the
`torch.profiler` traces a training job writes (`train/profiling.
Profiler`, ``*.pt.trace.json``, which TensorBoard's PyTorch profiler
plugin reads) are just a `logspath`.
"""

from __future__ import annotations

import logging

from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

log = logging.getLogger(__name__)

KIND = "Tensorboard"
DEFAULT_IMAGE = "kubeflow-tpu/tensorboard:latest"


def _is_cloud_path(path: str) -> bool:
    return path.startswith(("gs://", "s3://"))


class TensorboardController:
    def __init__(self, api: FakeApiServer):
        self.api = api
        self.controller = Controller(
            api,
            KIND,
            self.reconcile,
            owns=("Deployment", "Service", "VirtualService"),
            name="tensorboard-controller",
        )

    def _desired_deployment(self, tb: Resource) -> Resource:
        logspath = tb.spec.get("logspath", "")
        container = {
            "name": "tensorboard",
            "image": tb.spec.get("image", DEFAULT_IMAGE),
            "command": [
                "tensorboard",
                f"--logdir={logspath}",
                "--bind_all",
                "--port=6006",
            ],
            "ports": [{"containerPort": 6006}],
        }
        pod_spec: dict = {"containers": [container]}
        if logspath and not _is_cloud_path(logspath):
            # PVC-backed logs: "<claim>/<sub/path>" mounts the claim with a
            # SubPath so only the requested run directory is served
            # (tensorboard_controller.go:155-177). Leading slashes are
            # tolerated.
            claim, _, subpath = logspath.strip("/").partition("/")
            pvc_name = claim
            mount = {"name": "logs", "mountPath": "/logs"}
            if subpath:
                mount["subPath"] = subpath
            container["volumeMounts"] = [mount]
            container["command"][1] = "--logdir=/logs"
            pod_spec["volumes"] = [
                {"name": "logs", "persistentVolumeClaim": {"claimName": pvc_name}}
            ]
            holder = self._pvc_holder(tb.metadata.namespace, pvc_name)
            if holder is not None:
                pod_spec["affinity"] = {
                    "podAffinity": {"colocateWithPod": holder}
                }
        dep = new_resource(
            "Deployment",
            tb.metadata.name,
            tb.metadata.namespace,
            spec={
                "replicas": 1,
                "selector": {"matchLabels": {"tensorboard": tb.metadata.name}},
                "template": {
                    "metadata": {
                        "labels": {"tensorboard": tb.metadata.name}
                    },
                    "spec": pod_spec,
                },
            },
        )
        dep.metadata.owner_references = [owner_ref(tb)]
        return dep

    def _pvc_holder(self, namespace: str, pvc_name: str) -> str | None:
        """Name of a running pod already mounting the PVC (RWO
        co-scheduling, tensorboard_controller.go:440)."""
        for pod in self.api.list("Pod", namespace):
            for vol in pod.spec.get("volumes", []):
                claim = vol.get("persistentVolumeClaim", {})
                if claim.get("claimName") == pvc_name and (
                    pod.status.get("phase") == "Running"
                ):
                    return pod.metadata.name
        return None

    def _desired_service(self, tb: Resource) -> Resource:
        svc = new_resource(
            "Service",
            tb.metadata.name,
            tb.metadata.namespace,
            spec={
                "selector": {"tensorboard": tb.metadata.name},
                "ports": [{"port": 80, "targetPort": 6006}],
            },
        )
        svc.metadata.owner_references = [owner_ref(tb)]
        return svc

    def _desired_vs(self, tb: Resource) -> Resource:
        prefix = f"/tensorboard/{tb.metadata.namespace}/{tb.metadata.name}/"
        vs = new_resource(
            "VirtualService",
            f"tensorboard-{tb.metadata.namespace}-{tb.metadata.name}",
            tb.metadata.namespace,
            spec={
                "gateways": ["kubeflow/kubeflow-gateway"],
                "hosts": ["*"],
                "http": [
                    {
                        "match": [{"uri": {"prefix": prefix}}],
                        "rewrite": {"uri": "/"},
                        "route": [
                            {
                                "destination": {
                                    "host": f"{tb.metadata.name}."
                                    f"{tb.metadata.namespace}.svc",
                                    "port": {"number": 80},
                                }
                            }
                        ],
                    }
                ],
            },
        )
        vs.metadata.owner_references = [owner_ref(tb)]
        return vs

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            tb = api.get(KIND, name, ns)
        except NotFound:
            return Result()
        if tb.metadata.deletion_timestamp is not None:
            return Result()
        api.apply(self._desired_deployment(tb))
        api.apply(self._desired_service(tb))
        api.apply(self._desired_vs(tb))

        dep = api.get("Deployment", name, ns)
        new_status = dict(tb.status)
        new_status["readyReplicas"] = dep.status.get("readyReplicas", 0)
        if new_status != tb.status:
            tb = tb.thaw()
            tb.status = new_status
            api.update_status(tb)
        return Result()
