"""Tensorboard CRUD backend — `crud-web-apps/tensorboards` analog.

A copy of `kubeflow_tpu/apps/tensorboards.py` (a module with no JAX in
it), whole: list, create and delete `Tensorboard` CRs, plus the PVC
listing the create form needs. `logspath` points at a PVC
(``pvc://<claim>/<subpath>``) or cloud storage; on the port a training
job's trace directory is what `train/profiling.Profiler` writes (the LM
worker's ``KFTPU_TRACE_DIR``), which TensorBoard's PyTorch profiler
plugin reads.
"""

from __future__ import annotations

import pathlib

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import (
    App,
    HeaderAuthn,
    HttpError,
    Request,
    Response,
    ensure_authorized,
    success_response,
)


class TensorboardsApp(App):
    def __init__(self, api: FakeApiServer, *, authn: HeaderAuthn | None = None):
        super().__init__("tensorboards")
        self.mount_static(
            pathlib.Path(__file__).parent / "static", "tensorboards.html"
        )
        self.api = api
        self.before_request(authn or HeaderAuthn())
        self.add_route("/api/namespaces", self.get_namespaces)
        self.add_route("/api/namespaces/<ns>/tensorboards", self.list_tbs)
        self.add_route(
            "/api/namespaces/<ns>/tensorboards", self.post_tb, ("POST",)
        )
        self.add_route(
            "/api/namespaces/<ns>/tensorboards/<name>",
            self.delete_tb,
            ("DELETE",),
        )
        self.add_route("/api/namespaces/<ns>/pvcs", self.list_pvcs)

    def get_namespaces(self, req: Request) -> Response:
        from kubeflow_tpu_torch.apps.common import namespaces_response

        return namespaces_response(self.api, req)

    def list_tbs(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "tensorboards", ns, request=req)
        items = [
            {
                "name": tb.metadata.name,
                "namespace": ns,
                "logspath": tb.spec.get("logspath", ""),
                "age": tb.metadata.creation_timestamp,
                "status": "ready"
                if tb.status.get("readyReplicas", 0) > 0
                else "waiting",
            }
            for tb in self.api.list("Tensorboard", ns)
        ]
        return success_response("tensorboards", items)

    def post_tb(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "create", "tensorboards", ns, request=req)
        body = req.json()
        name, logspath = body.get("name"), body.get("logspath")
        if not name or not logspath:
            raise HttpError(400, "tensorboard needs name and logspath")
        tb = new_resource("Tensorboard", name, ns, spec={"logspath": logspath})
        self.api.create(tb)
        return success_response("tensorboard", tb.to_dict())

    def delete_tb(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        ensure_authorized(self.api, req.user, "delete", "tensorboards", ns, request=req)
        self.api.delete("Tensorboard", name, ns)
        return success_response()

    def list_pvcs(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "persistentvolumeclaims", ns, request=req)
        return success_response(
            "pvcs",
            [p.metadata.name for p in self.api.list("PersistentVolumeClaim", ns)],
        )
