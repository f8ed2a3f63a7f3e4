"""Notebook spawner backend — the jupyter-web-app analog.

A copy of `kubeflow_tpu/apps/jupyter.py` (a module with no JAX in it),
whole, with one departure for the accelerator: the form's `tpu` field
(its JAX name, so the same request spawns on either package) is a count
of `nvidia.com/gpu` (`TPU_RESOURCE`, the name the JAX module gives the
accelerator resource), and `tpuTopology` is accepted and dropped: a
slice topology has no meaning on one card, so the Notebook gets no
topology nodeSelector. The notebooks list keeps its ``tpus`` column.

Parity with `components/jupyter-web-app/backend/` and
`crud-web-apps/jupyter/backend/` (SURVEY.md §2 #13/#16):

- GET  `/api/config` — the admin spawner form config
  (`base_app.py:22-50`, `spawner_ui_config.yaml`);
- GET  `/api/namespaces/<ns>/notebooks` — list with mirrored status
  (`crud-web-apps/jupyter/.../get.py:42`);
- POST `/api/namespaces/<ns>/notebooks` — form → Notebook CR + PVCs
  (`default/app.py:13-76`, transforms `common/utils.py:359-586`);
- PATCH `.../notebooks/<name>` — stop/start via the culler's
  `kubeflow-resource-stopped` annotation (`patch.py`);
- DELETE `.../notebooks/<name>`;
- GET  `/api/namespaces/<ns>/pvcs`, `/api/namespaces/<ns>/poddefaults`,
  `/api/storageclasses` — form data sources (`common/api.py:81-197`);
- GET/POST `/api/namespaces/<ns>/snapshots` (+ DELETE by name) and the
  `Snapshot` workspace-volume type — the snapshot-restore flow the
  reference shipped as the jupyter app's "rok" variant
  (`jupyter-web-app/backend/kubeflow_jupyter/rok/`,
  `crud-web-apps/jupyter/backend/apps/rok/routes/post.py`): snapshot a
  notebook's workspace PVC, then spawn a new notebook whose workspace
  restores from it (PVC `dataSource` → VolumeSnapshot).

Every handler is SAR-guarded per (verb, resource, namespace) exactly like
`common/auth.py:41-106`.
"""

from __future__ import annotations

import pathlib
import time

import yaml

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.tpujob import ACCELERATOR_RESOURCE
from kubeflow_tpu_torch.controllers.notebook import STOP_ANNOTATION
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    FakeApiServer,
    NotFound,
)
from kubeflow_tpu_torch.web import (
    App,
    HeaderAuthn,
    HttpError,
    Request,
    Response,
    ensure_authorized,
    success_response,
)

CONFIG_PATH = pathlib.Path(__file__).parent / "config" / "spawner_ui_config.yaml"
TPU_RESOURCE = ACCELERATOR_RESOURCE


def load_spawner_config(path: pathlib.Path | str = CONFIG_PATH) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)["spawnerFormDefaults"]


class JupyterApp(App):
    def __init__(
        self,
        api: FakeApiServer,
        *,
        config_path: pathlib.Path | str = CONFIG_PATH,
        authn: HeaderAuthn | None = None,
    ):
        super().__init__("jupyter")
        self.mount_static(
            pathlib.Path(__file__).parent / "static", "jupyter.html"
        )
        self.api = api
        self.config = load_spawner_config(config_path)
        self.before_request(authn or HeaderAuthn())
        self.add_route("/api/config", self.get_config)
        # The shared namespace selector's data source — crud_backend
        # exposes the same on every CRUD app so pages work standalone,
        # not only iframed under the dashboard.
        self.add_route("/api/namespaces", self.get_namespaces)
        self.add_route("/api/namespaces/<ns>/notebooks", self.list_notebooks)
        self.add_route(
            "/api/namespaces/<ns>/notebooks", self.post_notebook, ("POST",)
        )
        self.add_route(
            "/api/namespaces/<ns>/notebooks/<name>",
            self.patch_notebook,
            ("PATCH",),
        )
        self.add_route(
            "/api/namespaces/<ns>/notebooks/<name>",
            self.delete_notebook,
            ("DELETE",),
        )
        self.add_route("/api/namespaces/<ns>/pvcs", self.list_pvcs)
        self.add_route(
            "/api/namespaces/<ns>/poddefaults", self.list_poddefaults
        )
        self.add_route("/api/storageclasses", self.list_storageclasses)
        self.add_route("/api/namespaces/<ns>/snapshots", self.list_snapshots)
        self.add_route(
            "/api/namespaces/<ns>/snapshots", self.post_snapshot, ("POST",)
        )
        self.add_route(
            "/api/namespaces/<ns>/snapshots/<name>",
            self.delete_snapshot,
            ("DELETE",),
        )

    # -- reads -------------------------------------------------------------

    def get_config(self, req: Request) -> Response:
        return success_response("config", self.config)

    def get_namespaces(self, req: Request) -> Response:
        from kubeflow_tpu_torch.apps.common import namespaces_response

        return namespaces_response(self.api, req)

    def list_notebooks(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "notebooks", ns, request=req)
        items = []
        for nb in self.api.list("Notebook", ns):
            items.append(
                {
                    "name": nb.metadata.name,
                    "namespace": ns,
                    "image": nb.spec.get("image"),
                    "shortImage": str(nb.spec.get("image", "")).split("/")[-1],
                    "cpu": nb.spec.get("resources", {})
                    .get("requests", {})
                    .get("cpu"),
                    "memory": nb.spec.get("resources", {})
                    .get("requests", {})
                    .get("memory"),
                    "tpus": nb.spec.get("resources", {})
                    .get("limits", {})
                    .get(TPU_RESOURCE, 0),
                    "status": self._status_phase(nb),
                    "reason": nb.status.get("containerState", ""),
                    "age": nb.metadata.creation_timestamp,
                    "volumes": [
                        v.get("name") for v in nb.spec.get("volumes", [])
                    ],
                    "serverType": "jupyter",
                }
            )
        return success_response("notebooks", items)

    @staticmethod
    def _status_phase(nb) -> str:
        # The frontend's row-status mapping (crud-web-apps status utils):
        # stopped > ready > waiting.
        if STOP_ANNOTATION in nb.metadata.annotations:
            return "stopped"
        if nb.status.get("readyReplicas", 0) > 0:
            return "running"
        return "waiting"

    def list_pvcs(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "persistentvolumeclaims", ns, request=req)
        pvcs = [
            {
                "name": p.metadata.name,
                "size": p.spec.get("resources", {})
                .get("requests", {})
                .get("storage"),
                "mode": (p.spec.get("accessModes") or [""])[0],
            }
            for p in self.api.list("PersistentVolumeClaim", ns)
        ]
        return success_response("pvcs", pvcs)

    def list_poddefaults(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "poddefaults", ns, request=req)
        pds = [
            {
                "label": pd.spec.get("selector", {}).get("matchLabels", {}),
                "desc": pd.spec.get("desc", pd.metadata.name),
                "name": pd.metadata.name,
            }
            for pd in self.api.list("PodDefault", ns)
        ]
        return success_response("poddefaults", pds)

    def list_storageclasses(self, req: Request) -> Response:
        ensure_authorized(self.api, req.user, "list", "storageclasses", "", request=req)
        return success_response(
            "storageclasses",
            [sc.metadata.name for sc in self.api.list("StorageClass", "")],
        )

    # -- create ------------------------------------------------------------

    def post_notebook(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "create", "notebooks", ns, request=req)
        body = req.json()
        name = body.get("name")
        if not name:
            raise HttpError(400, "notebook needs a name")

        spec: dict = {}
        self._set_image(spec, body)
        self._set_resources(spec, body)
        self._set_volumes(spec, body, ns, name)
        self._set_scheduling(spec, body)
        self._set_configurations(spec, body)

        nb = new_resource(
            "Notebook",
            name,
            ns,
            spec=spec,
            labels={"app": name},
        )
        self.api.create(nb)
        return success_response("notebook", nb.to_dict())

    def _form_default(self, field: str, body: dict):
        """Honor readOnly: a pinned field ignores the client's value
        (`utils.py` checks `readOnly` before every set_notebook_*)."""
        cfg = self.config.get(field, {})
        if cfg.get("readOnly"):
            return cfg.get("value")
        return body.get(field, cfg.get("value"))

    def _set_image(self, spec: dict, body: dict) -> None:
        # customImage is only honored when the image field is NOT pinned —
        # otherwise it would bypass the admin's allowlist entirely.
        if not self.config.get("image", {}).get("readOnly") and body.get(
            "customImage"
        ):
            spec["image"] = body["customImage"]
            return
        spec["image"] = self._form_default("image", body)

    def _set_resources(self, spec: dict, body: dict) -> None:
        cpu = str(self._form_default("cpu", body))
        memory = str(self._form_default("memory", body))
        requests = {"cpu": cpu, "memory": memory}
        limits: dict = {}
        tpu = str(self._form_default("tpu", body) or "none")
        if tpu not in ("none", "0", "None"):
            if not tpu.isdigit():
                raise HttpError(
                    400, f"tpu must be a chip count or 'none', got {tpu!r}"
                )
            # GPUs are limits-only and integral (`utils.py
            # set_notebook_gpus`). The form's tpuTopology is ignored.
            limits[TPU_RESOURCE] = int(tpu)
        spec["resources"] = {"requests": requests}
        if limits:
            spec["resources"]["limits"] = limits

    def _set_volumes(
        self, spec: dict, body: dict, ns: str, name: str
    ) -> None:
        """Workspace + data volumes; type New creates the PVC
        (`default/app.py:36-68` → `common/api.py:174`)."""
        volumes: list[dict] = []
        mounts: list[dict] = []
        ws = self._form_default("workspaceVolume", body)
        vols = [ws] if ws else []
        vols += list(self._form_default("dataVolumes", body) or [])
        for vol in vols:
            vol_name = str(vol.get("name", "")).replace("{name}", name)
            vol_type = vol.get("type", "New")
            if not vol_name:
                if vol_type == "Existing":
                    # Silently dropping the volume would create a
                    # notebook whose /home/jovyan lives on the container
                    # filesystem — data loss on the first stop/cull.
                    raise HttpError(
                        400, "Existing volume needs a PVC name"
                    )
                continue
            if vol_type in ("New", "Snapshot"):
                pvc = new_resource(
                    "PersistentVolumeClaim",
                    vol_name,
                    ns,
                    spec={
                        "accessModes": [vol.get("accessMode", "ReadWriteOnce")],
                        "resources": {
                            "requests": {"storage": vol.get("size", "10Gi")}
                        },
                    },
                )
                if vol_type == "Snapshot":
                    # Restore-from-snapshot (the rok flow): the PVC's
                    # dataSource points at a ready VolumeSnapshot; size
                    # defaults to the snapshot's restoreSize.
                    snap_name = vol.get("snapshot")
                    if not snap_name:
                        raise HttpError(
                            400, "Snapshot volume needs a 'snapshot' name"
                        )
                    try:
                        snap = self.api.get("VolumeSnapshot", snap_name, ns)
                    except NotFound:
                        raise HttpError(
                            400, f"snapshot {snap_name!r} not found"
                        ) from None
                    if not snap.status.get("readyToUse"):
                        raise HttpError(
                            400, f"snapshot {snap_name!r} is not ready"
                        )
                    pvc.spec["dataSource"] = {
                        "kind": "VolumeSnapshot",
                        "name": snap_name,
                    }
                    restore = snap.status.get("restoreSize")
                    if restore and not vol.get("size"):
                        pvc.spec["resources"]["requests"]["storage"] = restore
                if body.get("storageClass"):
                    pvc.spec["storageClassName"] = body["storageClass"]
                try:
                    self.api.create(pvc)
                except AlreadyExists:
                    if vol_type == "Snapshot":
                        # Reusing an existing PVC would silently skip the
                        # restore — the notebook would mount old data
                        # while the form promised snapshot contents.
                        raise HttpError(
                            409,
                            f"pvc {vol_name!r} already exists; a Snapshot "
                            "volume needs a fresh claim name",
                        ) from None
                    # Existing PVC with the same name: reuse it (the
                    # reference 409s inside a loop and carries on). Any
                    # other failure must surface, not leave the notebook
                    # pointing at a PVC that was never provisioned.
                    pass
            volumes.append(
                {
                    "name": vol_name,
                    "persistentVolumeClaim": {"claimName": vol_name},
                }
            )
            mounts.append(
                {
                    "name": vol_name,
                    "mountPath": vol.get("mountPath", f"/data/{vol_name}"),
                }
            )
        if self._form_default("shm", body):
            # set_notebook_shm: a memory-backed emptyDir on /dev/shm.
            volumes.append(
                {"name": "dshm", "emptyDir": {"medium": "Memory"}}
            )
            mounts.append({"name": "dshm", "mountPath": "/dev/shm"})
        if volumes:
            spec["volumes"] = volumes
            spec["volumeMounts"] = mounts

    def _set_scheduling(self, spec: dict, body: dict) -> None:
        group = self._form_default("tolerationGroup", body)
        if isinstance(group, str) and group:
            for option in self.config.get("tolerationGroup", {}).get(
                "options", []
            ):
                if option.get("group") == group:
                    spec["tolerations"] = option.get("tolerations", [])
        affinity = self._form_default("affinityConfig", body)
        if isinstance(affinity, dict) and affinity:
            spec["affinity"] = affinity

    def _set_configurations(self, spec: dict, body: dict) -> None:
        """PodDefault labels (`utils.py set_notebook_configurations`)."""
        labels = {}
        for conf in self._form_default("configurations", body) or []:
            labels[str(conf)] = "true"
        if labels:
            spec["podLabels"] = labels

    # -- snapshots (the rok-variant analog) --------------------------------

    def list_snapshots(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "volumesnapshots", ns, request=req)
        snapshots = [
            {
                "name": s.metadata.name,
                "source": s.spec.get("source"),
                "ready": bool(s.status.get("readyToUse")),
                "restoreSize": s.status.get("restoreSize"),
                "created": s.metadata.creation_timestamp,
            }
            for s in self.api.list("VolumeSnapshot", ns)
        ]
        return success_response("snapshots", snapshots)

    def post_snapshot(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "create", "volumesnapshots", ns, request=req)
        body = req.json()
        source = body.get("pvc")
        if not source:
            raise HttpError(400, "body needs {'pvc': <claim name>}")
        try:
            pvc = self.api.get("PersistentVolumeClaim", source, ns)
        except NotFound:
            raise HttpError(404, f"pvc {source!r} not found") from None
        name = body.get("name") or f"{source}-{int(time.time())}"
        snapshot = new_resource(
            "VolumeSnapshot",
            name,
            ns,
            spec={"source": source},
        )
        # Local stand-in for the CSI snapshotter: ready immediately, the
        # restore size mirrors the source claim. On a real cluster the
        # external-snapshotter fills status asynchronously.
        snapshot.status = {
            "readyToUse": True,
            "restoreSize": pvc.spec.get("resources", {})
            .get("requests", {})
            .get("storage"),
        }
        self.api.create(snapshot)
        return success_response("snapshot", snapshot.to_dict())

    def delete_snapshot(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        ensure_authorized(self.api, req.user, "delete", "volumesnapshots", ns, request=req)
        self.api.delete("VolumeSnapshot", name, ns)
        return success_response()

    # -- mutate/delete -----------------------------------------------------

    def patch_notebook(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        ensure_authorized(self.api, req.user, "update", "notebooks", ns, request=req)
        body = req.json()
        if "stopped" not in body:
            raise HttpError(400, "PATCH body needs {'stopped': bool}")
        nb = self.api.get("Notebook", name, ns).thaw()
        if body["stopped"]:
            nb.metadata.annotations.setdefault(
                STOP_ANNOTATION, str(time.time())
            )
        else:
            nb.metadata.annotations.pop(STOP_ANNOTATION, None)
        self.api.update(nb)
        return success_response()

    def delete_notebook(self, req: Request) -> Response:
        ns, name = req.path_params["ns"], req.path_params["name"]
        ensure_authorized(self.api, req.user, "delete", "notebooks", ns, request=req)
        self.api.delete("Notebook", name, ns)
        return success_response()


__all__ = ["JupyterApp", "load_spawner_config", "TPU_RESOURCE"]
