"""Central dashboard API — the hub the other apps hang off.

A copy of `kubeflow_tpu/apps/dashboard.py` (a module with no JAX in it),
whole. It keeps the JAX wire names, so one request reads both packages:
the `tpuduty` series reads a Node's ``tpuDutyCycle`` (on the port's
Nodes the card's duty cycle) and a workload row's ``chips`` is the
TpuJob's ``tpu.chipsPerWorker`` x ``replicas`` (on the port, GPUs);
env-info's platform provider is ``gpu``.

Parity with `components/centraldashboard/app/` (SURVEY.md §2 #12, §3.5):

- identity middleware (`attach_user_middleware.ts`) → `HeaderAuthn`;
- GET `/api/namespaces`, `/api/activities/<ns>`, `/api/metrics/<type>`,
  `/api/dashboard-links` (`api.ts:30-71`, links ConfigMap
  `config/centraldashboard-links-config.yaml`);
- workgroup API (`api_workgroup.ts:249-338`): `/api/workgroup/exists`,
  `/create`, `/env-info`, `/nuke-self`, `/get-all-namespaces` — the
  registration flow that drives kfam/Profile creation (§3.4);
- a pluggable metrics service (`metrics_service.ts:21` interface;
  Stackdriver impl `stackdriver_metrics_service.ts:15`) — here a local
  implementation reads node/pod utilization mirrored into the API server,
  with TPU duty-cycle as a first-class series (idle chips are the cost).
"""

from __future__ import annotations

import pathlib
import time
from typing import Protocol

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import is_cluster_admin, namespaces_for
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.web import (
    App,
    HeaderAuthn,
    HttpError,
    Request,
    Response,
    ensure_authorized,
    json_response,
    success_response,
)

DEFAULT_LINKS = {
    # The links ConfigMap contract: menu items the SPA renders, each an
    # iframed sub-app behind the mesh gateway.
    "menuLinks": [
        {"type": "item", "link": "/jupyter/", "text": "Notebooks"},
        {"type": "item", "link": "/tensorboards/", "text": "Tensorboards"},
        {"type": "item", "link": "/tpujobs/", "text": "TpuJobs"},
    ],
    "externalLinks": [],
    "quickLinks": [
        {"text": "Spawn a PyTorch notebook", "link": "/jupyter/new"},
        {"text": "Submit a TpuJob", "link": "/tpujobs/new"},
    ],
}


class MetricsService(Protocol):
    """`metrics_service.ts:21`: time-series for the dashboard charts."""

    def query(self, metric: str, minutes: int) -> list[dict]: ...


class LocalMetricsService:
    """Reads utilization mirrored onto Node resources (the TPU analog of
    the Stackdriver node/pod CPU+memory series). Serves the instantaneous
    sample only — the `minutes` window is honored by history-backed
    implementations (Stackdriver in the reference)."""

    SERIES = ("nodecpu", "nodemem", "tpuduty")
    FIELD = {
        "nodecpu": "cpuUtilization",
        "nodemem": "memoryUtilization",
        "tpuduty": "tpuDutyCycle",
    }

    def __init__(self, api: FakeApiServer):
        self.api = api

    def query(self, metric: str, minutes: int) -> list[dict]:
        if metric not in self.SERIES:
            raise HttpError(400, f"unknown metric {metric!r}")
        field = self.FIELD[metric]
        points = []
        for node in self.api.list("Node", ""):
            value = node.status.get(field)
            if value is None:
                continue
            points.append(
                {
                    "node": node.metadata.name,
                    "timestamp": time.time(),
                    "value": value,
                }
            )
        return points


class DashboardApp(App):
    def __init__(
        self,
        api: FakeApiServer,
        *,
        metrics_service: MetricsService | None = None,
        links: dict | None = None,
        registration_flow: bool = True,
        authn: HeaderAuthn | None = None,
    ):
        super().__init__("centraldashboard")
        self.mount_static(pathlib.Path(__file__).parent / "static")
        self.api = api
        self.metrics_service = metrics_service or LocalMetricsService(api)
        self.links = links or DEFAULT_LINKS
        self.registration_flow = registration_flow
        self.before_request(authn or HeaderAuthn())
        self.add_route("/api/namespaces", self.get_namespaces)
        self.add_route("/api/activities/<ns>", self.get_activities)
        self.add_route("/api/workloads/<ns>", self.get_workloads)
        self.add_route("/api/metrics/<metric>", self.get_metrics)
        self.add_route("/api/dashboard-links", self.get_links)
        self.add_route("/api/workgroup/exists", self.workgroup_exists)
        self.add_route(
            "/api/workgroup/create", self.workgroup_create, ("POST",)
        )
        self.add_route("/api/workgroup/env-info", self.env_info)
        self.add_route(
            "/api/workgroup/nuke-self", self.nuke_self, ("DELETE",)
        )
        self.add_route(
            "/api/workgroup/get-all-namespaces", self.all_namespaces
        )

    # -- core reads (api.ts) ----------------------------------------------

    def get_namespaces(self, req: Request) -> Response:
        # Envelope-shaped like every other app's /api/namespaces (the
        # shared selector in ui.js reads payload.namespaces); the SPA's
        # own boot path reads namespaces from /api/workgroup/env-info.
        from kubeflow_tpu_torch.apps.common import namespaces_response

        return namespaces_response(self.api, req)

    def get_activities(self, req: Request) -> Response:
        ns = req.path_params["ns"]
        ensure_authorized(self.api, req.user, "list", "events", ns, request=req)
        events = [
            {
                "reason": ev.spec.get("reason"),
                "message": ev.spec.get("message"),
                "type": ev.spec.get("type"),
                "involvedObject": ev.spec.get("involvedObject", {}),
                "timestamp": ev.metadata.creation_timestamp,
            }
            for ev in self.api.list("Event", ns)
        ]
        events.sort(key=lambda e: e["timestamp"] or 0, reverse=True)
        return json_response(events)

    def get_workloads(self, req: Request) -> Response:
        """The namespace's accelerator workloads in one table — TpuJobs,
        Studies, Workflows with phase + chip ask. The reference's home
        page surfaces only Events; on a TPU platform the first question
        is 'what is holding chips right now'."""
        ns = req.path_params["ns"]
        # Per-resource SAR, like every other multi-read handler: the
        # table contains only the kinds this user may list.
        from kubeflow_tpu_torch.api.rbac import subject_access_review

        allowed = [
            (kind, resource)
            for kind, resource in (
                ("TpuJob", "tpujobs"),
                ("Study", "studies"),
                ("Workflow", "workflows"),
            )
            if subject_access_review(self.api, req.user, "list",
                                     resource, ns)
        ]
        if not allowed:
            ensure_authorized(self.api, req.user, "list", "tpujobs", ns, request=req)
        rows = []
        for kind, _ in allowed:
            for res in self.api.list(kind, ns):
                spec = res.spec or {}
                chips = (
                    spec.get("tpu", {}).get("chipsPerWorker", 0)
                    * spec.get("replicas", 1)
                    if kind == "TpuJob"
                    else None
                )
                rows.append(
                    {
                        "kind": kind,
                        "name": res.metadata.name,
                        "phase": res.status.get("phase", "Pending"),
                        "chips": chips,
                        "created": res.metadata.creation_timestamp,
                    }
                )
        rows.sort(key=lambda r: r["created"] or 0, reverse=True)
        return json_response(rows)

    def get_metrics(self, req: Request) -> Response:
        try:
            minutes = int(req.query.get("window", "15"))
        except ValueError:
            raise HttpError(400, "window must be an integer (minutes)")
        return json_response(
            self.metrics_service.query(req.path_params["metric"], minutes)
        )

    def get_links(self, req: Request) -> Response:
        # Admin-editable ConfigMap wins over the built-in default.
        try:
            cm = self.api.get("ConfigMap", "dashboard-links", "kubeflow")
            return json_response(cm.spec.get("data", self.links))
        except NotFound:
            return json_response(self.links)

    # -- workgroup / registration (api_workgroup.ts) -----------------------

    def _profiles_owned_by(self, user: str) -> list:
        return [
            p
            for p in self.api.list("Profile")
            if p.spec.get("owner", {}).get("name") == user
        ]

    def workgroup_exists(self, req: Request) -> Response:
        owned = self._profiles_owned_by(req.user)
        return json_response(
            {
                "hasAuth": True,
                "user": req.user,
                "hasWorkgroup": bool(owned),
                "registrationFlowAllowed": self.registration_flow,
            }
        )

    def workgroup_create(self, req: Request) -> Response:
        if not self.registration_flow:
            raise HttpError(403, "self-service registration is disabled")
        body = req.json()
        name = body.get("namespace") or req.user.split("@")[0].replace(
            ".", "-"
        )
        profile = new_resource(
            "Profile",
            name,
            "default",
            spec={"owner": {"kind": "User", "name": req.user}},
        )
        self.api.create(profile)
        return success_response("namespace", name)

    def env_info(self, req: Request) -> Response:
        owned = self._profiles_owned_by(req.user)
        return json_response(
            {
                "user": req.user,
                "platform": {
                    "provider": "gpu",
                    "kubeflowVersion": "kubeflow-tpu/v1",
                },
                "namespaces": namespaces_for(self.api, req.user),
                "isClusterAdmin": is_cluster_admin(self.api, req.user),
                "hasWorkgroup": bool(owned),
            }
        )

    def nuke_self(self, req: Request) -> Response:
        """Self-service teardown: delete every profile the user owns."""
        owned = self._profiles_owned_by(req.user)
        if not owned:
            raise HttpError(404, f"user {req.user!r} owns no workgroup")
        for profile in owned:
            self.api.delete(
                "Profile", profile.metadata.name, profile.metadata.namespace
            )
        return success_response(
            "deleted", [p.metadata.name for p in owned]
        )

    def all_namespaces(self, req: Request) -> Response:
        if not is_cluster_admin(self.api, req.user):
            raise HttpError(403, "cluster admin only")
        out = []
        for ns in self.api.list("Namespace", ""):
            out.append(
                [ns.metadata.name, ns.metadata.annotations.get("owner")]
            )
        return json_response(out)
