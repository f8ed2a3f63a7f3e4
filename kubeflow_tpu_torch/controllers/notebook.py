"""Notebook controller: a Notebook CR becomes a StatefulSet, a Service
and a VirtualService.

Counterpart of `kubeflow_tpu/controllers/notebook.py`, whole:

- a one-replica StatefulSet, or zero replicas while the stop annotation
  is present;
- a Service, port 80 to the notebook's 8888;
- a VirtualService routing `/notebook/<ns>/<name>/`;
- the pod's state mirrored onto the CR's status (`readyReplicas`,
  `containerState`);
- culling by periodic requeue with an activity probe: Jupyter's
  `/api/status` (`http_activity_probe`), the accelerator's duty cycle
  (`tpu_duty_probe`) or the latest of several (`combined_probe`). A
  probe that fails never culls, and a notebook that is not Running is
  never culled.

Notebooks default to the port's PyTorch image (`DEFAULT_IMAGE`), and
culling is a cost feature: an idle notebook may be holding a GPU.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.api.tpujob import ACCELERATOR_RESOURCE
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

KIND = "Notebook"
STOP_ANNOTATION = "kubeflow-resource-stopped"  # culler.go:37
DEFAULT_IMAGE = "kubeflow-tpu/torch-notebook:latest"
DEFAULT_PORT = 8888


@dataclasses.dataclass(frozen=True)
class CullerConfig:
    """Env-knob parity with culler.go:24-27."""

    enabled: bool = False
    idle_seconds: float = 3600.0
    check_period_seconds: float = 60.0


# Probe returns the notebook's last-activity timestamp (epoch seconds) or
# None if unreachable. `http_activity_probe` is the production probe
# (Jupyter's /api/status, culler.go:138-143); `tpu_duty_probe` treats a
# busy TPU as activity; tests inject fakes.
ActivityProbe = Callable[[Resource], float | None]


def _never_active(_nb: Resource) -> float | None:
    return None


def _parse_last_activity(raw: str) -> float | None:
    """Jupyter's ISO-8601 `last_activity` → epoch seconds."""
    import datetime

    try:
        stamp = datetime.datetime.fromisoformat(raw.replace("Z", "+00:00"))
    except (ValueError, AttributeError, TypeError):
        return None
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=datetime.timezone.utc)
    return stamp.timestamp()


def http_activity_probe(
    base_url: Callable[[Resource], str] | None = None,
    timeout: float = 2.0,
) -> ActivityProbe:
    """The reference culler's probe (`culler.go:138-143`): GET the
    notebook's Jupyter `/api/status` through its Service and read
    `last_activity`. Unreachable/garbage ⇒ None (fail-safe: never cull on
    a probe failure). `base_url` overrides the in-cluster
    `http://<name>.<ns>.svc` for local setups/tests."""
    import http.client
    import json as _json
    import urllib.error
    import urllib.request

    def default_base(nb: Resource) -> str:
        return f"http://{nb.metadata.name}.{nb.metadata.namespace}.svc"

    base = base_url or default_base

    def probe(nb: Resource) -> float | None:
        url = f"{base(nb)}{route_prefix(nb)}/api/status"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                body = _json.loads(resp.read())
        except (
            urllib.error.URLError,
            http.client.HTTPException,  # BadStatusLine, IncompleteRead
            ValueError,
            OSError,
        ):
            return None
        if not isinstance(body, dict):
            return None  # valid JSON but not the status object: garbage
        return _parse_last_activity(body.get("last_activity"))

    return probe


def tpu_duty_probe(
    api: FakeApiServer,
    threshold: float = 0.05,
    clock: Callable[[], float] = time.time,
) -> ActivityProbe:
    """Accelerator-aware activity: a notebook whose accelerator is
    running kernels is active now even if no browser has touched
    Jupyter, so a long training cell is never culled mid-run. Reads the
    `tpuDutyCycle` mirrored on the Node hosting the notebook's pod, and
    only for pods whose limits ask the accelerator: on the port that is
    `nvidia.com/gpu` (`api/tpujob.ACCELERATOR_RESOURCE`), the standing
    translation of the JAX package's `google.com/tpu`. The function's
    name and the Node's `tpuDutyCycle` field stay as the JAX package
    names them, since its CLI and dashboard read them. A notebook with
    no accelerator on a busy Node does not ride a co-tenant's duty
    cycle. (Attribution is Node-granular for pods that hold the
    accelerator.)"""

    def _requests_tpu(pod: Resource) -> bool:
        for container in pod.spec.get("containers", []):
            limits = container.get("resources", {}).get("limits", {})
            chips = limits.get(ACCELERATOR_RESOURCE)
            if isinstance(chips, (int, float)) and chips > 0:
                return True
            if isinstance(chips, str) and chips.isdigit() and int(chips) > 0:
                return True
        return False

    def probe(nb: Resource) -> float | None:
        pods = api.list(
            "Pod",
            nb.metadata.namespace,
            label_selector={"notebook": nb.metadata.name},
        )
        for pod in pods:
            node_name = pod.spec.get("nodeName")
            if not node_name or not _requests_tpu(pod):
                continue
            try:
                node = api.get("Node", node_name, "")
            except NotFound:
                continue
            duty = node.status.get("tpuDutyCycle")
            if isinstance(duty, (int, float)) and duty > threshold:
                return clock()  # busy chips = active now
        return None

    return probe


def combined_probe(*probes: ActivityProbe) -> ActivityProbe:
    """Latest activity across several probes (jupyter HTTP + TPU duty):
    any one reporting recent activity keeps the notebook alive."""

    def probe(nb: Resource) -> float | None:
        stamps = [p(nb) for p in probes]
        stamps = [s for s in stamps if s is not None]
        return max(stamps) if stamps else None

    return probe


class NotebookController:
    def __init__(
        self,
        api: FakeApiServer,
        *,
        culler: CullerConfig | None = None,
        activity_probe: ActivityProbe = _never_active,
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.api = api
        self.culler = culler or CullerConfig()
        self.probe = activity_probe
        self.clock = clock
        metrics = metrics or MetricsRegistry()
        # Metric parity with pkg/metrics/metrics.go:22-99.
        self.running = metrics.gauge(
            "notebook_running", "notebooks with a running workload"
        )
        self.created_total = metrics.counter(
            "notebook_create_total", "notebooks created"
        )
        self.culled_total = metrics.counter(
            "notebook_culled_total", "notebooks culled for idleness"
        )
        self.controller = Controller(
            api,
            KIND,
            self.reconcile,
            owns=("StatefulSet", "Service", "VirtualService"),
            name="notebook-controller",
            metrics=metrics,
        )
        api.watch(self._count_created, KIND)
        # Workload pods are created by the StatefulSet machinery, not by us,
        # so they carry no ownerReference to the Notebook — map them back by
        # label (SetupWithManager's pod watch, notebook_controller.go:516).
        api.watch(self._on_pod, "Pod")

    def _count_created(self, event: str, obj: Resource) -> None:
        if event == "ADDED":
            self.created_total.inc()

    def _on_pod(self, event: str, pod: Resource) -> None:
        name = pod.metadata.labels.get("notebook")
        if name:
            self.controller.enqueue((pod.metadata.namespace, name))

    # -- desired children --------------------------------------------------

    def _desired_sts(self, nb: Resource) -> Resource:
        stopped = STOP_ANNOTATION in nb.metadata.annotations
        # The Notebook spec embeds pod-template fields the spawner sets
        # (volumes, env, tolerations, affinity, shm) — the reference CRD
        # carries a full PodSpec (`notebook_types.go:30-85`, populated by
        # `jupyter-web-app/.../utils.py:359-586`).
        container = {
            "name": "notebook",
            "image": nb.spec.get("image", DEFAULT_IMAGE),
            "env": [
                # NB_PREFIX parity (tensorflow-notebook-image start.sh).
                {
                    "name": "NB_PREFIX",
                    "value": route_prefix(nb),
                }
            ]
            + list(nb.spec.get("env", [])),
            "ports": [{"containerPort": DEFAULT_PORT}],
            "resources": nb.spec.get("resources", {}),
        }
        if nb.spec.get("volumeMounts"):
            container["volumeMounts"] = list(nb.spec["volumeMounts"])
        pod_spec: dict = {"containers": [container]}
        for field in ("volumes", "tolerations", "affinity", "nodeSelector"):
            if nb.spec.get(field):
                pod_spec[field] = nb.spec[field]
        template_meta: dict = {"labels": {"notebook": nb.metadata.name}}
        # PodDefault selection labels flow onto the pod template so the
        # admission webhook can match them (`poddefault_types.go` selector).
        extra_labels = nb.spec.get("podLabels", {})
        template_meta["labels"].update(extra_labels)
        # The selector label is reserved — a user-chosen podLabel must not
        # break the STS selector / Service routing / pod lookup.
        template_meta["labels"]["notebook"] = nb.metadata.name
        sts = new_resource(
            "StatefulSet",
            nb.metadata.name,
            nb.metadata.namespace,
            spec={
                "replicas": 0 if stopped else 1,
                "selector": {"matchLabels": {"notebook": nb.metadata.name}},
                "template": {
                    "metadata": template_meta,
                    "spec": pod_spec,
                },
            },
            labels={"notebook": nb.metadata.name},
        )
        sts.metadata.owner_references = [owner_ref(nb)]
        return sts

    def _desired_service(self, nb: Resource) -> Resource:
        svc = new_resource(
            "Service",
            nb.metadata.name,
            nb.metadata.namespace,
            spec={
                "selector": {"notebook": nb.metadata.name},
                "ports": [{"port": 80, "targetPort": DEFAULT_PORT}],
            },
        )
        svc.metadata.owner_references = [owner_ref(nb)]
        return svc

    def _desired_vs(self, nb: Resource) -> Resource:
        # Trailing slash (notebook_controller.go:383): without it the
        # prefix for "train" also captures "train2"'s routes.
        prefix = route_prefix(nb) + "/"
        vs = new_resource(
            "VirtualService",
            f"notebook-{nb.metadata.namespace}-{nb.metadata.name}",
            nb.metadata.namespace,
            spec={
                "gateways": ["kubeflow/kubeflow-gateway"],
                "hosts": ["*"],
                "http": [
                    {
                        "match": [{"uri": {"prefix": prefix}}],
                        "rewrite": {"uri": prefix},
                        "route": [
                            {
                                "destination": {
                                    "host": f"{nb.metadata.name}."
                                    f"{nb.metadata.namespace}.svc",
                                    "port": {"number": 80},
                                }
                            }
                        ],
                    }
                ],
            },
        )
        vs.metadata.owner_references = [owner_ref(nb)]
        return vs

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            nb = api.get(KIND, name, ns)
        except NotFound:
            self._census(api)
            return Result()
        if nb.metadata.deletion_timestamp is not None:
            return Result()

        api.apply(self._desired_sts(nb))
        api.apply(self._desired_service(nb))
        api.apply(self._desired_vs(nb))

        # Mirror workload state to status (controller.go:197-228): ready iff
        # the pod reports Running and not stop-annotated.
        stopped = STOP_ANNOTATION in nb.metadata.annotations
        pods = api.list("Pod", ns, label_selector={"notebook": name})
        pod_phase = pods[0].status.get("phase") if pods else None
        new_status = dict(nb.status)
        new_status["readyReplicas"] = 1 if pod_phase == "Running" else 0
        new_status["containerState"] = (
            "Waiting" if (not stopped and pod_phase != "Running") else
            ("Terminated" if stopped else "Running")
        )
        if new_status != nb.status:
            nb = nb.thaw()
            nb.status = new_status
            api.update_status(nb)

        result = Result()
        if self.culler.enabled and not stopped:
            # Only probe a notebook that is actually serving — a pending or
            # restarting one has no activity yet and must not be culled.
            if pod_phase == "Running":
                self._maybe_cull(api, nb)
            result = Result(requeue_after=self.culler.check_period_seconds)
        self._census(api)
        return result

    def _maybe_cull(self, api: FakeApiServer, nb: Resource) -> None:
        """culler.go:171-191: idle iff last activity older than IDLE_TIME.
        Unreachable probe => not culled (fail-safe, as upstream)."""
        last = self.probe(nb)
        if last is None:
            return
        if self.clock() - last < self.culler.idle_seconds:
            return
        fresh = api.get(KIND, nb.metadata.name, nb.metadata.namespace).thaw()
        if STOP_ANNOTATION in fresh.metadata.annotations:
            return
        fresh.metadata.annotations[STOP_ANNOTATION] = str(self.clock())
        api.update(fresh)
        api.record_event(
            fresh, "Culled", "notebook idle; scaling to zero", type_="Normal"
        )
        self.culled_total.inc()

    def _census(self, api: FakeApiServer) -> None:
        self.running.set(
            sum(
                1
                for nb in api.list(KIND)
                if nb.status.get("readyReplicas", 0) > 0
            )
        )


def route_prefix(nb: Resource) -> str:
    return f"/notebook/{nb.metadata.namespace}/{nb.metadata.name}"
