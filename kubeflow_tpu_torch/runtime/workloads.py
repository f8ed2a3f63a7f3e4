"""Workload materializer: the StatefulSet/Deployment controller and the
kubelet stand-in of a one-host rig.

Counterpart of `kubeflow_tpu/runtime/workloads.py`, whole. On a real
cluster the built-in controllers and the kubelet turn a StatefulSet or
a Deployment into running pods and readiness status; a one-host rig has
neither, so notebooks and tensorboards would wait forever. This closes
the loop:

- each StatefulSet/Deployment gets `replicas` pods named `<name>-<i>`
  (a Deployment's `<name>-dp-<i>`), carrying the pod template's labels
  and spec and an ownerReference (so a cascade deletes them), created
  directly in phase Running: the `LocalPodRunner` only adopts pods with
  no phase, so a materialized pod never becomes a process;
- scale-down (the notebook's stop and cull set replicas 0) deletes the
  excess pods;
- `status.readyReplicas` / `status.replicas` are mirrored back onto the
  workload, which is what the notebook and tensorboard controllers read
  to report readiness;
- an admission refusal of a pod (`Invalid`, a quota's) is recorded as
  one PodRejected Warning on the workload per episode, not raised, so
  the other workloads still reconcile.
"""

from __future__ import annotations

import copy
import logging

from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    Conflict,
    FakeApiServer,
    Invalid,
    NotFound,
)

log = logging.getLogger(__name__)

WORKLOAD_KINDS = ("StatefulSet", "Deployment")
LABEL_WORKLOAD = "kubeflow-tpu.org/workload"
# Keeps a StatefulSet and a Deployment of one name in one namespace
# apart: without it they would adopt, and fight over, each other's pods.
LABEL_WORKLOAD_KIND = "kubeflow-tpu.org/workload-kind"


class WorkloadMaterializer:
    def __init__(self, api: FakeApiServer):
        self.api = api
        self._last_rejection: dict[str, str] = {}

    def step(self) -> None:
        for kind in WORKLOAD_KINDS:
            for workload in self.api.list(kind):
                try:
                    self._reconcile(workload)
                except (Conflict, AlreadyExists, NotFound):
                    pass  # raced with a controller; the next step converges
                except Invalid as e:
                    # Admission refused this workload's pod: contained to
                    # it, and told to its tenant.
                    self._note_rejection(workload, e)

    def _note_rejection(self, workload: Resource, error: Invalid) -> None:
        """One Event per rejection episode (keyed on the message): the
        tenant sees why their pods never appear."""
        marker = f"rejected:{workload.kind}/{workload.metadata.name}"
        if self._last_rejection.get(marker) == str(error):
            return
        self._last_rejection[marker] = str(error)
        try:
            self.api.record_event(workload, "PodRejected", str(error), type_="Warning")
        except Exception:
            log.warning("%s: pod rejected: %s", marker, error)

    @staticmethod
    def _pod_prefix(workload: Resource) -> str:
        """A StatefulSet's pods keep the ordinal form `<name>-<i>`; a
        Deployment's get a `-dp-` segment, so that a StatefulSet and a
        Deployment of one name never collide on pod names."""
        if workload.kind == "Deployment":
            return workload.metadata.name + "-dp-"
        return workload.metadata.name + "-"

    def _pods_of(self, workload: Resource) -> dict[int, Resource]:
        prefix = self._pod_prefix(workload)
        out: dict[int, Resource] = {}
        for pod in self.api.list("Pod", workload.metadata.namespace):
            labels = pod.metadata.labels
            if (
                labels.get(LABEL_WORKLOAD) != workload.metadata.name
                or labels.get(LABEL_WORKLOAD_KIND) != workload.kind
            ):
                continue
            suffix = pod.metadata.name.removeprefix(prefix)
            if suffix.isdigit():
                out[int(suffix)] = pod
        return out

    def _reconcile(self, workload: Resource) -> None:
        if workload.metadata.deletion_timestamp:
            return
        replicas = int(workload.spec.get("replicas", 1))
        template = workload.spec.get("template") or {}
        pods = self._pods_of(workload)

        created = 0
        for index in range(replicas):
            if index in pods:
                continue
            labels = dict((template.get("metadata") or {}).get("labels") or {})
            labels[LABEL_WORKLOAD] = workload.metadata.name
            labels[LABEL_WORKLOAD_KIND] = workload.kind
            pod = new_resource(
                "Pod",
                f"{self._pod_prefix(workload)}{index}",
                workload.metadata.namespace,
                spec=copy.deepcopy(template.get("spec") or {}),
                labels=labels,
            )
            pod.metadata.owner_references = [owner_ref(workload)]
            # Born Running: these pods stand for long-running servers
            # (jupyter, tensorboard), and a phase keeps the LocalPodRunner
            # from exec'ing the container image as a local process.
            pod.status["phase"] = "Running"
            self.api.create(pod)
            created += 1
            log.info("materialized pod %s/%s", pod.metadata.namespace, pod.metadata.name)

        for index, pod in pods.items():
            if index >= replicas:
                try:
                    self.api.delete("Pod", pod.metadata.name, pod.metadata.namespace)
                except NotFound:
                    pass

        # Pods created in this pass count too, so one step converges.
        ready = created + sum(
            1
            for index, pod in pods.items()
            if index < replicas and pod.status.get("phase") == "Running"
        )
        fresh = self.api.get(
            workload.kind, workload.metadata.name, workload.metadata.namespace
        ).thaw()
        desired_status = {"replicas": replicas, "readyReplicas": ready}
        if {k: fresh.status.get(k) for k in desired_status} != desired_status:
            fresh.status.update(desired_status)
            self.api.update_status(fresh)
