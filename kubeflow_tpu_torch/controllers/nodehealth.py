"""Node-health watchdog: lost Nodes fail their gangs' pods.

Counterpart of `kubeflow_tpu/controllers/nodehealth.py`, whole. A gang
that loses one host loses its collectives, while the surviving pods may
keep "Running" from the apiserver's point of view. This controller
supplies the missing signal:

- a Node that reports NotReady longer than a grace period (measured
  from the first observation, stamped as ``status.notReadySince``), or
  that is terminating or gone (hardware failure, a preempted VM), causes
  every active pod bound to it to be marked Failed with reason NodeLost
  and a Warning event;
- the TpuJob operator's all-or-nothing semantics then take over: the
  Failed pod triggers a bounded whole-gang restart (restarts <
  spec.maxRestarts), and the workload resumes from its last checkpoint
  (`train/checkpoint.py`'s auto-resume in `fit()`).

The gang scheduler places on every Node, ready or not, as the JAX
operator's does; this controller acts only on pods already bound.
"""


from __future__ import annotations

import logging
import time

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

REASON_NODE_LOST = "NodeLost"
DEFAULT_GRACE_SECONDS = 30.0


def node_ready(node: Resource) -> bool:
    return bool(node.status.get("ready", True))


def not_ready_since(node: Resource) -> float | None:
    return node.status.get("notReadySince")


class NodeHealthController:
    """Watches Nodes; fails pods stranded on lost/NotReady nodes.

    Pods are failed (status.phase = Failed, reason NodeLost) rather than
    deleted: deletion would read as a voluntary scale-down, while a
    Failed phase drives the owning gang's restart accounting
    (`tpujob.py` counts failures against spec.maxRestarts).
    """

    def __init__(
        self,
        api: FakeApiServer,
        *,
        grace_seconds: float = DEFAULT_GRACE_SECONDS,
        metrics: MetricsRegistry | None = None,
        clock=time.time,
    ):
        self.api = api
        self.grace_seconds = grace_seconds
        self._clock = clock
        metrics = metrics or MetricsRegistry()
        self.nodes_lost = metrics.counter(
            "node_lost_total", "nodes declared lost"
        )
        self.pods_failed = metrics.counter(
            "pods_failed_node_lost_total",
            "pods failed because their node was lost", ("node",),
        )
        self.controller = Controller(
            api, "Node", self.reconcile, name="nodehealth-controller",
            metrics=metrics,
        )
        # A DELETED Node event must still fail its pods — watch handles
        # deletion because reconcile sees NotFound.

    # -- reconcile --------------------------------------------------------

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key  # Nodes are cluster-scoped; ns is whatever they
        # were registered under (the cluster model uses one namespace).
        try:
            node = api.get("Node", name, ns)
        except NotFound:
            node = None
        if node is not None and node.metadata.deletion_timestamp is None:
            if node_ready(node):
                return Result()
            since = not_ready_since(node)
            now = self._clock()
            if since is None:
                # First observation of NotReady: stamp it so the grace
                # period is measured from detection, then re-check.
                fresh = api.get("Node", name, ns).thaw()
                fresh.status["notReadySince"] = now
                api.update_status(fresh)
                return Result(requeue_after=self.grace_seconds)
            remaining = since + self.grace_seconds - now
            if remaining > 0:
                return Result(requeue_after=remaining)
        # Node is gone, terminating, or past its NotReady grace: every
        # active pod bound to it has lost its hardware.
        failed = self._fail_pods_on(api, name)
        if failed:
            self.nodes_lost.inc()
            log.warning(
                "node %s lost; failed %d stranded pod(s)", name, failed
            )
        return Result()

    def _fail_pods_on(self, api: FakeApiServer, node_name: str) -> int:
        failed = 0
        for pod in api.list("Pod"):
            if pod.spec.get("nodeName") != node_name:
                continue
            if pod.status.get("phase") in ("Succeeded", "Failed"):
                continue
            fresh = api.get(
                "Pod", pod.metadata.name, pod.metadata.namespace
            ).thaw()
            fresh.status["phase"] = "Failed"
            fresh.status["reason"] = REASON_NODE_LOST
            fresh.status["message"] = (
                f"node {node_name} became unreachable (hardware failure or "
                "preemption); the gang lost a member"
            )
            api.update_status(fresh)
            api.record_event(
                fresh, REASON_NODE_LOST,
                f"pod's node {node_name} is gone", type_="Warning",
            )
            self.pods_failed.inc(node=node_name)
            failed += 1
        return failed
