"""TpuJob operator: gang-scheduled training jobs.

Counterpart of `kubeflow_tpu/controllers/tpujob.py` (a module with no
JAX in it), on the port's API objects and store. It creates one pod per
worker, injects the coordination env and supervises the gang:

- **all-or-nothing gangs**: if the pod set is ever partial, the whole
  gang is torn down and re-created;
- **whole-gang restart on any failure**, bounded by spec.maxRestarts,
  counted in status.restarts; each gang's pods carry its incarnation
  (the restart count at creation) as a label;
- **placement** through the gang scheduler (`controllers/gang.py`)
  whenever Node objects exist: a topology names its pool, a
  topology-less gang tries every pool, most free accelerators first;
- the headless Service that gives every worker a stable DNS name.

The accelerator translation, the one difference from the JAX operator's
pods: a worker asks ``nvidia.com/gpu: <tpu.chipsPerWorker>`` where JAX's
asks ``google.com/tpu``, and carries no libtpu slice-assembly env
(TPU_WORKER_ID, TPU_WORKER_HOSTNAMES). Every TPUJOB_* variable and
TPUJOB_NAME/TPUJOB_NAMESPACE are the same. The scheduler reserves by the
resource the pod asks for.

Not ported yet (ROADMAP Queue 1 item 12, beside `Trainer.resize`):
priority preemption and elastic gang resize. A spec that asks for either
(`priority != 0`, `elasticMinReplicas > 0`) is refused by the admission
hook (`register_admission`) and, if it reached the store without it,
failed by reconcile with an ``Unsupported`` event; it is never run as if
the field were absent. Nor is quota admission.

Job phases: Pending → Running → Succeeded | Failed (with Restarting
transitions in between).
"""

from __future__ import annotations

import re

from kubeflow_tpu_torch.api.objects import (
    Resource,
    container_limits_total,
    new_resource,
    owner_ref,
)
from kubeflow_tpu_torch.api.tpujob import (
    ACCELERATOR_RESOURCE,
    COORDINATOR_PORT,
    KIND,
    TpuJobSpec,
)
from kubeflow_tpu_torch.controllers.gang import PlacementError, PyGangScheduler
from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    Key,
    Result,
    retry_on_conflict,
)
from kubeflow_tpu_torch.parallel.distributed import ProcessEnv
from kubeflow_tpu_torch.testing.fake_apiserver import (
    FakeApiServer,
    Invalid,
    NotFound,
)
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

LABEL_JOB = "kubeflow-tpu.org/job"
LABEL_WORKER = "kubeflow-tpu.org/worker-index"
# Gang incarnation (= restart count at creation): pod runners key per-gang
# resources (e.g. the local coordinator port) off this so a restarted gang
# never collides with its predecessor's.
LABEL_INCARNATION = "kubeflow-tpu.org/gang-incarnation"


def worker_name(job: str, index: int) -> str:
    return f"{job}-worker-{index}"


def register_admission(api: FakeApiServer) -> None:
    """Strict TpuJob spec validation at the store boundary (create and
    update): a typo'd field, or a field the port's operator cannot honour
    yet, is a 422 at submit time."""

    def validate(obj: Resource) -> Resource:
        try:
            spec = TpuJobSpec.from_dict(obj.spec)
        except Exception as e:
            raise Invalid(f"invalid TpuJob spec: {e}") from e
        unported = spec.unported_fields()
        if unported:
            raise Invalid(f"unsupported TpuJob spec: {'; '.join(unported)}")
        return obj

    api.register_admission(validate, kind=KIND)


def coordinator_address(job: Resource) -> str:
    # The headless service gives each pod a stable DNS name.
    ns = job.metadata.namespace
    return (f"{worker_name(job.metadata.name, 0)}.{job.metadata.name}.{ns}.svc:"
            f"{COORDINATOR_PORT}")


class TpuJobController:
    def __init__(self, api: FakeApiServer, metrics: MetricsRegistry | None = None):
        self.api = api
        self._pools: list[str] = []
        metrics = metrics or MetricsRegistry()
        self.jobs_running = metrics.gauge("tpujob_running", "TpuJobs currently running")
        self.gang_restarts = metrics.counter(
            "tpujob_gang_restarts_total", "whole-gang restarts", ("job",)
        )
        self.gang_placements = metrics.counter(
            "tpujob_gang_placements_total",
            "gang placements decided by the scheduler",
            ("backend",),
        )
        self.controller = Controller(
            api,
            KIND,
            self.reconcile,
            owns=("Pod", "Service"),
            name="tpujob-controller",
            metrics=metrics,
        )

    # -- desired state ----------------------------------------------------

    def _desired_service(self, job: Resource) -> Resource:
        svc = new_resource(
            "Service",
            job.metadata.name,
            job.metadata.namespace,
            spec={
                "clusterIP": "None",  # headless: per-pod DNS
                "selector": {LABEL_JOB: job.metadata.name},
                "ports": [{"port": COORDINATOR_PORT, "name": "coordinator"}],
            },
            labels={LABEL_JOB: job.metadata.name},
        )
        svc.metadata.owner_references = [owner_ref(job)]
        return svc

    def _desired_pod(
        self, job: Resource, spec: TpuJobSpec, idx: int, incarnation: int
    ) -> Resource:
        name = worker_name(job.metadata.name, idx)
        procs_per_slice = max(1, spec.replicas // spec.num_slices)
        env = dict(spec.env)
        env.update(
            ProcessEnv(
                coordinator=coordinator_address(job),
                num_processes=spec.replicas,
                process_id=idx,
                num_slices=spec.num_slices,
                slice_id=idx // procs_per_slice,
            ).to_env()
        )
        # Job identity, for in-workload status reporting (the Study trial
        # observation contract, launcher.report_observation).
        env["TPUJOB_NAME"] = job.metadata.name
        env["TPUJOB_NAMESPACE"] = job.metadata.namespace
        node_selector = {}
        if spec.topology:
            node_selector["cloud.google.com/gke-tpu-topology"] = spec.topology
        limits = {ACCELERATOR_RESOURCE: spec.tpu_chips_per_worker} \
            if spec.tpu_chips_per_worker else {}
        pod = new_resource(
            "Pod",
            name,
            job.metadata.namespace,
            spec={
                "containers": [
                    {
                        "name": "worker",
                        "image": spec.image,
                        "command": list(spec.command),
                        "args": list(spec.args),
                        "env": [{"name": k, "value": v} for k, v in sorted(env.items())],
                        "resources": {"limits": {**limits, **dict(spec.resources)}},
                    }
                ],
                "nodeSelector": node_selector,
                "restartPolicy": "Never",  # the gang restarts, not the pod
                "subdomain": job.metadata.name,
            },
            labels={
                LABEL_JOB: job.metadata.name,
                LABEL_WORKER: str(idx),
                LABEL_INCARNATION: str(incarnation),
            },
        )
        pod.metadata.owner_references = [owner_ref(job)]
        return pod

    # -- placement --------------------------------------------------------

    def _build_scheduler(self, api: FakeApiServer, placing_job: str):
        """A fresh scheduler from OBSERVED state — current Nodes plus the
        reservations of live pods' nodeName — for one placement
        decision; None when the cluster model has no Nodes."""
        nodes = api.list("Node")
        if not nodes:
            return None
        sched = PyGangScheduler()
        coords: dict[str, list[tuple[int, int]]] = {}
        for n in nodes:
            pool = n.spec.get("pool", "default")
            x, y = n.spec.get("x", 0), n.spec.get("y", 0)
            coords.setdefault(pool, []).append((x, y))
            sched.add_node(n.metadata.name, pool, x=x, y=y, chips=n.spec.get("chips", 4))
        # A pool named by its slice shape ("4x4", "v5e-8x4") is a 2-D
        # torus of those dims when its nodes' coordinates lie in that
        # grid; a pool whose nodes form a 1xN line of more than 2 is a
        # 1xN ring; anything else stays flat.
        for pool, xy in coords.items():
            m = re.fullmatch(r"(?:.*[-_])?(\d+)x(\d+)", pool)
            if m:
                w, h = int(m.group(1)), int(m.group(2))
                if all(0 <= x < w and 0 <= y < h for x, y in xy):
                    sched.set_pool_topology(pool, w, h)
                continue
            xs = sorted(x for x, _ in xy)
            if all(y == 0 for _, y in xy) and xs == list(range(len(xy))) and len(xy) > 2:
                sched.set_pool_topology(pool, len(xy), 1)
        for pod in api.list("Pod"):
            node = pod.spec.get("nodeName")
            if not node or pod.status.get("phase") in ("Succeeded", "Failed"):
                continue
            gang = f"{pod.metadata.namespace}/{pod.metadata.labels.get(LABEL_JOB, '')}"
            if gang == placing_job:
                continue  # the gang being replaced
            sched.reserve(gang, node, container_limits_total(pod, ACCELERATOR_RESOURCE))
        # Pool preference for topology-less gangs: most free first,
        # computed after the reservations.
        self._pools = sorted(coords, key=lambda p: -sched.free_chips(p))
        return sched

    def _place(self, sched, gang_id: str, spec: TpuJobSpec):
        """One gang placement: a topology names its pool exactly; a
        topology-less gang tries every pool, most free first. Raises
        PlacementError when no pool fits."""
        pools = [spec.topology] if spec.topology else self._pools
        last: Exception | None = None
        for pool in pools:
            try:
                result = sched.place_gang(
                    gang_id, pool, spec.replicas, spec.tpu_chips_per_worker
                )
            except PlacementError as e:
                last = e
                continue
            self.gang_placements.inc(backend="python")
            return result
        raise last if last is not None else PlacementError(
            f"no node pools exist to place {gang_id}"
        )

    # -- reconcile --------------------------------------------------------

    def _teardown(self, api: FakeApiServer, pods, ns: str) -> None:
        for p in pods:
            try:
                api.delete("Pod", p.metadata.name, ns)
            except NotFound:
                pass

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            job = api.get(KIND, name, ns)
        except NotFound:
            return Result()  # deleted; pods cascade
        phase = job.status.get("phase")
        if phase in ("Succeeded", "Failed"):
            return Result()
        try:
            spec = TpuJobSpec.from_dict(job.spec)
            unported = spec.unported_fields()
        except Exception as e:
            # Invalid spec is terminal, not transient. Tear down any pods
            # the gang still holds: a Failed gang must not pin devices.
            self._teardown(api, api.list("Pod", ns, label_selector={LABEL_JOB: name}), ns)
            api.record_event(job, "InvalidSpec", str(e), type_="Warning")
            return self._set_phase(api, job, "Failed")
        if unported:
            # A store without the admission hook let it in: refuse, never
            # run it as if the field were absent.
            self._teardown(api, api.list("Pod", ns, label_selector={LABEL_JOB: name}), ns)
            api.record_event(job, "Unsupported", "; ".join(unported), type_="Warning")
            return self._set_phase(api, job, "Failed")

        try:
            api.get("Service", name, ns)
        except NotFound:
            api.create(self._desired_service(job))

        pods = api.list("Pod", ns, label_selector={LABEL_JOB: name})
        by_index = {p.metadata.labels.get(LABEL_WORKER): p for p in pods}

        if not pods:
            # Gang creation: all pods in one pass, placed whenever a
            # cluster node model exists.
            assignment: list[str] | None = None
            gang_id = f"{ns}/{name}"
            sched = self._build_scheduler(api, gang_id)
            if sched is not None:
                try:
                    assignment, ring_cost = self._place(sched, gang_id, spec)
                except PlacementError as e:
                    # One event per stuck episode, not per retry.
                    if job.status.get("reason") != "Unschedulable":
                        api.record_event(job, "Unschedulable", str(e), type_="Warning")
                        fresh = api.get(KIND, name, ns).thaw()
                        fresh.status["reason"] = "Unschedulable"
                        api.update_status(fresh)
                    self._set_phase(api, job, "Pending")
                    return Result(requeue_after=10.0)
                api.record_event(
                    job, "GangPlaced",
                    f"placed on {len(set(assignment))} node(s), ring cost {ring_cost}",
                )
            incarnation = job.status.get("restarts", 0)
            for i in range(spec.replicas):
                pod = self._desired_pod(job, spec, i, incarnation)
                if assignment is not None:
                    pod.spec["nodeName"] = assignment[i]
                api.create(pod)
            api.record_event(job, "GangCreated", f"created {spec.replicas} workers")
            if job.status.get("reason") == "Unschedulable":
                fresh = api.get(KIND, name, ns).thaw()
                fresh.status.pop("reason", None)
                api.update_status(fresh)
            return self._set_phase(api, job, "Pending")

        if len(pods) != spec.replicas or set(by_index) != {
            str(i) for i in range(spec.replicas)
        }:
            # Partial gang (scale change, external delete): all-or-nothing —
            # tear down and let the next pass recreate.
            self._teardown(api, pods, ns)
            api.record_event(
                job, "GangTornDown",
                f"partial gang ({len(pods)}/{spec.replicas}); recreating",
                type_="Warning",
            )
            return self._set_phase(api, job, "Pending")

        phases = [p.status.get("phase", "Pending") for p in pods]
        counts = {
            "active": sum(p in ("Pending", "Running") for p in phases),
            "succeeded": sum(p == "Succeeded" for p in phases),
            "failed": sum(p == "Failed" for p in phases),
        }

        if counts["failed"] > 0:
            restarts = job.status.get("restarts", 0)
            if restarts < spec.max_restarts:
                self._teardown(api, pods, ns)
                self.gang_restarts.inc(job=f"{ns}/{name}")
                api.record_event(
                    job, "GangRestart",
                    f"{counts['failed']} worker(s) failed; restarting gang "
                    f"({restarts + 1}/{spec.max_restarts})",
                    type_="Warning",
                )
                return self._set_phase(api, job, "Restarting", restarts=restarts + 1)
            api.record_event(
                job, "JobFailed",
                f"exceeded maxRestarts={spec.max_restarts}", type_="Warning",
            )
            return self._set_phase(api, job, "Failed")

        if counts["succeeded"] == spec.replicas:
            api.record_event(job, "JobSucceeded", "all workers succeeded")
            return self._set_phase(api, job, "Succeeded")

        if all(p == "Running" for p in phases):
            return self._set_phase(api, job, "Running", counts=counts)

        return self._set_phase(api, job, phase or "Pending", counts=counts)

    def _set_phase(
        self,
        api: FakeApiServer,
        job: Resource,
        phase: str,
        *,
        counts: dict | None = None,
        restarts: int | None = None,
    ) -> Result:
        def write() -> None:
            fresh = api.get(KIND, job.metadata.name, job.metadata.namespace).thaw()
            new_status = dict(fresh.status)
            if counts is not None:
                new_status["replicaStatuses"] = counts
            if restarts is not None:
                new_status["restarts"] = restarts
            if new_status.get("phase") != phase:
                new_status["phase"] = phase
                new_status["conditions"] = list(
                    new_status.get("conditions", [])
                ) + [{"type": phase}]
            if new_status != fresh.status:
                # Only write on real change — an unconditional write
                # would re-trigger our own watch and hot-loop the queue.
                fresh.status = new_status
                api.update_status(fresh)

        retry_on_conflict(write)
        self.jobs_running.set(
            sum(1 for j in api.list(KIND) if j.status.get("phase") == "Running")
        )
        return Result()
