"""TpuJob operator: gang-scheduled training jobs.

Counterpart of `kubeflow_tpu/controllers/tpujob.py` (a module with no
JAX in it), on the port's API objects and store. It creates one pod per
worker, injects the coordination env and supervises the gang:

- **all-or-nothing gangs**: if the pod set is ever partial, the whole
  gang is torn down and re-created;
- **whole-gang restart on any failure**, bounded by spec.maxRestarts,
  counted in status.restarts; each gang's pods carry its incarnation
  (the restart count at creation) as a label;
- **placement** through the compiled gang scheduler
  (`native/scheduler.make_gang_scheduler`, or the `scheduler_factory`
  a caller names, as JAX's ``scheduler=``) whenever Node objects exist:
  a topology names its pool, a topology-less gang tries every pool,
  most free accelerators first; ``tpujob_gang_placements_total`` counts
  each placement by ``backend`` (``native``, ``python`` for the twin
  `PyGangScheduler`, ``custom``);
- **priority preemption** at gang granularity (`_preempt_for`): a gang
  that cannot place evicts gangs of strictly lower priority holding
  accelerators in its pool, lowest priority and youngest first, and only
  when a what-if placement without their reservations succeeds; the
  victims go back to Pending (``reason: Preempted``, then
  ``PreemptedBackoff`` for 3 s so the preemptor claims the freed
  accelerators first) with their restart budget untouched;
- **quota episodes**: a worker refused by admission (ResourceQuota,
  `controllers/quota.py`) tears down the partial gang and holds the job
  Pending with ``reason: QuotaExceeded`` and one Warning, retried after
  `quota_retry_seconds`, never a crash loop;
- the headless Service that gives every worker a stable DNS name.

The accelerator translation, the one difference from the JAX operator's
pods: a worker asks ``nvidia.com/gpu: <tpu.chipsPerWorker>`` where JAX's
asks ``google.com/tpu``, and carries no libtpu slice-assembly env
(TPU_WORKER_ID, TPU_WORKER_HOSTNAMES). Every TPUJOB_* variable and
TPUJOB_NAME/TPUJOB_NAMESPACE are the same. The scheduler reserves by the
resource the pod asks for.

Not ported yet (ROADMAP Queue 1 item 12, beside `Trainer.resize`):
elastic gang resize, the JAX operator's shrink offer before an eviction
and its grow-back. A spec that asks for it (`elasticMinReplicas > 0`) is
refused by the admission hook (`register_admission`) and, if it reached
the store without it, failed by reconcile with an ``Unsupported`` event;
it is never run as if the field were absent.

`preempt_stall`, when set, is called after a preemption's evictions have
committed and before the preemptor is placed: the widest window for a
leader to die in, which the HA tests and chip_smoke's preempt phase
widen (`testing/workers/preempt_ha.py`); the binary never sets it.

Job phases: Pending → Running → Succeeded | Failed (with Restarting
transitions in between).
"""

from __future__ import annotations

import re
import time

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
from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    Key,
    Result,
    retry_on_conflict,
)
from kubeflow_tpu_torch.native.core import backend_of
from kubeflow_tpu_torch.native.scheduler import PlacementError, make_gang_scheduler
from kubeflow_tpu_torch.parallel.distributed import ProcessEnv
from kubeflow_tpu_torch.testing.fake_apiserver import (
    Conflict,
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


# The reasons of a Pending episode that a placement or a gang creation ends.
EPISODE_REASONS = ("Unschedulable", "Preempted", "PreemptedBackoff", "QuotaExceeded")
# How long a freshly evicted gang holds back before it competes again.
PREEMPTED_BACKOFF_S = 3.0


class TpuJobController:
    def __init__(
        self,
        api: FakeApiServer,
        metrics: MetricsRegistry | None = None,
        quota_retry_seconds: float = 10.0,
        preempt_stall=None,
        scheduler_factory=None,
    ):
        self.api = api
        self._scheduler_factory = scheduler_factory
        self._pools: list[str] = []
        self._quota_retry_seconds = quota_retry_seconds
        self._preempt_stall = preempt_stall
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

    def _build_scheduler(
        self, api: FakeApiServer, placing_job: str, exclude: frozenset[str] = frozenset()
    ):
        """A fresh scheduler from OBSERVED state — current Nodes plus the
        reservations of live pods' nodeName — for one placement
        decision; None when the cluster model has no Nodes. `exclude`
        drops more gangs' reservations (``ns/name``): the what-if of a
        preemption that evicts them."""
        nodes = api.list("Node")
        if not nodes:
            return None
        sched = (self._scheduler_factory() if self._scheduler_factory is not None
                 else make_gang_scheduler())
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
            if gang == placing_job or gang in exclude:
                continue  # the gang being replaced, or hypothetically evicted
            sched.reserve(gang, node, container_limits_total(pod, ACCELERATOR_RESOURCE))
        # Pool preference for topology-less gangs: most free first,
        # computed after the reservations.
        self._pools = sorted(coords, key=lambda p: -sched.free_chips(p))
        return sched

    def _place(self, sched, gang_id: str, spec: TpuJobSpec, *, count: bool = True):
        """One gang placement: a topology names its pool exactly; a
        topology-less gang tries every pool, most free first. Raises
        PlacementError when no pool fits. A what-if (`count=False`) is
        not counted in tpujob_gang_placements_total."""
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
            if count:
                self.gang_placements.inc(backend=backend_of(sched))
            return result
        raise last if last is not None else PlacementError(
            f"no node pools exist to place {gang_id}"
        )

    # -- preemption -------------------------------------------------------

    def _preempt_for(self, api: FakeApiServer, job: Resource, spec: TpuJobSpec) -> bool:
        """Evict lower-priority gangs so `job` can place; True if any was
        evicted (the caller requeues and places again).

        The kube-scheduler's rules at gang granularity: only gangs of
        STRICTLY lower priority that hold accelerators on a node of the
        preemptor's pool qualify; the lowest priority goes first, and the
        youngest first within a priority; and no gang is touched unless a
        what-if placement without the chosen gangs' reservations
        succeeds (freed accelerators spread over nodes can still leave
        the preemptor unplaceable, and evicting for that is pure
        disruption). Victims go back to Pending with their restart budget
        intact."""
        if spec.replicas * spec.tpu_chips_per_worker <= 0:
            return False

        # One pod scan: each gang's held accelerators and nodes.
        held_by_gang: dict[str, int] = {}
        nodes_by_gang: dict[str, set[str]] = {}
        for pod in api.list("Pod"):
            node = pod.spec.get("nodeName")
            if not node or pod.status.get("phase") in ("Succeeded", "Failed"):
                continue
            gang = f"{pod.metadata.namespace}/{pod.metadata.labels.get(LABEL_JOB, '')}"
            held_by_gang[gang] = held_by_gang.get(gang, 0) + container_limits_total(
                pod, ACCELERATOR_RESOURCE)
            nodes_by_gang.setdefault(gang, set()).add(node)

        # Victims are scoped by where their accelerators are, not by their
        # spec's topology string: any gang on a node of the pool can block it.
        pool_nodes = {
            n.metadata.name for n in api.list("Node")
            if not spec.topology or n.spec.get("pool", "default") == spec.topology
        }
        candidates = []
        for other in api.list(KIND):
            if (other.metadata.uid == job.metadata.uid
                    or other.status.get("phase") in ("Succeeded", "Failed")):
                continue
            try:
                other_spec = TpuJobSpec.from_dict(other.spec)
            except Exception:
                continue
            if other_spec.priority >= spec.priority:
                continue
            gang = f"{other.metadata.namespace}/{other.metadata.name}"
            if held_by_gang.get(gang, 0) > 0 and nodes_by_gang.get(gang, set()) & pool_nodes:
                candidates.append((other_spec.priority, other, gang))
        # Lowest priority first; youngest first within a priority.
        candidates.sort(key=lambda c: (c[0], -(c[1].metadata.creation_timestamp or 0)))
        gang_id = f"{job.metadata.namespace}/{job.metadata.name}"

        # Grow the victim set until the gang places on a what-if scheduler
        # without their reservations.
        victims: list[tuple[Resource, str]] = []
        excluded: set[str] = set()
        for _, victim, gang in candidates:
            victims.append((victim, gang))
            excluded.add(gang)
            trial = self._build_scheduler(api, gang_id, exclude=frozenset(excluded))
            if trial is None:
                return False
            try:
                self._place(trial, gang_id, spec, count=False)
                break
            except PlacementError:
                continue
        else:
            return False  # even evicting every lower gang would not place it

        for victim, _ in victims:
            vns = victim.metadata.namespace
            for pod in api.list("Pod", vns, label_selector={LABEL_JOB: victim.metadata.name}):
                try:
                    api.delete("Pod", pod.metadata.name, vns)
                except NotFound:
                    pass
            api.record_event(
                victim, "Preempted",
                f"evicted by higher-priority gang {gang_id} (priority {spec.priority})",
                type_="Warning")
            # A victim deleted meanwhile is simply a freed one.
            for _ in range(3):
                try:
                    fresh = api.get(KIND, victim.metadata.name, vns).thaw()
                except NotFound:
                    break
                fresh.status["phase"] = "Pending"
                fresh.status["reason"] = "Preempted"
                try:
                    api.update_status(fresh)
                    break
                except Conflict:
                    continue
        # The message names the victims (JAX's gives only their count).
        api.record_event(
            job, "PreemptedLowerPriority",
            f"evicted {len(victims)} gang(s) "
            f"({sum(held_by_gang.get(g, 0) for g in excluded)} chips): "
            f"{', '.join(gang for _, gang in victims)}")
        if self._preempt_stall is not None:
            self._preempt_stall()  # evicted, the preemptor not yet placed
        return True

    def _set_reason(self, api: FakeApiServer, job: Resource, **fields) -> None:
        """Write status fields (None drops one) on a fresh read of the job."""
        fresh = api.get(KIND, job.metadata.name, job.metadata.namespace).thaw()
        for key, value in fields.items():
            if value is None:
                fresh.status.pop(key, None)
            else:
                fresh.status[key] = value
        api.update_status(fresh)

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
            reason = job.status.get("reason")
            if reason == "Preempted":
                # Freshly evicted: hold back so the preemptor gets first
                # claim on the accelerators it freed. Deadline-based: the
                # status write re-triggers this reconcile at once.
                self._set_reason(api, job, reason="PreemptedBackoff",
                                 preemptedUntil=time.time() + PREEMPTED_BACKOFF_S)
                return Result(requeue_after=PREEMPTED_BACKOFF_S)
            if reason in ("PreemptedBackoff", "QuotaExceeded"):
                # Time-gated: a quota retry creates and deletes a pod, whose
                # events re-enqueue this job; ungated, that is a hot loop.
                until = "preemptedUntil" if reason == "PreemptedBackoff" else "quotaRetryAt"
                remaining = job.status.get(until, 0) - time.time()
                if remaining > 0:
                    return Result(requeue_after=remaining)
            # Gang creation: all pods in one pass, placed whenever a
            # cluster node model exists.
            assignment: list[str] | None = None
            gang_id = f"{ns}/{name}"
            sched = self._build_scheduler(api, gang_id)
            if sched is not None:
                try:
                    assignment, ring_cost = self._place(sched, gang_id, spec)
                except PlacementError as e:
                    if self._preempt_for(api, job, spec):
                        return Result(requeue_after=0.5)
                    # One event per stuck episode, not per retry.
                    if job.status.get("reason") != "Unschedulable":
                        api.record_event(job, "Unschedulable", str(e), type_="Warning")
                        self._set_reason(api, job, reason="Unschedulable")
                    self._set_phase(api, job, "Pending")
                    return Result(requeue_after=10.0)
                api.record_event(
                    job, "GangPlaced",
                    f"placed on {len(set(assignment))} node(s), ring cost {ring_cost}",
                )
                if job.status.get("reason") in EPISODE_REASONS:
                    self._set_reason(api, job, reason=None, preemptedUntil=None)
            incarnation = job.status.get("restarts", 0)
            created = []
            try:
                for i in range(spec.replicas):
                    pod = self._desired_pod(job, spec, i, incarnation)
                    if assignment is not None:
                        pod.spec["nodeName"] = assignment[i]
                    api.create(pod)
                    created.append(pod)
            except Invalid as e:
                # Admission (quota) refused a worker: the gang is
                # all-or-nothing, so nothing starts. Tear down the partial
                # set and hold a Pending episode instead of crash-looping.
                self._teardown(api, created, ns)
                if job.status.get("reason") != "QuotaExceeded":
                    api.record_event(job, "QuotaExceeded", str(e), type_="Warning")
                self._set_reason(api, job, reason="QuotaExceeded",
                                 quotaRetryAt=time.time() + self._quota_retry_seconds)
                self._set_phase(api, job, "Pending")
                return Result(requeue_after=self._quota_retry_seconds)
            api.record_event(job, "GangCreated", f"created {spec.replicas} workers")
            if job.status.get("reason") in EPISODE_REASONS:
                # Episode over (also where no scheduler placed the gang).
                self._set_reason(api, job, reason=None, preemptedUntil=None,
                                 quotaRetryAt=None)
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
