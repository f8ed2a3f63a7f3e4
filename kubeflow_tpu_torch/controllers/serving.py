"""Serving controller: reconciles a ServingDeployment into replica workers.

Counterpart of `kubeflow_tpu/controllers/serving.py`. One CR declares
the fleet (`api/serving.py`); this controller materializes it:

- one owned ``ServingReplica`` object per replica index, the config-push
  channel: the controller writes the rendered per-replica spec (model,
  batching knobs, modelVersion), and replica workers
  (``python -m kubeflow_tpu_torch.serving --apiserver ... --replica
  ...``) watch their own object and react. In-process fleets
  (`LocalReplicaRuntime`) are driven directly through the runtime.
- per-replica readiness and queue stats aggregated into CR status
  (``status.replicas[*]``, ``readyReplicas``).
- ``spec.autoscale``: the fleet's queue depth and the rolling p99 of its
  queue wait give ``status.targetReplicas`` (scale-up at once,
  scale-down held to the window's maximum), and the fleet converges to
  it.
- a ``spec.modelVersion`` bump triggers a drain-based roll, one replica
  at a time and only while the rest of the fleet is ready.

Three departures from the JAX controller, each a fault there:

- A checkpoint-backed replica restores the step the spec's
  ``modelVersion`` names while its directory holds it, and a step past
  it only when that step is gone; such a replica is current
  (`api.serving.version_current`). The JAX replica restores the newest
  step whatever the spec names and the JAX controller wants equality,
  so once training commits past the spec it rolls every replica on
  every reconcile, forever.
- A ``runtime: process`` fleet is reconciled again every
  ``resync_seconds``: a SIGKILLed worker cannot report its own death
  (its object still reads ready), so only a resync finds the dead
  process and respawns it.
- A single-model fleet's status carries ``servedVersions``, the sorted
  versions its ready replicas serve. Once retention evicts the step the
  spec names, replicas started at different times may restore different
  steps, each current by `version_current`; while they differ, a
  ``MixedVersions`` Warning event names the set, recorded once per set
  and deleted when the replicas agree again. The JAX controller has
  neither, so its mixed fleet shows nothing. An in-process fleet rolls
  all its replicas within one reconcile, so a roll shows no mixed set;
  a ``runtime: process`` fleet's workers self-roll each at its own
  heartbeat, so a reconcile between two of them can record the Warning
  during an ordinary roll, until the last worker has rolled.
"""

from __future__ import annotations

import logging
import time

from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    Key,
    Result,
    retry_on_conflict,
)
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound, event_name
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


def default_runtime(metrics: MetricsRegistry | None = None, *, device=None):
    """In-process replica fleet whose factory is the model-server
    binary's `build_servable_from_rspec`: the checkpoint directory's
    newest step in `resnet50()`, or the demo `tiny_resnet` with weights
    from seed 0 when the spec names no directory. Replicas run on CUDA
    unless `device` names another. Replicas as separate processes are
    `ProcessReplicaRuntime`'s; tests inject their own factory."""
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec
    from kubeflow_tpu_torch.serving.replica import LocalReplicaRuntime
    from kubeflow_tpu_torch.serving.router import Router

    return LocalReplicaRuntime(
        Router(metrics),
        lambda rspec: build_servable_from_rspec(rspec, device=device),
        metrics,
    )


class ServingDeploymentController:
    """Reconciler + the runtime that hosts/drives the actual replicas."""

    def __init__(
        self,
        api: FakeApiServer,
        runtime=None,
        metrics: MetricsRegistry | None = None,
        resync_seconds: float = 1.0,
        process_runtime=None,
        clock=None,
    ):
        self.api = api
        metrics = metrics or MetricsRegistry()
        self.runtime = (
            runtime if runtime is not None else default_runtime(metrics)
        )
        # `spec.runtime: process` fleets materialize here instead
        # (`ProcessReplicaRuntime`: real model-server workers). None =
        # such specs degrade to the in-process runtime, so a manager
        # without a facade URL still reconciles everything.
        self.process_runtime = process_runtime
        self.resync_seconds = resync_seconds
        # Observed-latency autoscale signal: a rolling window of
        # per-replica queue-wait samples per deployment. Controller
        # state only (rebuilt from live stats after a restart) — never
        # part of the API contract.
        self._latency_windows: dict[tuple, object] = {}
        # Scale-down stabilization (autoscale.scaleDownStabilizationSeconds):
        # trailing (timestamp, raw target) samples per deployment. The
        # fleet only shrinks to the max target over the window, so a
        # single quiet reconcile can't flap replicas. Injectable clock
        # so tests drive the window deterministically.
        self._clock = clock if clock is not None else time.monotonic
        self._target_history: dict[tuple, object] = {}
        self.ready_replicas = metrics.gauge(
            "serving_ready_replicas",
            "replicas ready to admit traffic",
            ("deployment",),
        )
        self.rolls_total = metrics.counter(
            "serving_rolls_total",
            "drain-based model version rolls completed",
            ("deployment",),
        )
        self.controller = Controller(
            api,
            serving_api.KIND,
            self.reconcile,
            owns=(serving_api.REPLICA_KIND,),
            name="serving-controller",
            metrics=metrics,
        )

    # -- replica materialization ------------------------------------------

    def _ensure_replica_resource(
        self, api, dep: Resource, rname: str, rspec: dict
    ) -> None:
        try:
            existing = api.get(
                serving_api.REPLICA_KIND, rname, dep.metadata.namespace
            )
        except NotFound:
            replica = new_resource(
                serving_api.REPLICA_KIND,
                rname,
                dep.metadata.namespace,
                spec=rspec,
                labels={serving_api.LABEL_DEPLOYMENT: dep.metadata.name},
            )
            replica.metadata.owner_references = [owner_ref(dep)]
            api.create(replica)
            return
        if existing.spec != rspec:
            # Config push: the spec change rides the watch stream to the
            # replica worker (model roll, batching re-tune).
            fresh = existing.thaw()
            fresh.spec = dict(rspec)
            api.update(fresh)

    def _stamp_replica_status(self, api, ns: str, rname: str, stats: dict):
        def write():
            try:
                fresh = api.get(serving_api.REPLICA_KIND, rname, ns).thaw()
            except NotFound:
                return
            new_status = dict(fresh.status)
            new_status.update(
                {
                    "ready": bool(stats.get("ready")),
                    "version": int(stats.get("version") or 0),
                    "queueDepth": int(stats.get("queue_depth") or 0),
                    "inflight": int(stats.get("inflight") or 0),
                    "queueWaitMs": stats.get("queue_wait_ms", 0.0),
                }
            )
            if new_status != fresh.status:
                fresh.status = new_status
                api.update_status(fresh)

        retry_on_conflict(write)

    def _runtimes(self) -> list:
        runtimes = [self.runtime]
        if self.process_runtime is not None:
            runtimes.append(self.process_runtime)
        return runtimes

    def _runtime_for(self, spec) -> object:
        if spec.runtime == "process" and self.process_runtime is not None:
            return self.process_runtime
        return self.runtime

    def _teardown(self, api, ns: str, name: str) -> None:
        for replica in api.list(
            serving_api.REPLICA_KIND,
            ns,
            label_selector={serving_api.LABEL_DEPLOYMENT: name},
        ):
            self._stop_replica(api, ns, replica.metadata.name)
        # The apiserver's owner-reference cascade may have deleted the
        # replica objects with the deployment — the runtime replicas
        # behind them still need stopping. The CR (and its spec.runtime)
        # is already gone, so sweep every runtime.
        prefix = serving_api.replica_name(name, 0)[: -len("0")]
        for runtime in self._runtimes():
            names = getattr(runtime, "names", None)
            if names is None:
                continue
            for rname in list(names()):
                if rname.startswith(prefix):
                    self._stop_replica(api, ns, rname, runtime=runtime)
        self._latency_windows.pop((ns, name), None)
        self._target_history.pop((ns, name), None)

    def _stop_replica(
        self, api, ns: str, rname: str, runtime=None
    ) -> None:
        for rt in [runtime] if runtime is not None else self._runtimes():
            stop = getattr(rt, "stop", None)
            if stop is not None:
                stop(rname)
        try:
            api.delete(serving_api.REPLICA_KIND, rname, ns)
        except NotFound:
            pass

    # -- reconcile --------------------------------------------------------

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            dep = api.get(serving_api.KIND, name, ns)
        except NotFound:
            self._teardown(api, ns, name)
            return Result()
        try:
            spec = serving_api.ServingDeploymentSpec.from_dict(dep.spec)
        except Exception as e:
            # Client-writable spec: a parse failure is terminal, not a
            # crash-loop.
            api.record_event(dep, "InvalidSpec", str(e), type_="Warning")
            return self._update_status(
                api, dep, phase="Failed", reason=str(e)
            )

        rspec = serving_api.replica_spec(spec)
        runtime = self._runtime_for(spec)

        # Catalog admission policy (models[].priority/quotaRate) lives
        # on the router, not in any replica — push it on every
        # reconcile so spec edits (and model removals) take effect
        # without a roll. Runtimes without a router (process fleets
        # report through status) simply don't expose the hook.
        apply_policy = getattr(runtime, "apply_model_policy", None)
        if apply_policy is not None:
            apply_policy(spec.models)

        # Autoscale on the observed fleet signals: queue depth (queued +
        # already executing — both represent demand a bigger fleet would
        # absorb) and the rolling p99 of per-replica queue wait.
        existing = api.list(
            serving_api.REPLICA_KIND,
            ns,
            label_selector={serving_api.LABEL_DEPLOYMENT: name},
        )
        total_depth = 0
        wait_samples = []
        for replica in existing:
            stats = self._runtime_stats(runtime, replica.metadata.name)
            if stats is None:
                stats = replica.status  # process replica self-report
                total_depth += int(stats.get("queueDepth") or 0)
                total_depth += int(stats.get("inflight") or 0)
                wait = stats.get("queueWaitMs")
            else:
                total_depth += int(stats.get("queue_depth") or 0)
                total_depth += int(stats.get("inflight") or 0)
                wait = stats.get("queue_wait_ms")
            if wait:
                wait_samples.append(float(wait))
        if spec.autoscale is not None:
            target = spec.autoscale.target(
                total_depth,
                p99_latency_ms=self._observed_p99(ns, name, wait_samples),
                current_replicas=len(existing),
            )
            target = self._stabilized_target(
                ns, name, target,
                current_replicas=len(existing),
                window_s=spec.autoscale.scale_down_stabilization_s,
            )
        else:
            target = spec.replicas

        desired = [
            serving_api.replica_name(name, i) for i in range(target)
        ]

        # Scale down from the top index so names stay dense; stop drains
        # first (in-flight completes), then the object goes away.
        for replica in existing:
            if replica.metadata.name not in desired:
                self._stop_replica(api, ns, replica.metadata.name)
                api.record_event(
                    dep, "ScaledDown",
                    f"stopped replica {replica.metadata.name}",
                )

        for rname in desired:
            self._ensure_replica_resource(api, dep, rname, rspec)
            ensure = getattr(runtime, "ensure", None)
            if ensure is not None:
                ensure(rname, rspec)

        # Drain-based checkpoint roll, one replica at a time, and only
        # while EVERY other replica is ready — the fleet keeps admitting
        # during the whole roll (zero downtime). Process replicas have
        # no runtime roll surface: their workers self-roll on the config
        # push above. Multiplexed fleets roll per model: only replicas
        # holding a RESIDENT copy of an outdated model drain (non-
        # resident copies pick up the new version on their next page-in
        # for free).
        if spec.model_version > 0 or any(
            m.model_version > 0 for m in spec.models
        ):
            self._roll_outdated(api, dep, spec, desired, rspec, runtime)

        # Status: per-replica readiness (stamped onto the replica objects
        # too — the kubectl surface) aggregated onto the deployment.
        # Multiplexed fleets additionally aggregate per-model rows
        # (resident replica count, max live version, page-in totals)
        # so `kubectl get` answers "is model X up" per model.
        models_agg: dict[str, dict] = {
            m.name: {
                "name": m.name,
                "residentReplicas": 0,
                "version": 0,
                "pageIns": 0,
            }
            for m in spec.models
        }
        rows = []
        ready_count = 0
        for rname in desired:
            stats = self._runtime_stats(runtime, rname)
            if stats is not None:
                self._stamp_replica_status(api, ns, rname, stats)
                row = {
                    "name": rname,
                    "ready": bool(stats.get("ready")),
                    "version": int(stats.get("version") or 0),
                    "queueDepth": int(stats.get("queue_depth") or 0),
                    "inflight": int(stats.get("inflight") or 0),
                }
                model_rows = stats.get("models")
                if model_rows:
                    row["resident"] = int(stats.get("resident") or 0)
                    for mname, mrow in model_rows.items():
                        slot = models_agg.get(mname)
                        if slot is None:
                            continue
                        slot["pageIns"] += int(mrow.get("page_ins") or 0)
                        if mrow.get("state") == "resident":
                            slot["residentReplicas"] += 1
                            slot["version"] = max(
                                slot["version"],
                                int(mrow.get("version") or 0),
                            )
            else:
                # Process replica: its worker stamps the replica object;
                # we read it back.
                try:
                    robj = api.get(serving_api.REPLICA_KIND, rname, ns)
                    status = robj.status
                except NotFound:
                    status = {}
                row = {
                    "name": rname,
                    "ready": bool(status.get("ready")),
                    "version": int(status.get("version") or 0),
                    "queueDepth": int(status.get("queueDepth") or 0),
                    "inflight": int(status.get("inflight") or 0),
                }
            if row["ready"]:
                ready_count += 1
            rows.append(row)

        self.ready_replicas.set(ready_count, deployment=name)
        phase = "Available" if ready_count >= target else "Progressing"
        if ready_count == 0 and target > 0 and existing:
            phase = "Degraded"
        result = self._update_status(
            api, dep,
            phase=phase,
            replicas=rows,
            ready=ready_count,
            target=target,
            queue_depth=total_depth,
            models=list(models_agg.values()) if spec.models else None,
            served=None if spec.models else sorted(
                {row["version"] for row in rows if row["ready"]}),
        )
        if (
            spec.autoscale is not None
            or ready_count < target
            or runtime is self.process_runtime
        ):
            return Result(requeue_after=self.resync_seconds)
        return result

    def _runtime_stats(self, runtime, rname: str) -> dict | None:
        stats_fn = getattr(runtime, "stats", None)
        if stats_fn is None:
            return None
        return stats_fn(rname)

    def _observed_p99(
        self, ns: str, name: str, samples: list
    ) -> float | None:
        """Rolling p99 queue wait across recent reconciles — the
        latency half of the autoscale signal. None until a sample
        exists (a cold fleet must not scale on latency it never
        measured)."""
        import collections

        window = self._latency_windows.setdefault(
            (ns, name), collections.deque(maxlen=200)
        )
        window.extend(samples)
        if not window:
            return None
        ordered = sorted(window)
        return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]

    def _stabilized_target(
        self, ns: str, name: str, raw: int, *,
        current_replicas: int, window_s: float,
    ) -> int:
        """Damp scale-down through the stabilization window (HPA's
        stabilizationWindowSeconds rule): record the raw target every
        reconcile, and when the proposal would shrink the fleet, act on
        the MAX over the trailing window instead — a burst that paused
        for one reconcile still holds the fleet at burst size. Scale-up
        passes through untouched (latency breaches must never wait)."""
        if window_s <= 0:
            return raw
        now = self._clock()
        history = self._target_history.setdefault((ns, name), [])
        history.append((now, raw))
        while history and history[0][0] < now - window_s:
            history.pop(0)
        if raw >= current_replicas:
            return raw
        return max(raw, *(t for _, t in history))

    def _replica_outdated(self, spec, stats: dict) -> list[str]:
        """Which of the replica's models need a drain-based roll.

        Single-model: the replica's live version vs spec.modelVersion.
        Multiplexed: only models the replica holds RESIDENT at a stale
        version count — a paged-out model carries no device state, so
        its next page-in loads the desired version without costing the
        fleet a drain. Stale by `serving_api.version_current`."""
        if spec.models:
            rows = stats.get("models") or {}
            stale = []
            for m in spec.models:
                if m.model_version <= 0:
                    continue
                row = rows.get(m.name)
                if (
                    row is not None
                    and row.get("state") == "resident"
                    and not serving_api.version_current(
                        int(row.get("version") or 0), m.model_version,
                        m.checkpoint_dir,
                    )
                ):
                    stale.append(m.name)
            return stale
        if not serving_api.version_current(
            int(stats.get("version") or 0), spec.model_version,
            spec.checkpoint_dir,
        ):
            return [spec.model]
        return []

    def _roll_outdated(
        self, api, dep: Resource, spec, desired: list[str], rspec: dict,
        runtime,
    ) -> None:
        roll = getattr(runtime, "roll", None)
        if roll is None:
            return
        for rname in desired:
            stats = self._runtime_stats(runtime, rname)
            if stats is None:
                continue
            stale = self._replica_outdated(spec, stats)
            if not stale:
                continue
            others_ready = all(
                (self._runtime_stats(runtime, o) or {}).get("ready")
                for o in desired
                if o != rname
            )
            if not others_ready and len(desired) > 1:
                # Never take a second replica out while one is already
                # down — that is how a roll becomes an outage.
                return
            seconds = roll(rname, rspec)
            self.rolls_total.inc(deployment=dep.metadata.name)
            if spec.models:
                wanted = {m.name: m.model_version for m in spec.models}
                detail = ", ".join(
                    f"{n} -> version {wanted[n]}" for n in stale
                )
            else:
                detail = f"-> version {spec.model_version}"
            api.record_event(
                dep, "ReplicaRolled",
                f"{rname} {detail} ({seconds:.3f}s out of rotation)",
            )

    # -- status -----------------------------------------------------------

    def _update_status(
        self,
        api,
        dep: Resource,
        *,
        phase: str,
        replicas=None,
        ready: int | None = None,
        target: int | None = None,
        queue_depth: int | None = None,
        reason: str | None = None,
        models=None,
        served: list[int] | None = None,
    ) -> Result:
        before = []

        def write():
            try:
                fresh = api.get(
                    serving_api.KIND,
                    dep.metadata.name,
                    dep.metadata.namespace,
                ).thaw()
            except NotFound:
                return
            new_status = dict(fresh.status)
            new_status["phase"] = phase
            if replicas is not None:
                new_status["replicas"] = replicas
            if ready is not None:
                new_status["readyReplicas"] = ready
            if target is not None:
                new_status["targetReplicas"] = target
            if queue_depth is not None:
                new_status["queueDepth"] = queue_depth
            if models is not None:
                new_status["models"] = models
            if reason is not None:
                new_status["reason"] = reason
            if served is not None:
                new_status["servedVersions"] = served
            before[:] = fresh.status.get("servedVersions") or []
            if new_status != fresh.status:
                fresh.status = new_status
                api.update_status(fresh)

        retry_on_conflict(write)
        if served is not None and served != before:
            self._mixed_versions_event(api, dep, before, served)
        return Result()

    @staticmethod
    def _mixed_versions_event(api, dep: Resource, before: list, served: list) -> None:
        """The Warning that the ready replicas serve more than one
        version: recorded when such a set first appears, deleted when it
        gives way to another set (recorded in turn if it is mixed too)."""
        def message(versions):
            return f"ready replicas serve versions {versions}"

        if len(before) > 1:
            try:
                api.delete("Event", event_name(dep, "MixedVersions", message(before),
                                               "Warning"), dep.metadata.namespace)
            except NotFound:
                pass
        if len(served) > 1:
            api.record_event(dep, "MixedVersions", message(served), type_="Warning")
