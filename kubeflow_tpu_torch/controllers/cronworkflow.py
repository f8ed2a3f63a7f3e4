"""CronWorkflow controller: materialize Workflows on schedule.

The Prow-periodic / Argo-CronWorkflow analog (the reference's CI ran on
Prow periodics submitting Argo workflows, `testing/README.md:22-35`).
Level-triggered like every controller here: each reconcile computes the
next fire time from the schedule and `status.lastScheduleTime`, spawns a
Workflow when due (honoring suspend + concurrencyPolicy), GCs finished
runs beyond historyLimit, and requeues for the next tick.

Missed ticks policy: at most ONE catch-up run per reconcile — a
controller that was down for a day must not burst 1440 backfilled
workflows (Argo's startingDeadlineSeconds defaults to skipping, Prow
periodics simply fire on the next period).

Counterpart of `kubeflow_tpu/controllers/cronworkflow.py` (a module with
no JAX in it), whole, on the port's API objects and store. `now` is
injectable for the tests; the binary runs on the wall clock, so the
first run fires at the first schedule minute after the anchor. Spawned
Workflows are owned by their CronWorkflow: deleting it removes them,
and their step pods and TpuJobs, through the store's owner cascade.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from kubeflow_tpu_torch.api import cron as cron_api
from kubeflow_tpu_torch.api import workflow as wf_api
from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

LABEL_CRON = "kubeflow-tpu.org/cron-workflow"

TERMINAL = ("Succeeded", "Failed")


class CronWorkflowController:
    def __init__(
        self,
        api: FakeApiServer,
        metrics: MetricsRegistry | None = None,
        now: Callable[[], float] = time.time,
    ):
        self.api = api
        self._now = now
        metrics = metrics or MetricsRegistry()
        self.spawned_total = metrics.counter(
            "cronworkflow_spawned_total", "workflows materialized",
            ("cron",),
        )
        self.controller = Controller(
            api,
            cron_api.KIND,
            self.reconcile,
            owns=(wf_api.KIND,),
            name="cronworkflow-controller",
            metrics=metrics,
        )

    def _spawn(
        self, cw: Resource, spec: cron_api.CronWorkflowSpec, fire_time: float
    ) -> None:
        name = f"{cw.metadata.name}-{int(fire_time)}"
        wf = new_resource(
            wf_api.KIND,
            name,
            cw.metadata.namespace,
            spec=dict(spec.workflow_spec),
            labels={LABEL_CRON: cw.metadata.name},
        )
        wf.metadata.owner_references = [owner_ref(cw)]
        from kubeflow_tpu_torch.testing.fake_apiserver import AlreadyExists

        try:
            self.api.create(wf)
        except AlreadyExists:
            # Crash between create and the lastScheduleTime status write:
            # the re-reconcile recomputes the same run name — adopt it.
            return
        self.spawned_total.inc(cron=cw.metadata.name)
        self.api.record_event(
            cw, "WorkflowSpawned", f"scheduled run {name}"
        )

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            cw = api.get(cron_api.KIND, name, ns)
        except NotFound:
            return Result()
        if cw.metadata.deletion_timestamp is not None:
            return Result()
        try:
            spec = cron_api.CronWorkflowSpec.from_dict(cw.spec)
            schedule = cron_api.CronSchedule.parse(spec.schedule)
            # Satisfiability probe: a field-valid schedule that never
            # fires (e.g. '0 0 31 2 *') must be a terminal InvalidSpec,
            # not a next_after ValueError crash-looping in backoff.
            schedule.next_after(self._now())
        except Exception as e:
            api.record_event(cw, "InvalidSpec", str(e), type_="Warning")
            return self._set_status(api, cw, error=str(e))

        spawned = api.list(
            wf_api.KIND, ns, label_selector={LABEL_CRON: name}
        )
        running = [
            w for w in spawned if w.status.get("phase") not in TERMINAL
        ]

        # GC: oldest finished runs beyond the history limit.
        finished = sorted(
            (w for w in spawned if w.status.get("phase") in TERMINAL),
            key=lambda w: w.metadata.creation_timestamp or 0,
        )
        for old in finished[: max(0, len(finished) - spec.history_limit)]:
            try:
                api.delete(wf_api.KIND, old.metadata.name, ns)
            except NotFound:
                pass

        now = self._now()
        last = cw.status.get("lastScheduleTime")
        if last is None:
            # First reconcile: anchor at now — fire on the NEXT matching
            # minute, not on every historic one.
            return self._set_status(
                api, cw, last_schedule=now,
                requeue=schedule.next_after(now) - now,
            )

        due = schedule.next_after(last)
        if spec.suspend or due > now:
            return self._set_status(
                api, cw,
                requeue=max(1.0, (due - now)) if not spec.suspend else 60.0,
            )

        # A tick is due. One catch-up max: anchor the new lastScheduleTime
        # at the MOST RECENT missed tick, not the oldest.
        fire = due
        while True:
            nxt = schedule.next_after(fire)
            if nxt > now:
                break
            fire = nxt

        if running and spec.concurrency_policy == "Forbid":
            api.record_event(
                cw, "RunSkipped",
                f"previous run still active ({running[0].metadata.name})",
            )
        else:
            if running and spec.concurrency_policy == "Replace":
                for w in running:
                    try:
                        api.delete(wf_api.KIND, w.metadata.name, ns)
                    except NotFound:
                        pass
            self._spawn(cw, spec, fire)
        return self._set_status(
            api, cw, last_schedule=fire,
            requeue=max(1.0, schedule.next_after(fire) - now),
        )

    def _set_status(
        self,
        api: FakeApiServer,
        cw: Resource,
        *,
        last_schedule: float | None = None,
        error: str | None = None,
        requeue: float | None = None,
    ) -> Result:
        fresh = api.get(
            cron_api.KIND, cw.metadata.name, cw.metadata.namespace
        ).thaw()
        new_status = dict(fresh.status)
        if last_schedule is not None:
            new_status["lastScheduleTime"] = last_schedule
        if error is not None:
            new_status["error"] = error
        else:
            new_status.pop("error", None)
        if new_status != fresh.status:
            fresh.status = new_status
            api.update_status(fresh)
        return Result(requeue_after=requeue)
