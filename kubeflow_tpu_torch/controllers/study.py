"""Study controller: materializes hyperparameter-search trials as TpuJobs.

Counterpart of `kubeflow_tpu/controllers/study.py` (a module with no JAX
in it), whole, on the port's API objects and store:

- up to `spec.parallelism` trials in flight; new trials are created as
  running ones finish, until the budget (`max_trials`, or grid
  exhaustion) is spent;
- each trial is a `TpuJob` rendered from `spec.trialTemplate` with
  `${trialParameters.*}` substituted, so trials inherit the operator's
  gang scheduling and whole-gang restarts;
- a trial's objective is read from the TpuJob's `status.observation`
  (written by the launcher's `report_observation` at job end);
- suggestion state lives entirely in the API objects: random/grid
  assignments are deterministic in (spec, trial index), and bayesian
  TPE and successive halving re-derive their state each reconcile from
  the trials' parameter annotations and the `status.maxTrialIndex`
  high-water mark, so a restarted controller picks up where it left off;
- early stopping prunes a running trial whose `status.metrics` curve
  (`report_metrics`) is worse than every peer's at its step;
- terminal: Succeeded with `status.bestTrial` once all trials finish,
  Failed when failed trials exceed `maxFailedTrials`.
"""

from __future__ import annotations

import json
import logging
import math

from kubeflow_tpu_torch.api import study as study_api
from kubeflow_tpu_torch.api import tpujob as tpujob_api
from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

LABEL_STUDY = "kubeflow-tpu.org/study"
LABEL_TRIAL = "kubeflow-tpu.org/trial-index"
# The raw parameter assignment, JSON — the durable sampler state that
# history-aware algorithms (bayesian TPE, successive halving) read back
# instead of persisting suggester state anywhere.
ANNOTATION_PARAMS = "kubeflow-tpu.org/parameters"

TRIAL_TERMINAL = ("Succeeded", "Failed")


def trial_name(study: str, index: int) -> str:
    return f"{study}-trial-{index}"


def _int_or(value, default: int) -> int:
    """Status is client-writable through the HTTP facade — a bogus
    maxTrialIndex must degrade to the positional fallback, not crash."""
    if isinstance(value, bool) or not isinstance(value, int):
        return default
    return value


def _numeric(value) -> float | None:
    """Observation values are client-writable through the HTTP facade —
    anything non-numeric (including bool) is treated as absent rather
    than crashing or polluting the ranking."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return value


def _trial_assignment(trial: Resource) -> dict:
    raw = trial.metadata.annotations.get(ANNOTATION_PARAMS)
    # Client-writable: anything but a JSON-object string is treated as
    # absent (including non-string values, which json.loads would raise
    # TypeError on).
    if not raw or not isinstance(raw, str):
        return {}
    try:
        parsed = json.loads(raw)
    except ValueError:
        return {}
    return parsed if isinstance(parsed, dict) else {}


class StudyController:
    def __init__(self, api: FakeApiServer, metrics: MetricsRegistry | None = None):
        self.api = api
        metrics = metrics or MetricsRegistry()
        self.trials_total = metrics.counter(
            "study_trials_total", "trials created", ("study",)
        )
        self.studies_running = metrics.gauge(
            "study_running", "Studies currently running"
        )
        self.controller = Controller(
            api,
            study_api.KIND,
            self.reconcile,
            owns=(tpujob_api.KIND,),
            name="study-controller",
            metrics=metrics,
        )

    # -- trial materialization -------------------------------------------

    def _create_trial(
        self,
        study: Resource,
        spec: study_api.StudySpec,
        index: int,
        assignment: dict,
    ) -> None:
        job_spec = study_api.render_template(
            dict(spec.trial_template), assignment
        )
        job = new_resource(
            tpujob_api.KIND,
            trial_name(study.metadata.name, index),
            study.metadata.namespace,
            spec=job_spec,
            labels={
                LABEL_STUDY: study.metadata.name,
                LABEL_TRIAL: str(index),
            },
            annotations={ANNOTATION_PARAMS: json.dumps(assignment)},
        )
        job.metadata.owner_references = [owner_ref(study)]
        self.api.create(job)
        self.trials_total.inc(study=study.metadata.name)

    # -- reconcile -------------------------------------------------------

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            study = api.get(study_api.KIND, name, ns)
        except NotFound:
            return Result()
        if study.status.get("phase") in ("Succeeded", "Failed"):
            return Result()
        try:
            spec = study_api.StudySpec.from_dict(study.spec)
        except Exception as e:
            # Client-writable spec: any parse failure is terminal, not a
            # crash-loop.
            api.record_event(study, "InvalidSpec", str(e), type_="Warning")
            return self._finish(api, study, "Failed", reason=str(e))

        trials = api.list(
            tpujob_api.KIND, ns, label_selector={LABEL_STUDY: name}
        )
        by_index = {
            int(t.metadata.labels[LABEL_TRIAL]): t
            for t in trials
            if t.metadata.labels.get(LABEL_TRIAL, "").isdigit()
        }

        # Pruned trials persist in status only — their CRs are deleted, so
        # status is the single witness (the workflow controller's
        # failedAttempts pattern).
        pruned: dict[str, dict] = dict(study.status.get("prunedTrials") or {})

        # Harvest: every terminal trial contributes a status row and a
        # TrialRecord (the suggester's view); succeeded trials with an
        # observation compete for best.
        rows = []
        records = []
        best = None
        curves: dict[int, list[tuple[int, float]]] = {}
        active = failed = succeeded = 0
        for idx in sorted(by_index):
            trial = by_index[idx]
            phase = trial.status.get("phase", "Pending")
            row = {
                "name": trial.metadata.name,
                "index": idx,
                "state": phase,
            }
            observation = trial.status.get("observation") or {}
            value = observation.get(spec.objective_metric)
            if value is not None:
                row["objective"] = value
            records.append(
                study_api.TrialRecord(
                    index=idx,
                    state=phase,
                    assignment=_trial_assignment(trial),
                    objective=_numeric(value),
                )
            )
            if phase == "Succeeded":
                succeeded += 1
                # NaN (diverged trial) must never win — every NaN
                # comparison is False, so once seated it could not be
                # displaced either.
                # isinstance first: observation is client-writable through
                # the HTTP facade, so a non-numeric value must not crash
                # the reconcile loop.
                if isinstance(value, (int, float)) and math.isfinite(value):
                    better = (
                        best is None
                        or (spec.goal == "minimize" and value < best["objective"])
                        or (spec.goal == "maximize" and value > best["objective"])
                    )
                    if better:
                        best = row
            elif phase == "Failed":
                failed += 1
            else:
                active += 1
            # Metric curve (launcher.report_metrics): (step, value)
            # ascending, for the early-stopping pass below.
            curve = []
            for point in trial.status.get("metrics") or []:
                v = _numeric(point.get(spec.objective_metric))
                step_n = point.get("step")
                if v is not None and isinstance(step_n, int):
                    curve.append((step_n, v))
            if curve:
                curves[idx] = sorted(curve)
            rows.append(row)

        # Early stopping: prune running trials whose learning curve is
        # worse than the median of their peers at the same step (katib's
        # median-stop; the reference only asserted StudyJob liveness,
        # `katib_studyjob_test.py:115-120`). The pruned trial's CR is
        # deleted (its gang frees the slice NOW — idle TPUs are the cost
        # center) and its last value is recorded as its score.
        if spec.prunes:
            for idx in sorted(curves):
                trial = by_index[idx]
                if trial.status.get("phase") in TRIAL_TERMINAL:
                    continue
                peer_curves = [
                    c for i, c in curves.items() if i != idx
                ] + [
                    [(int(e["step"]), float(e["objective"]))]
                    for e in pruned.values()
                ]
                if not spec.should_prune(curves[idx], peer_curves):
                    continue
                step_n, value = curves[idx][-1]
                pruned[str(idx)] = {
                    "objective": value,
                    "step": step_n,
                    "assignment": _trial_assignment(trial),
                    "name": trial.metadata.name,
                }
                api.record_event(
                    study, "TrialPruned",
                    f"trial {idx} pruned at step {step_n} "
                    f"({spec.objective_metric}={value:g} worse than "
                    "peer median)",
                )
                try:
                    api.delete(tpujob_api.KIND, trial.metadata.name, ns)
                except NotFound:
                    pass
                active -= 1
                # Replace this trial's live row/record with the pruned view
                # below (fall through to the merge).
                rows = [r for r in rows if r["index"] != idx]
                records = [r for r in records if r.index != idx]

        # Merge pruned trials (current and prior passes) into the
        # suggester's view: terminal + scored-with-bad-value, so halving
        # settles its rungs and never promotes them.
        for key, entry in sorted(pruned.items(), key=lambda kv: int(kv[0])):
            idx = int(key)
            rows.append(
                {
                    "name": entry.get("name", trial_name(name, idx)),
                    "index": idx,
                    "state": "Pruned",
                    "objective": entry["objective"],
                    "prunedAtStep": entry["step"],
                }
            )
            records.append(
                study_api.TrialRecord(
                    index=idx,
                    state="Pruned",
                    assignment=dict(entry.get("assignment") or {}),
                    objective=_numeric(entry["objective"]),
                )
            )
        rows.sort(key=lambda r: r["index"])
        records.sort(key=lambda r: r.index)

        if failed > spec.max_failed_trials:
            api.record_event(
                study, "StudyFailed",
                f"{failed} failed trials > maxFailedTrials="
                f"{spec.max_failed_trials}",
                type_="Warning",
            )
            # Kill in-flight trials (katib semantics): a failed study must
            # not keep occupying gang-scheduled slices.
            for idx, trial in by_index.items():
                if trial.status.get("phase") not in TRIAL_TERMINAL:
                    try:
                        api.delete(
                            tpujob_api.KIND, trial.metadata.name, ns
                        )
                    except NotFound:
                        pass
            return self._finish(
                api, study, "Failed", trials=rows, best=best,
                reason="maxFailedTrials exceeded", pruned=pruned,
            )

        # High-water mark: indices at/below it are spent even if their
        # trial was deleted (deleted trials are never re-run). Pruned
        # indices are spent by construction.
        floor = max(
            _int_or(study.status.get("maxTrialIndex"), -1),
            max(by_index, default=-1),
            max((int(k) for k in pruned), default=-1),
        )
        new_trials, done = spec.suggest(
            records, slots=spec.parallelism - active, floor=floor
        )
        for index, assignment in new_trials:
            self._create_trial(study, spec, index, assignment)
            log.info(
                "study %s/%s: trial %d -> %s", ns, name, index, assignment
            )
            active += 1
            floor = max(floor, index)

        if done and not new_trials and active == 0:
            return self._finish(
                api, study, "Succeeded", trials=rows, best=best,
                pruned=pruned,
            )
        return self._update_status(
            api, study, "Running",
            trials=rows, best=best,
            counts={
                "active": active, "succeeded": succeeded,
                "failed": failed, "pruned": len(pruned),
            },
            max_index=floor,
            pruned=pruned,
        )

    # -- status ----------------------------------------------------------

    def _update_status(
        self,
        api: FakeApiServer,
        study: Resource,
        phase: str,
        *,
        trials=None,
        best=None,
        counts=None,
        reason: str | None = None,
        max_index: int | None = None,
        pruned: dict | None = None,
    ) -> Result:
        fresh = api.get(
            study_api.KIND, study.metadata.name, study.metadata.namespace
        ).thaw()
        new_status = dict(fresh.status)
        if trials is not None:
            new_status["trials"] = trials
        if best is not None:
            new_status["bestTrial"] = best
        if pruned:
            new_status["prunedTrials"] = pruned
        if counts is not None:
            new_status["trialStatuses"] = counts
        if max_index is not None and max_index >= 0:
            new_status["maxTrialIndex"] = max(
                max_index, _int_or(new_status.get("maxTrialIndex"), -1)
            )
        if reason is not None:
            new_status["reason"] = reason
        if new_status.get("phase") != phase:
            new_status["phase"] = phase
            # The condition list the conformance test polls
            # (`katib_studyjob_test.py:115-120` reads status.condition).
            new_status["conditions"] = list(
                new_status.get("conditions", [])
            ) + [{"type": "Completed" if phase == "Succeeded" else phase}]
        if new_status != fresh.status:
            fresh.status = new_status
            api.update_status(fresh)
        self.studies_running.set(
            sum(
                1
                for s in api.list(study_api.KIND)
                if s.status.get("phase") == "Running"
            )
        )
        return Result()

    def _finish(
        self, api, study, phase, *,
        trials=None, best=None, reason=None, pruned=None,
    ):
        api.record_event(
            study,
            "StudySucceeded" if phase == "Succeeded" else "StudyFailed",
            f"best: {best['name']}={best['objective']}" if best else phase,
        )
        return self._update_status(
            api, study, phase, trials=trials, best=best, reason=reason,
            pruned=pruned,
        )
