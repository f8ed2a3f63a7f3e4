"""Workflow controller: drives a DAG of step Pods to completion.

The Argo-engine analog (the reference runs its whole CI and its
ml-pipeline component on Argo, `testing/README.md:22-35`): level-triggered
like every other controller here — each reconcile reads the observed step
pods and creates whatever steps have all dependencies satisfied, up to
`spec.parallelism`. Failures retry up to the step's budget by creating
attempt N+1; failed attempt indices are persisted in status so a GC'd
failed pod neither refunds the budget nor wedges numbering. When the
DAG is terminal the `onExit` step runs exactly once, success or failure
— teardown must never be skipped (`kfctl_go_test.jsonnet:384-391`).

Step pods carry STEP_NAME / WORKFLOW_NAME / STEP_ARTIFACTS env (the
shared-volume contract of `workflows.libsonnet:145`), and their own
POD_NAME / POD_NAMESPACE for `report_step_output`.

Counterpart of `kubeflow_tpu/controllers/workflow.py` (a module with no
JAX in it), whole, on the port's API objects and store: it reconciles
the same way against the in-process `FakeApiServer` and, in the
controller-manager binary, against `HttpApiClient`. A slice step's
TpuJob goes to the port's operator (GPU workers); its ``Restarting``
phase is in flight, never a failed attempt.
"""

from __future__ import annotations

import logging

from kubeflow_tpu_torch.api import workflow as wf_api
from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.api.tpujob import KIND as TPUJOB_KIND
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

LABEL_WORKFLOW = "kubeflow-tpu.org/workflow"
LABEL_STEP = "kubeflow-tpu.org/step"
LABEL_ATTEMPT = "kubeflow-tpu.org/attempt"

TERMINAL = ("Succeeded", "Failed")


def step_pod_name(workflow: str, step: str, attempt: int) -> str:
    return f"{workflow}-{step}-{attempt}"


def report_step_output(api, pod_name: str, namespace: str, output) -> None:
    """Called by a step process (through HttpApiClient using the POD_NAME
    env) before exiting 0: stores the step's output on its pod status for
    downstream `${steps.<name>.output}` rendering — the Argo
    output-parameter contract, apiserver-reported like a trial's
    observation."""
    pod = api.get("Pod", pod_name, namespace).thaw()
    pod.status["output"] = str(output)
    api.update_status(pod)


def _attempt_output(res: Resource) -> str | None:
    """A pod attempt's reported output, or — for a slice step's TpuJob —
    the gang's observation as JSON (the launcher's report_observation
    contract), so downstream steps can template on training results."""
    output = res.status.get("output")
    if output is not None:
        return str(output)
    if res.kind == TPUJOB_KIND:
        observation = res.status.get("observation")
        if observation is not None:
            import json

            return json.dumps(observation, sort_keys=True)
    return None


def next_attempt(attempts: list[Resource]) -> int:
    """max(observed attempt label)+1, NOT len(observed): a deleted
    attempt pod must not make us recreate a name that still exists."""
    return (
        max(
            (
                int(p.metadata.labels.get(LABEL_ATTEMPT, "0"))
                for p in attempts
            ),
            default=-1,
        )
        + 1
    )


class WorkflowController:
    def __init__(self, api: FakeApiServer, metrics: MetricsRegistry | None = None):
        self.api = api
        metrics = metrics or MetricsRegistry()
        self.steps_total = metrics.counter(
            "workflow_steps_total", "step pods created", ("workflow",)
        )
        self.workflows_running = metrics.gauge(
            "workflow_running", "Workflows currently running"
        )
        self.controller = Controller(
            api,
            wf_api.KIND,
            self.reconcile,
            # Slice steps materialize TpuJobs instead of Pods; both kinds
            # drive the DAG via ownership watches.
            owns=("Pod", TPUJOB_KIND),
            name="workflow-controller",
            metrics=metrics,
        )

    # -- pod materialization ---------------------------------------------

    def _create_step_pod(
        self,
        workflow: Resource,
        spec: wf_api.WorkflowSpec,
        step: wf_api.StepSpec,
        attempt: int,
    ) -> None:
        if step.tpu_job is not None:
            # Slice step: a whole TpuJob gang instead of one pod — the
            # TpuJob operator takes it from here (placement, env
            # contract, whole-gang restart); the DAG reads its phase.
            job = new_resource(
                TPUJOB_KIND,
                step_pod_name(workflow.metadata.name, step.name, attempt),
                workflow.metadata.namespace,
                spec=dict(step.tpu_job),
                labels={
                    LABEL_WORKFLOW: workflow.metadata.name,
                    LABEL_STEP: step.name,
                    LABEL_ATTEMPT: str(attempt),
                },
            )
            job.metadata.owner_references = [owner_ref(workflow)]
            self.api.create(job)
            self.steps_total.inc(workflow=workflow.metadata.name)
            return
        env = dict(step.env)
        env["WORKFLOW_NAME"] = workflow.metadata.name
        env["STEP_NAME"] = step.name
        # Its own pod coordinates, so the step can report_step_output over
        # the apiserver facade.
        env["POD_NAME"] = step_pod_name(
            workflow.metadata.name, step.name, attempt
        )
        env["POD_NAMESPACE"] = workflow.metadata.namespace
        if spec.artifacts_dir:
            env["STEP_ARTIFACTS"] = spec.artifacts_dir
        pod = new_resource(
            "Pod",
            step_pod_name(workflow.metadata.name, step.name, attempt),
            workflow.metadata.namespace,
            spec={
                "containers": [
                    {
                        "name": "main",
                        "image": step.image,
                        "command": list(step.command),
                        "args": list(step.args),
                        "env": [
                            {"name": k, "value": v}
                            for k, v in sorted(env.items())
                        ],
                    }
                ],
                "restartPolicy": "Never",
            },
            labels={
                LABEL_WORKFLOW: workflow.metadata.name,
                LABEL_STEP: step.name,
                LABEL_ATTEMPT: str(attempt),
            },
        )
        pod.metadata.owner_references = [owner_ref(workflow)]
        self.api.create(pod)
        self.steps_total.inc(workflow=workflow.metadata.name)

    # -- reconcile --------------------------------------------------------

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        ns, name = key
        try:
            wf = api.get(wf_api.KIND, name, ns)
        except NotFound:
            return Result()
        if wf.status.get("phase") in TERMINAL:
            return Result()
        try:
            spec = wf_api.WorkflowSpec.from_dict(wf.spec)
        except Exception as e:
            # Spec dicts are client-writable; any parse failure (KeyError,
            # TypeError, ...) is a terminal InvalidSpec, not a reason to
            # crash-loop in requeue backoff.
            api.record_event(wf, "InvalidSpec", str(e), type_="Warning")
            return self._set_status(api, wf, "Failed", reason=str(e))

        pods = api.list(
            "Pod", ns, label_selector={LABEL_WORKFLOW: name}
        ) + api.list(
            TPUJOB_KIND, ns, label_selector={LABEL_WORKFLOW: name}
        )
        by_step: dict[str, list[Resource]] = {}
        for p in pods:
            by_step.setdefault(p.metadata.labels.get(LABEL_STEP, ""), []).append(p)

        # Observed per-step state. A step is Succeeded if any attempt
        # succeeded; Failed once failures exceed its retry budget; Running
        # while an attempt is in flight. Failed attempt *indices* are
        # persisted in status and unioned with observation — a failed pod
        # that gets deleted (GC, eviction) must not refund the budget.
        prev_steps = wf.status.get("steps", {})
        steps_status: dict[str, dict] = {}
        active = 0
        for step in spec.steps:
            attempts = by_step.get(step.name, [])
            phases = [p.status.get("phase", "Pending") for p in attempts]
            failed_attempts = set(
                prev_steps.get(step.name, {}).get("failedAttempts", [])
            )
            failed_attempts.update(
                int(p.metadata.labels.get(LABEL_ATTEMPT, "0"))
                for p in attempts
                if p.status.get("phase") == "Failed"
            )
            state = "Pending"
            render_error = prev_steps.get(step.name, {}).get("renderError")
            # Success persists in status too: a GC'd Succeeded pod must
            # not make a completed step (and its side effects) re-run.
            # A render failure persists the same way — re-deriving it
            # every pass would flip the status and spam InvalidSpec
            # events until the DAG drains.
            if (
                any(ph == "Succeeded" for ph in phases)
                or prev_steps.get(step.name, {}).get("state") == "Succeeded"
            ):
                state = "Succeeded"
            elif prev_steps.get(step.name, {}).get("state") == "Skipped":
                # A `when` that evaluated false is a terminal decision —
                # outputs it was judged on never change after the fact.
                state = "Skipped"
            elif render_error:
                state = "Failed"
            elif any(ph not in ("Succeeded", "Failed") for ph in phases):
                # Anything non-terminal is in flight — slice steps'
                # TpuJobs have phases beyond Pending/Running (e.g.
                # Restarting mid-gang-recovery); treating those as "not
                # running" would materialize a duplicate concurrent gang.
                state = "Running"
                active += 1
            elif attempts or failed_attempts:
                if len(failed_attempts) > step.retries:
                    state = "Failed"
                else:
                    state = "Retrying"  # next pass creates attempt N+1
            # Harvest the step's reported output (report_step_output) from
            # the succeeded attempt; persisted in status so a GC'd pod
            # doesn't lose it for downstream template rendering.
            output = prev_steps.get(step.name, {}).get("output")
            if state == "Succeeded" and output is None:
                for p in attempts:
                    if p.status.get("phase") == "Succeeded":
                        output = _attempt_output(p)
                        if output is not None:
                            break
            steps_status[step.name] = {
                "state": state,
                "attempts": len(attempts),
                "failedAttempts": sorted(failed_attempts),
            }
            if render_error:
                steps_status[step.name]["renderError"] = render_error
            if output is not None:
                steps_status[step.name]["output"] = str(output)

        # Schedule: dependencies satisfied, budget left, parallelism cap.
        dag_failed = any(
            s["state"] == "Failed" for s in steps_status.values()
        )
        outputs = {
            n: s["output"] for n, s in steps_status.items() if "output" in s
        }
        for step in spec.steps:
            if active >= spec.parallelism:
                break
            st = steps_status[step.name]
            if st["state"] not in ("Pending", "Retrying"):
                continue
            if dag_failed:
                # Fail-fast: no new steps once any step is terminally
                # failed (Argo's default DAG behavior); running ones drain.
                continue
            if not all(
                steps_status[d]["state"] in ("Succeeded", "Skipped")
                for d in step.dependencies
            ):
                # Argo DAG semantics: Skipped satisfies a dependency —
                # dependents of a when-skipped step still run.
                continue
            attempt = max(
                next_attempt(by_step.get(step.name, [])),
                max(st["failedAttempts"], default=-1) + 1,
            )
            try:
                if step.when:
                    # Conditional guard, evaluated once dependencies are
                    # satisfied so `${steps.<dep>.output}` is available;
                    # eval_when parses the operator before templating.
                    if not wf_api.eval_when(
                        step.when, spec.parameters, outputs
                    ):
                        st["state"] = "Skipped"
                        continue
                rendered = wf_api.render_step(
                    step, spec.parameters, outputs
                )
            except ValueError as e:
                # A typo'd parameter/output reference fails the STEP (so
                # the DAG fails and the exit handler still runs — teardown
                # must never be skipped), never crash-loops.
                api.record_event(
                    wf, "InvalidSpec",
                    f"step {step.name!r}: {e}", type_="Warning",
                )
                st["state"] = "Failed"
                st["renderError"] = str(e)
                dag_failed = True
                continue
            self._create_step_pod(wf, spec, rendered, attempt)
            st["state"] = "Running"
            st["attempts"] += 1
            active += 1

        dag_done = all(
            s["state"] in ("Succeeded", "Skipped")
            for s in steps_status.values()
        )
        dag_terminal = dag_done or (dag_failed and active == 0)

        # Exit handler: once, after the DAG is terminal.
        exit_state = None
        if spec.on_exit is not None and dag_terminal:
            exit_attempts = by_step.get(spec.on_exit.name, [])
            exit_phases = [
                p.status.get("phase", "Pending") for p in exit_attempts
            ]
            exit_failed = set(
                prev_steps.get(spec.on_exit.name, {}).get("failedAttempts", [])
            )
            exit_failed.update(
                int(p.metadata.labels.get(LABEL_ATTEMPT, "0"))
                for p in exit_attempts
                if p.status.get("phase") == "Failed"
            )
            exit_prev = prev_steps.get(spec.on_exit.name, {}).get("state")
            # The exit handler renders best-effort (partial=True): on a
            # failed DAG some referenced outputs may not exist, but every
            # resolvable value (cluster names, zones) must still land —
            # teardown runs with the most information available.
            exit_step = wf_api.render_step(
                spec.on_exit, spec.parameters, outputs, partial=True
            )
            if (
                any(ph == "Succeeded" for ph in exit_phases)
                or exit_prev == "Succeeded"
            ):
                exit_state = "Succeeded"
            elif not exit_attempts and not exit_failed:
                self._create_step_pod(wf, spec, exit_step, 0)
                exit_state = "Running"
            elif any(
                ph not in ("Succeeded", "Failed") for ph in exit_phases
            ):
                exit_state = "Running"
            elif len(exit_failed) > spec.on_exit.retries:
                exit_state = "Failed"
            else:
                self._create_step_pod(
                    wf, spec, exit_step,
                    max(
                        next_attempt(exit_attempts),
                        max(exit_failed, default=-1) + 1,
                    ),
                )
                exit_state = "Running"
            steps_status[spec.on_exit.name] = {
                "state": exit_state,
                "attempts": len(by_step.get(spec.on_exit.name, [])),
                "failedAttempts": sorted(exit_failed),
            }

        if dag_terminal and (spec.on_exit is None or exit_state in TERMINAL):
            phase = "Succeeded" if dag_done else "Failed"
            # A failing teardown fails the workflow even if the DAG
            # succeeded — leaked clusters must be loud.
            if exit_state == "Failed":
                phase = "Failed"
            api.record_event(
                wf,
                "WorkflowSucceeded" if phase == "Succeeded" else "WorkflowFailed",
                f"DAG {'succeeded' if dag_done else 'failed'}",
                type_="Normal" if phase == "Succeeded" else "Warning",
            )
            return self._set_status(api, wf, phase, steps=steps_status)

        return self._set_status(api, wf, "Running", steps=steps_status)

    # -- status -----------------------------------------------------------

    def _set_status(
        self,
        api: FakeApiServer,
        wf: Resource,
        phase: str,
        *,
        steps: dict | None = None,
        reason: str | None = None,
    ) -> Result:
        fresh = api.get(
            wf_api.KIND, wf.metadata.name, wf.metadata.namespace
        ).thaw()
        new_status = dict(fresh.status)
        if steps is not None:
            new_status["steps"] = steps
        if reason is not None:
            new_status["reason"] = reason
        if new_status.get("phase") != phase:
            new_status["phase"] = phase
            new_status["conditions"] = list(
                new_status.get("conditions", [])
            ) + [{"type": phase}]
        if new_status != fresh.status:
            fresh.status = new_status
            api.update_status(fresh)
        self.workflows_running.set(
            sum(
                1
                for w in api.list(wf_api.KIND)
                if w.status.get("phase") == "Running"
            )
        )
        return Result()
