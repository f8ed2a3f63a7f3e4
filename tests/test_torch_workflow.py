"""The port's Workflow controller (`kubeflow_tpu_torch/controllers/workflow.py`)
against the JAX package's.

First JAX's own Workflow tests (tests/test_workflow.py: DAG order and
fan-out, the parallelism cap, retries and the persisted failed attempts,
fail-fast, the exit handler once after success or failure, GC'd pods,
invalid specs, parameters and step outputs, render failures that still
run the teardown, withItems, `when`, TpuJob slice steps and their
Restarting phase) run against the port: the module's source with its
imports pointed at the port, the CI DAG builders and the junit merge
(`testing/workflows.py`, `testing/junit_merge.py`, since PR 22) among
them.

Then one scripted sequence of events goes through both packages'
controllers, each on its own store: pod phases and outputs, TpuJob
phases (Restarting among them) and observations, deletions of pods and
jobs, re-enqueues. After every reconcile the resources each created
(names, labels, owner, rendered command, args and env, the TpuJob spec)
and the Workflow's status and events are held equal, exactly.
"""

import json
import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import workflow as j_workflow
from kubeflow_tpu.controllers.workflow import report_step_output as j_report
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.controllers import workflow as t_workflow
from kubeflow_tpu_torch.controllers.workflow import report_step_output as t_report
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]
def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with its `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: its test functions by name."""
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items() if k.startswith("test_") and callable(v)}


JAX_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_workflow.py")


@pytest.mark.parametrize("name", sorted(JAX_TESTS))
def test_jax_workflow_tests_on_the_port(name, tmp_path):
    fn = JAX_TESTS[name]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


# -- one scripted sequence through both controllers ---------------------------

ECHO = ["/bin/echo", "ok"]
JOB = {"replicas": 1, "image": "local", "command": ["python", "train.py"],
       "tpu": {"chipsPerWorker": 1}, "maxRestarts": 2}

SPECS = {
    "diamond_retries_exit": {
        "steps": [
            {"name": "a", "command": ECHO, "retries": 1},
            {"name": "b", "command": ECHO, "dependencies": ["a"], "retries": 2},
            {"name": "c", "command": ECHO, "dependencies": ["a"]},
            {"name": "d", "command": ["join"], "dependencies": ["b", "c"]}],
        "onExit": {"name": "teardown", "command": ["rm", "-rf", "x"], "retries": 1},
        "artifactsDir": "/tmp/art", "parallelism": 2},
    "outputs_and_when": {
        "parameters": {"cluster": "ci-1", "zone": "us-east5"},
        "steps": [
            {"name": "probe", "command": ECHO,
             "env": [{"name": "ZONE", "value": "${workflow.parameters.zone}"}]},
            {"name": "fix", "command": ["fix", "${steps.probe.output}"],
             "dependencies": ["probe"], "when": "${steps.probe.output} == unhealthy"},
            {"name": "report", "command": ["report", "${steps.probe.output}"],
             "dependencies": ["fix"], "retries": 1}],
        "onExit": {"name": "teardown",
                   "command": ["rm", "${workflow.parameters.cluster}",
                               "${steps.report.output}"]}},
    "slice_pipeline": {
        "parameters": {"steps": "8", "ckpt": "/ckpt", "limit": "11.37"},
        "steps": [
            {"name": "train", "retries": 1, "tpuJob": {**JOB, "env": [
                {"name": "KFTPU_TOTAL_STEPS", "value": "${workflow.parameters.steps}"},
                {"name": "KFTPU_CKPT_DIR", "value": "${workflow.parameters.ckpt}"}]}},
            {"name": "eval", "command": ["eval", "--observation", "${steps.train.output}",
                                         "--max", "${workflow.parameters.limit}"],
             "dependencies": ["train"]},
            {"name": "serve", "command": ["serve", "${workflow.parameters.ckpt}"],
             "dependencies": ["eval"], "when": "${steps.eval.output} == promote"}],
        "onExit": {"name": "teardown", "command": ["rm", "-rf",
                                                    "${workflow.parameters.ckpt}"]}},
    "fanout": {
        "steps": [
            {"name": "shard", "command": ["run", "${item}"], "withItems": ["a", "b", "c"],
             "retries": 1},
            {"name": "sweep", "withItems": ["1e-3", "1e-4"],
             "tpuJob": {**JOB, "args": ["--lr", "${item}"]}},
            {"name": "join", "command": ["collect"], "dependencies": ["shard", "sweep"]}],
        "parallelism": 3},
}
OUTPUTS = ["ok", "promote", "hold", "unhealthy", "x == y", "${workflow.parameters.zone}"]


def _plain(obj) -> dict:
    d = obj.to_dict()
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation",
              "deletionTimestamp", "finalizers"):
        d["metadata"].pop(k, None)
    for ref in d["metadata"].get("ownerReferences", []):
        ref.pop("uid", None)
    d.pop("apiVersion", None)
    return d


class Pair:
    """The same Workflow in JAX's store and controller and in the port's."""

    def __init__(self, spec: dict):
        self.sides = []
        for obj_new, ctl_mod, store, report in (
            (j_new_resource, j_workflow, JFakeApiServer, j_report),
            (t_new_resource, t_workflow, FakeApiServer, t_report),
        ):
            api = store()
            ctl = ctl_mod.WorkflowController(api)
            api.create(obj_new("Workflow", "wf", "ci", spec=spec))
            self.sides.append((api, ctl, report))

    def drain(self) -> dict:
        for api, ctl, _ in self.sides:
            ctl.controller.run_until_idle()
        return self.snapshot()

    def snapshot(self) -> dict:
        out = []
        for api, _, _ in self.sides:
            out.append({
                "workflow": _plain(api.get("Workflow", "wf", "ci")),
                "pods": [_plain(p) for p in api.list("Pod", "ci")],
                "jobs": [_plain(j) for j in api.list("TpuJob", "ci")],
                "events": sorted((e.spec["reason"], e.spec["message"])
                                 for e in api.list("Event", "ci")),
            })
        assert out[1] == out[0]
        return out[1]

    def live(self) -> list[tuple[str, str]]:
        api = self.sides[0][0]
        return [(kind, o.metadata.name) for kind in ("Pod", "TpuJob")
                for o in api.list(kind, "ci")
                if o.status.get("phase") not in ("Succeeded", "Failed")]

    def done(self) -> list[tuple[str, str]]:
        api = self.sides[0][0]
        return [(kind, o.metadata.name) for kind in ("Pod", "TpuJob")
                for o in api.list(kind, "ci")
                if o.status.get("phase") in ("Succeeded", "Failed")]

    def set_status(self, kind: str, name: str, **status) -> None:
        for api, _, _ in self.sides:
            obj = api.get(kind, name, "ci").thaw()
            obj.status = {**obj.status, **status}
            api.update_status(obj)

    def report(self, pod: str, output: str) -> None:
        for api, _, report in self.sides:
            report(api, pod, "ci", output)

    def delete(self, kind: str, name: str) -> None:
        for api, _, _ in self.sides:
            api.delete(kind, name, "ci")

    def enqueue(self) -> None:
        for _, ctl, _ in self.sides:
            ctl.controller.enqueue(("ci", "wf"))


def _act(pair: Pair, rng: random.Random) -> None:
    live, done = pair.live(), pair.done()
    if done and rng.random() < 0.1:
        pair.delete(*done[rng.randrange(len(done))])  # GC a finished attempt
        return
    if not live:
        pair.enqueue()
        return
    kind, name = live[rng.randrange(len(live))]
    roll = rng.random()
    if kind == "Pod":
        if roll < 0.2:
            pair.set_status(kind, name, phase="Running")
        elif roll < 0.75:
            if rng.random() < 0.8:
                pair.report(name, rng.choice(OUTPUTS))
            pair.set_status(kind, name, phase="Succeeded")
        elif roll < 0.95:
            pair.set_status(kind, name, phase="Failed")
        else:
            pair.delete(kind, name)
    else:
        if roll < 0.15:
            pair.set_status(kind, name, phase="Running")
        elif roll < 0.4:
            pair.set_status(kind, name, phase="Restarting", restarts=1)
        elif roll < 0.8:
            pair.set_status(kind, name, phase="Succeeded", observation={
                "loss": round(rng.uniform(9, 12), 4), "resumed_from": 4.0,
                "steps_done": 4.0})
        else:
            pair.set_status(kind, name, phase="Failed")


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_scripted_sequence_equals_jax(spec, seed):
    pair = Pair(SPECS[spec])
    rng = random.Random(seed * 1000 + len(spec))
    snap = pair.drain()
    for _ in range(80):
        if snap["workflow"]["status"].get("phase") in ("Succeeded", "Failed"):
            break
        _act(pair, rng)
        snap = pair.drain()
    assert snap["workflow"]["status"]["phase"] in ("Succeeded", "Failed")


def test_slice_step_through_restarting_to_promote_equals_jax():
    """The pipeline's path, step by step: the train TpuJob goes Running,
    Restarting (in flight: no second attempt), Running and Succeeded with
    its observation; eval renders that observation into its argv and
    reads promote; serve runs; teardown runs once; Succeeded."""
    pair = Pair(SPECS["slice_pipeline"])
    snap = pair.drain()
    [job] = snap["jobs"]
    assert job["metadata"]["name"] == "wf-train-0"
    assert job["metadata"]["labels"][t_workflow.LABEL_ATTEMPT] == "0"
    assert {e["name"]: e["value"] for e in job["spec"]["env"]} == {
        "KFTPU_TOTAL_STEPS": "8", "KFTPU_CKPT_DIR": "/ckpt"}
    assert job["spec"]["replicas"] == 1 and job["spec"]["tpu"] == {"chipsPerWorker": 1}
    for phase in ("Running", "Restarting", "Running"):
        pair.set_status("TpuJob", "wf-train-0", phase=phase, restarts=int(phase != "Running"))
        snap = pair.drain()
        assert len(snap["jobs"]) == 1
        assert snap["workflow"]["status"]["steps"]["train"]["state"] == "Running"
    obs = {"loss": 10.4, "resumed_from": 4.0, "steps_done": 4.0}
    pair.set_status("TpuJob", "wf-train-0", phase="Succeeded", observation=obs)
    snap = pair.drain()
    [pod] = snap["pods"]
    assert pod["spec"]["containers"][0]["command"] == [
        "eval", "--observation", json.dumps(obs, sort_keys=True), "--max", "11.37"]
    env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    assert env["POD_NAME"] == "wf-eval-0" and env["POD_NAMESPACE"] == "ci"
    pair.report("wf-eval-0", "promote")
    pair.set_status("Pod", "wf-eval-0", phase="Succeeded")
    pair.drain()
    pair.report("wf-serve-0", '{"version": 8, "answered": 3}')
    pair.set_status("Pod", "wf-serve-0", phase="Succeeded")
    snap = pair.drain()
    teardown = [p for p in snap["pods"] if p["metadata"]["name"] == "wf-teardown-0"]
    assert teardown[0]["spec"]["containers"][0]["command"] == ["rm", "-rf", "/ckpt"]
    pair.set_status("Pod", "wf-teardown-0", phase="Succeeded")
    pair.enqueue()
    snap = pair.drain()
    status = snap["workflow"]["status"]
    assert status["phase"] == "Succeeded"
    assert {k: (v["state"], v["attempts"]) for k, v in status["steps"].items()} == {
        "train": ("Succeeded", 1), "eval": ("Succeeded", 1), "serve": ("Succeeded", 1),
        "teardown": ("Succeeded", 1)}


def test_hold_skips_serve_and_still_tears_down_equals_jax():
    pair = Pair(SPECS["slice_pipeline"])
    pair.drain()
    pair.set_status("TpuJob", "wf-train-0", phase="Succeeded", observation={"loss": 99.0})
    pair.drain()
    pair.report("wf-eval-0", "hold")
    pair.set_status("Pod", "wf-eval-0", phase="Succeeded")
    snap = pair.drain()
    assert snap["workflow"]["status"]["steps"]["serve"]["state"] == "Skipped"
    assert [p["metadata"]["name"] for p in snap["pods"]] == ["wf-eval-0", "wf-teardown-0"]
    pair.set_status("Pod", "wf-teardown-0", phase="Succeeded")
    snap = pair.drain()
    assert snap["workflow"]["status"]["phase"] == "Succeeded"
