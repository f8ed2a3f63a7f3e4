"""The port's CronWorkflow controller
(`kubeflow_tpu_torch/controllers/cronworkflow.py`) against the JAX
package's.

First JAX's own CronWorkflow tests (tests/test_cronworkflow.py: parsing,
`next_after` with its sparse and DST cases, the anchor-only first
reconcile, one catch-up run however many ticks were missed, Allow,
Forbid and Replace, suspend, history GC, invalid and unsatisfiable
specs, adoption of a run spawned before a crash, and a spawned Workflow
run to Succeeded by the Workflow controller and a real step process
through the port's `LocalPodRunner`) run against the port: the module's
source with its imports pointed at the port.

Then one scripted sequence goes through both packages' controllers,
each on its own store, on one injected clock: clock ticks (single
periods, several missed periods, less than a period), spawned runs
finishing or failing, runs deleted, `suspend`, the concurrency policy
and the history limit edited. After every reconcile the CronWorkflow's
status, the spawned Workflows (names, labels, owner, spec, phase) and
the events are held equal, exactly. Deleting the CronWorkflow takes its
runs, their step pods and their TpuJobs with it on the port's store, as
on JAX's.
"""

import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import cronworkflow as j_cron
from kubeflow_tpu.controllers import workflow as j_workflow
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.controllers import cronworkflow as t_cron
from kubeflow_tpu_torch.controllers import workflow as t_workflow
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> list:
    """JAX's test module `path` executed with its `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.` (the port's testing package exports
    nothing at package level, so `FakeApiServer` comes from its module):
    (id, function, arguments) per test case, parametrized ones expanded."""
    src = path.read_text().replace("from kubeflow_tpu.testing import FakeApiServer",
                                   "from kubeflow_tpu.testing.fake_apiserver import "
                                   "FakeApiServer")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    cases = []
    for name, fn in sorted(namespace.items()):
        if not (name.startswith("test_") and callable(fn)):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            cases.append((name, fn, {}))
            continue
        [mark] = marks
        argname, values = mark.args
        cases += [(f"{name}[{v}]", fn, {argname: v}) for v in values]
    return cases


JAX_CASES = _jax_tests_on_the_port(REPO / "tests" / "test_cronworkflow.py")


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_jax_cronworkflow_tests_on_the_port(case, tmp_path):
    _, fn, kwargs = case
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = {**kwargs, "tmp_path": tmp_path}
    fn(**kwargs)


# -- one scripted sequence through both controllers ---------------------------

T0 = float(1_700_000_000 // 60 * 60)
WF_SPEC = {"steps": [
    {"name": "train", "tpuJob": {"replicas": 1, "command": ["python", "train.py"],
                                 "tpu": {"chipsPerWorker": 1}}},
    {"name": "eval", "command": ["eval", "${steps.train.output}"],
     "dependencies": ["train"]}],
    "onExit": {"name": "teardown", "command": ["rm", "-rf", "/ckpt"]}}


class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


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
    """One CronWorkflow in JAX's store and controller and in the port's,
    both on `clock`."""

    def __init__(self, spec: dict, clock: Clock):
        self.clock = clock
        self.sides = []
        for obj_new, mod, store in ((j_new_resource, j_cron, JFakeApiServer),
                                    (t_new_resource, t_cron, FakeApiServer)):
            api = store()
            ctl = mod.CronWorkflowController(api, now=clock)
            api.create(obj_new("CronWorkflow", "nightly", "ci", spec=spec))
            self.sides.append((api, ctl))

    def drain(self) -> dict:
        for _, ctl in self.sides:
            ctl.controller.run_until_idle()
        return self.snapshot()

    def snapshot(self) -> dict:
        out = []
        for api, _ in self.sides:
            cw = _plain(api.get("CronWorkflow", "nightly", "ci"))
            out.append({
                "cron": cw,
                "runs": [_plain(w) for w in api.list("Workflow", "ci")],
                "events": sorted((e.spec["reason"], e.spec["message"])
                                 for e in api.list("Event", "ci")),
            })
        assert out[1] == out[0]
        return out[1]

    def tick(self, dt: float) -> None:
        self.clock.t += dt
        for _, ctl in self.sides:
            ctl.controller.enqueue(("ci", "nightly"))

    def runs(self, api_index: int = 0) -> list:
        return self.sides[api_index][0].list("Workflow", "ci")

    def set_phase(self, name: str, phase: str) -> None:
        for api, _ in self.sides:
            wf = api.get("Workflow", name, "ci").thaw()
            wf.status = {**wf.status, "phase": phase}
            api.update_status(wf)

    def delete(self, name: str) -> None:
        for api, _ in self.sides:
            api.delete("Workflow", name, "ci")

    def edit(self, **changes) -> None:
        for api, _ in self.sides:
            cw = api.get("CronWorkflow", "nightly", "ci").thaw()
            cw.spec = {**cw.spec, **changes}
            api.update(cw)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", ["Allow", "Forbid", "Replace"])
def test_scripted_sequence_equals_jax(policy, seed):
    clock = Clock(T0 + 1)
    pair = Pair({"schedule": "*/30 * * * *", "workflowSpec": WF_SPEC,
                 "concurrencyPolicy": policy, "historyLimit": 2}, clock)
    rng = random.Random(seed)
    snap = pair.drain()
    assert "lastScheduleTime" in snap["cron"]["status"] and not snap["runs"]
    spawned = set()
    for _ in range(40):
        roll = rng.random()
        live = [w.metadata.name for w in pair.runs()
                if w.status.get("phase") not in ("Succeeded", "Failed")]
        if roll < 0.45:
            pair.tick(rng.choice([20, 600, 1800, 1801, 3600, 7200, 86400]))
        elif roll < 0.7 and live:
            pair.set_phase(rng.choice(live), rng.choice(["Running", "Succeeded",
                                                         "Failed"]))
        elif roll < 0.78 and pair.runs():
            pair.delete(rng.choice(pair.runs()).metadata.name)
        elif roll < 0.86:
            pair.edit(suspend=rng.random() < 0.4)
        elif roll < 0.93:
            pair.edit(historyLimit=rng.randrange(0, 3))
        else:
            pair.edit(concurrencyPolicy=rng.choice(["Allow", "Forbid", "Replace"]))
        snap = pair.drain()
        spawned |= {r["metadata"]["name"] for r in snap["runs"]}
        for run in snap["runs"]:
            assert run["metadata"]["labels"] == {t_cron.LABEL_CRON: "nightly"}
            assert run["metadata"]["ownerReferences"][0]["name"] == "nightly"
            assert run["spec"] == WF_SPEC
    assert spawned


def test_forbid_suspend_after_spawn_runs_one_equals_jax():
    """The pipeline's use: Forbid, and suspend set as soon as the first
    run exists; however much time passes, one run."""
    clock = Clock(T0 + 1)
    pair = Pair({"schedule": "* * * * *", "workflowSpec": WF_SPEC,
                 "concurrencyPolicy": "Forbid"}, clock)
    pair.drain()
    pair.tick(59)
    snap = pair.drain()
    [run] = snap["runs"]
    assert run["metadata"]["name"] == f"nightly-{int(T0 + 60)}"
    pair.edit(suspend=True)
    pair.drain()
    pair.set_phase(run["metadata"]["name"], "Succeeded")
    for dt in (61, 3600, 86400):
        pair.tick(dt)
        snap = pair.drain()
        assert [r["metadata"]["name"] for r in snap["runs"]] == [run["metadata"]["name"]]


@pytest.mark.parametrize("sides", [
    (j_new_resource, j_cron, j_workflow, JFakeApiServer),
    (t_new_resource, t_cron, t_workflow, FakeApiServer),
], ids=["jax", "port"])
def test_deleting_the_cron_workflow_cascades_to_its_run(sides):
    obj_new, cron_mod, wf_mod, store = sides
    api = store()
    clock = Clock(T0 + 1)
    cron = cron_mod.CronWorkflowController(api, now=clock)
    wf = wf_mod.WorkflowController(api)
    api.create(obj_new("CronWorkflow", "nightly", "ci",
                       spec={"schedule": "* * * * *", "workflowSpec": WF_SPEC}))
    cron.controller.run_until_idle()
    clock.t += 61
    cron.controller.enqueue(("ci", "nightly"))
    cron.controller.run_until_idle()
    wf.controller.run_until_idle()
    [run] = api.list("Workflow", "ci")
    [job] = api.list("TpuJob", "ci")
    assert job.metadata.owner_references[0]["uid"] == run.metadata.uid
    job = job.thaw()
    job.status = {"phase": "Succeeded", "observation": {"loss": 1.0}}
    api.update_status(job)
    wf.controller.run_until_idle()
    assert [p.metadata.name for p in api.list("Pod", "ci")] == [
        f"{run.metadata.name}-eval-0"]
    api.delete("CronWorkflow", "nightly", "ci")
    assert not api.list("Workflow", "ci")
    assert not api.list("TpuJob", "ci") and not api.list("Pod", "ci")
