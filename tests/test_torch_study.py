"""The port's Study controller (`kubeflow_tpu_torch/controllers/study.py`)
against the JAX package's.

First JAX's own Study tests (tests/test_study.py: suggestion algorithms,
the controller's trial lifecycle, halving rungs, failure budgets,
deleted trials, early stopping, the launcher's observation round trip)
run against the port: the module's source with its imports pointed at
the port. Then the same Study goes into both packages' store and
controller with the same scripted trial outcomes (`report_observation`
and `report_metrics` from each package's launcher), and the trial
TpuJobs (rendered templates, labels, annotations), the status rows,
`bestTrial`, the early-stopping prunes and the events are held equal,
exactly.
"""

import json
import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api import study as j_study_api
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import study as j_study
from kubeflow_tpu.launcher import launcher as j_launcher
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api import study as t_study_api
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.controllers import study as t_study
from kubeflow_tpu_torch.launcher import launcher as t_launcher
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: its test functions by name."""
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items() if k.startswith("test_") and callable(v)}


JAX_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_study.py")


@pytest.mark.parametrize("name", sorted(JAX_TESTS))
def test_jax_study_tests_on_the_port(name):
    JAX_TESTS[name]()


# -- the same Study through both controllers ---------------------------------

TEMPLATE = {
    "replicas": 1,
    "image": "worker:1",
    "command": ["python", "-m", "train"],
    "args": ["--lr", "${trialParameters.lr}", "--depth=${trialParameters.depth}"],
    "env": [{"name": "OPT", "value": "${trialParameters.opt}"}],
    "tpu": {"chipsPerWorker": 1},
    "maxRestarts": 1,
}


def _study_spec(mod, algorithm, **kw):
    params = (
        mod.ParameterSpec("lr", "double", min=1e-3, max=1e-1, log_scale=True,
                          grid_points=3),
        mod.ParameterSpec("depth", "int", min=1, max=4, grid_points=2),
        mod.ParameterSpec("opt", "categorical", values=("sgd", "adam")),
    )
    return mod.StudySpec(parameters=params, objective_metric="loss", algorithm=algorithm,
                         trial_template=TEMPLATE, **kw)


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
    def __init__(self, algorithm, **kw):
        self.sides = []
        for api_mod, obj_new, ctl_mod, launcher, store in (
            (j_study_api, j_new_resource, j_study, j_launcher, JFakeApiServer),
            (t_study_api, t_new_resource, t_study, t_launcher, FakeApiServer),
        ):
            api = store()
            ctl = ctl_mod.StudyController(api)
            api.create(obj_new(api_mod.KIND, "s", "team",
                               spec=_study_spec(api_mod, algorithm, **kw).to_dict()))
            self.sides.append((api, ctl, launcher))

    def drain(self):
        for api, ctl, _ in self.sides:
            ctl.controller.run_until_idle()
        return self.snapshot()

    def snapshot(self):
        out = []
        for api, _, _ in self.sides:
            out.append({
                "study": _plain(api.get("Study", "s", "team")),
                "trials": [_plain(t) for t in api.list("TpuJob", "team")],
                "events": sorted((e.spec["reason"], e.spec["message"])
                                 for e in api.list("Event", "team")),
            })
        assert out[1] == out[0]
        return out[1]

    def running(self):
        return [t.metadata.name for t in self.sides[0][0].list("TpuJob", "team")
                if t.status.get("phase") not in ("Succeeded", "Failed")]

    def observe(self, trial, metrics):
        for api, _, launcher in self.sides:
            launcher.report_observation(api, trial, "team", metrics)

    def curve(self, trial, step, metrics):
        for api, _, launcher in self.sides:
            launcher.report_metrics(api, trial, "team", step, metrics)

    def phase(self, trial, phase):
        for api, _, _ in self.sides:
            job = api.get("TpuJob", trial, "team").thaw()
            job.status["phase"] = phase
            api.update_status(job)


@pytest.mark.parametrize("algorithm, kw", [
    ("grid", dict(max_trials=12, parallelism=3)),
    ("random", dict(seed=4, max_trials=7, parallelism=2, max_failed_trials=1)),
    ("bayesian", dict(seed=2, max_trials=9, parallelism=2, startup_trials=3)),
    ("halving", dict(seed=1, max_trials=6, parallelism=3, eta=2, min_budget=1.0,
                     max_budget=4.0)),
])
def test_study_sequence_equals_jax(algorithm, kw):
    pair = Pair(algorithm, **kw)
    rng = random.Random(len(algorithm))
    snap = pair.drain()
    first = snap["trials"][0]
    # The rendered template, labels and annotations, checked once in full.
    assignment = json.loads(first["metadata"]["annotations"][t_study.ANNOTATION_PARAMS])
    assert first["spec"]["args"][1] == assignment["lr"]
    assert first["metadata"]["labels"] == {t_study.LABEL_STUDY: "s", t_study.LABEL_TRIAL: "0"}
    for _ in range(60):
        running = pair.running()
        if not running:
            break
        trial = running[rng.randrange(len(running))]
        if rng.random() < 0.15:
            pair.phase(trial, "Failed")
        else:
            pair.observe(trial, {"loss": rng.random(), "accuracy": rng.random()})
            pair.phase(trial, "Succeeded")
        snap = pair.drain()
    status = snap["study"]["status"]
    assert status["phase"] in ("Succeeded", "Failed")
    assert len(status["trials"]) >= 2
    if status["phase"] == "Succeeded":
        assert status["bestTrial"]["objective"] == min(
            r["objective"] for r in status["trials"] if r["state"] == "Succeeded")


def test_early_stopping_prunes_equal_jax():
    pair = Pair("random", seed=7, max_trials=6, parallelism=3,
                early_stopping={"minSteps": 2, "minPeers": 2})
    pair.drain()
    rng = random.Random(3)
    pruned = set()
    for step in range(1, 7):
        for trial in pair.running():
            # trial-1 is the straggler: worse than every peer at each step.
            base = 5.0 if trial.endswith("-1") else 1.0
            pair.curve(trial, step, {"loss": base + rng.random() / step})
        snap = pair.drain()
        pruned |= set(snap["study"]["status"].get("prunedTrials") or {})
        if step == 4:
            for trial in pair.running()[:1]:
                pair.observe(trial, {"loss": 0.5})
                pair.phase(trial, "Succeeded")
            pair.drain()
    assert "1" in pruned
    assert any(e[0] == "TrialPruned" for e in snap["events"])
    rows = {r["index"]: r for r in snap["study"]["status"]["trials"]}
    assert rows[1]["state"] == "Pruned" and rows[1]["prunedAtStep"] >= 2
