"""The port's Study CRD (`kubeflow_tpu_torch/api/study.py`) against the JAX
package's (`kubeflow_tpu/api/study.py`).

Exact equality throughout: `ParameterSpec`/`StudySpec` serialize the
same dicts and parse each other's; for each algorithm (random, grid,
bayesian TPE, successive halving) the same seed and the same observed
history give the same suggestions, index for index and value for value
(both are pure Python on `random.Random`); `render_template` renders
the same spec.
"""

import math
import random
import zlib

import pytest

from kubeflow_tpu.api import study as jstudy
from kubeflow_tpu_torch.api import study as tstudy

PARAMS = [
    dict(name="lr", type="double", min=1e-4, max=1e-1, log_scale=True, grid_points=3),
    dict(name="layers", type="int", min=1, max=6, grid_points=4),
    dict(name="opt", type="categorical", values=("sgd", "adam", "lamb")),
    dict(name="dropout", type="double", min=0.0, max=0.5, grid_points=2),
]
TEMPLATE = {
    "replicas": 1,
    "command": ["python", "train.py"],
    "args": ["--lr", "${trialParameters.lr}", "--layers=${trialParameters.layers}"],
    "env": [{"name": "OPT", "value": "${trialParameters.opt}"}],
    "tpu": {"chipsPerWorker": 1},
}
SPECS = {
    "random": dict(algorithm="random", seed=3, max_trials=9, parallelism=3),
    "grid": dict(algorithm="grid", max_trials=100, parallelism=4),
    "bayesian": dict(algorithm="bayesian", seed=11, max_trials=14, startup_trials=4,
                     gamma=0.3, parallelism=2, goal="maximize"),
    "halving": dict(algorithm="halving", seed=5, max_trials=9, eta=3, min_budget=1.0,
                    max_budget=9.0, parallelism=4),
}


def _spec(mod, algorithm):
    kw = dict(SPECS[algorithm])
    params = PARAMS if algorithm != "halving" else PARAMS[:3]
    return mod.StudySpec(
        parameters=tuple(mod.ParameterSpec(**p) for p in params),
        objective_metric="score", trial_template=TEMPLATE,
        early_stopping={"minSteps": 2, "minPeers": 2} if algorithm == "random" else {},
        **kw)


@pytest.mark.parametrize("algorithm", sorted(SPECS))
def test_spec_round_trips_equal_jax(algorithm):
    j, t = _spec(jstudy, algorithm), _spec(tstudy, algorithm)
    assert t.to_dict() == j.to_dict()
    assert tstudy.StudySpec.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert jstudy.StudySpec.from_dict(t.to_dict()).to_dict() == t.to_dict()
    assert t.total_trials() == j.total_trials()
    for pj, pt in zip(j.parameters, t.parameters):
        assert pt.to_dict() == pj.to_dict()
        assert tstudy.ParameterSpec.from_dict(pj.to_dict()) == pt
        assert pt.grid() == pj.grid()


def _score(rng, assignment):
    # A deterministic noisy objective of the assignment.
    base = sum(zlib.crc32(repr(v).encode()) % 97 for v in assignment.values())
    return base / 97 + rng.random()


def _drive(mod, algorithm, seed):
    """Suggest, then settle the suggested trials in a seeded order with
    seeded scores, states and occasional deletions, until the spec says
    done; returns every (index, assignment) and `done` flag it gave."""
    spec = _spec(mod, algorithm)
    rng = random.Random(seed)
    records: dict[int, object] = {}
    floor = -1
    log = []
    for _ in range(200):
        active = [r for r in records.values() if not r.terminal]
        new, done = spec.suggest(sorted(records.values(), key=lambda r: r.index),
                                 slots=spec.parallelism - len(active), floor=floor)
        log.append((new, done))
        for index, assignment in new:
            records[index] = mod.TrialRecord(index, "Running", dict(assignment))
            floor = max(floor, index)
        running = sorted(i for i, r in records.items() if not r.terminal)
        if done and not new and not running:
            break
        if not running:
            continue
        idx = running[rng.randrange(len(running))]
        roll = rng.random()
        rec = records[idx]
        if roll < 0.08:
            del records[idx]  # a deleted trial: its index stays spent
            continue
        state = "Failed" if roll < 0.15 else "Pruned" if roll < 0.2 else "Succeeded"
        objective = None if state == "Failed" else _score(rng, rec.assignment)
        records[idx] = mod.TrialRecord(idx, state, rec.assignment, objective)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algorithm", sorted(SPECS))
def test_suggestions_equal_jax(algorithm, seed):
    got = _drive(tstudy, algorithm, seed)
    want = _drive(jstudy, algorithm, seed)
    assert len(got) > 2
    assert got == want


@pytest.mark.parametrize("algorithm", ["random", "grid", "bayesian"])
def test_assignment_for_and_tpe_equal_jax(algorithm):
    j, t = _spec(jstudy, algorithm), _spec(tstudy, algorithm)
    for i in range(j.total_trials()):
        assert t.assignment_for(i) == j.assignment_for(i)
    rng = random.Random(4)
    for p_j, p_t in zip(j.parameters, t.parameters):
        good = [p_j.sample(rng) for _ in range(5)]
        bad = [p_j.sample(rng) for _ in range(9)] + ["junk", math.nan, None]
        for k in range(3):
            assert (p_t.tpe_sample(good, bad, random.Random(k))
                    == p_j.tpe_sample(good, bad, random.Random(k)))


def test_should_prune_equal_jax():
    j, t = _spec(jstudy, "random"), _spec(tstudy, "random")
    rng = random.Random(9)
    for _ in range(200):
        curve = sorted((s, rng.random()) for s in rng.sample(range(8), rng.randrange(1, 5)))
        peers = [sorted((s, rng.random()) for s in rng.sample(range(8), rng.randrange(0, 5)))
                 for _ in range(rng.randrange(0, 4))]
        assert t.should_prune(curve, peers) == j.should_prune(curve, peers)


def test_render_template_equal_jax():
    for assignment in (
        {"lr": 0.1, "layers": 3, "opt": "adam"},
        {"lr": 1e-4 * 3.7, "layers": 6, "opt": "sgd", "unused": 2.5},
    ):
        assert (tstudy.render_template(TEMPLATE, assignment)
                == jstudy.render_template(TEMPLATE, assignment))
    with pytest.raises(ValueError, match="unresolved"):
        tstudy.render_template(TEMPLATE, {"lr": 0.1})
    with pytest.raises(ValueError, match="unresolved"):
        jstudy.render_template(TEMPLATE, {"lr": 0.1})


@pytest.mark.parametrize("bad", [
    dict(parameters=()),
    dict(goal="sideways"),
    dict(algorithm="annealing"),
    dict(algorithm="bayesian", gamma=1.5),
    dict(algorithm="halving", eta=1),
    dict(early_stopping={"minSteps": 0}),
])
def test_validation_refuses_what_jax_refuses(bad):
    kw = dict(parameters=(None,), trial_template=TEMPLATE)
    kw.update(bad)
    for mod in (jstudy, tstudy):
        params = kw["parameters"]
        if params == (None,):
            params = (mod.ParameterSpec("lr", min=0.1, max=1.0),)
        with pytest.raises(ValueError) as err:
            mod.StudySpec(**{**kw, "parameters": params}).validate()
        if mod is jstudy:
            want = str(err.value)
        else:
            assert str(err.value) == want
