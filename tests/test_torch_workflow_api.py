"""The port's pipeline CRDs (`kubeflow_tpu_torch/api/workflow.py`,
`kubeflow_tpu_torch/api/cron.py`) against the JAX package's.

Exact equality throughout, on the same inputs: the same spec dicts parse
to the same `WorkflowSpec`/`StepSpec` (serialized back the same) or
raise `ValueError` with the same message; `_expand_with_items`,
`render_value`, `render_step` and `eval_when` agree on drawn steps,
parameters and outputs, outputs that hold ``==``, ``!=`` and ``${...}``
included; `CronSchedule.parse` agrees on drawn expressions (or both
refuse them) and `next_after` on drawn times, in UTC and across New
York's DST edges, where both also agree with a minute-by-minute scan;
`CronWorkflowSpec` parses and refuses alike.
"""

import os
import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubeflow_tpu.api import cron as jcron
from kubeflow_tpu.api import workflow as jwf
from kubeflow_tpu_torch.api import cron as tcron
from kubeflow_tpu_torch.api import workflow as twf

HYP = settings(max_examples=150, deadline=None, derandomize=True, database=None,
               suppress_health_check=[HealthCheck.too_slow])

ECHO = ["/bin/echo", "ok"]
JOB = {"replicas": 1, "image": "local", "command": ["python", "train.py"],
       "tpu": {"chipsPerWorker": 1}}

SPEC_DICTS = {
    "diamond": {"steps": [
        {"name": "a", "command": ECHO},
        {"name": "b", "command": ECHO, "dependencies": ["a"], "retries": 2},
        {"name": "c", "command": ECHO, "dependencies": ["a"]},
        {"name": "d", "command": ECHO, "dependencies": ["b", "c"]}],
        "onExit": {"name": "teardown", "command": ["rm", "-rf", "x"]},
        "artifactsDir": "/tmp/art", "parallelism": 2},
    "params_outputs_when": {
        "parameters": {"project": "kf-ci", "n": 3},
        "steps": [
            {"name": "probe", "command": ECHO,
             "env": [{"name": "P", "value": "${workflow.parameters.project}"}]},
            {"name": "fix", "command": ["fix", "${steps.probe.output}"],
             "dependencies": ["probe"], "when": "${steps.probe.output} != ok"}]},
    "with_items": {"steps": [
        {"name": "shard", "command": ["run", "${item}"], "withItems": ["a", "b", 3]},
        {"name": "join", "command": ["collect"], "dependencies": ["shard"]}]},
    "slice_step": {"parameters": {"steps": "8", "ckpt": "/c"}, "steps": [
        {"name": "train", "tpuJob": {**JOB, "env": [
            {"name": "KFTPU_TOTAL_STEPS", "value": "${workflow.parameters.steps}"},
            {"name": "KFTPU_CKPT_DIR", "value": "${workflow.parameters.ckpt}"}]}},
        {"name": "eval", "command": ["ev", "${steps.train.output}"],
         "dependencies": ["train"]},
        {"name": "serve", "command": ECHO, "dependencies": ["eval"],
         "when": "${steps.eval.output} == promote"}],
        "onExit": {"name": "teardown", "command": ["rm", "${workflow.parameters.ckpt}"]}},
    "slice_fanout": {"steps": [{"name": "sweep", "withItems": ["1e-3", "1e-4"],
                                "tpuJob": {**JOB, "args": ["--lr", "${item}"]}}]},
    "slice_untemplated": {"steps": [{"name": "train", "tpuJob": JOB}]},
    # Each of these is refused, by both, with the same message.
    "no_steps": {"steps": []},
    "cycle": {"steps": [{"name": "a", "command": ECHO, "dependencies": ["b"]},
                        {"name": "b", "command": ECHO, "dependencies": ["a"]}]},
    "unknown_dep": {"steps": [{"name": "a", "command": ECHO, "dependencies": ["x"]}]},
    "duplicate": {"steps": [{"name": "a", "command": ECHO}, {"name": "a", "command": ECHO}]},
    "no_command": {"steps": [{"name": "a"}]},
    "no_name": {"steps": [{"command": ECHO}]},
    "negative_retries": {"steps": [{"name": "a", "command": ECHO, "retries": -1}]},
    "parallelism_0": {"steps": [{"name": "a", "command": ECHO}], "parallelism": 0},
    "exit_collides": {"steps": [{"name": "a", "command": ECHO}],
                      "onExit": {"name": "a", "command": ECHO}},
    "exit_depends": {"steps": [{"name": "a", "command": ECHO}],
                     "onExit": {"name": "t", "command": ECHO, "dependencies": ["a"]}},
    "exit_fans_out": {"steps": [{"name": "a", "command": ECHO}],
                      "onExit": {"name": "t", "command": ECHO, "withItems": ["x"]}},
    "exit_conditional": {"steps": [{"name": "a", "command": ECHO}],
                         "onExit": {"name": "t", "command": ECHO, "when": "a == b"}},
    "undeclared_output": {"steps": [{"name": "a", "command": ECHO},
                                    {"name": "b", "command": ["x", "${steps.a.output}"]}]},
    "undeclared_when": {"steps": [{"name": "a", "command": ECHO},
                                  {"name": "b", "command": ECHO,
                                   "when": "${steps.a.output} == go"}]},
    "fanned_output": {"steps": [
        {"name": "s", "command": ["r", "${item}"], "withItems": ["a", "b"]},
        {"name": "j", "command": ["c", "${steps.s.output}"], "dependencies": ["s"]}]},
    "slice_and_command": {"steps": [{"name": "t", "command": ECHO, "tpuJob": JOB}]},
    "slice_and_env": {"steps": [{"name": "t", "env": [{"name": "A", "value": "1"}],
                                 "tpuJob": JOB}]},
    "slice_and_image": {"steps": [{"name": "t", "image": "custom:1", "tpuJob": JOB}]},
    "slice_replicas_0": {"steps": [{"name": "t", "tpuJob": {**JOB, "replicas": 0}}]},
    "slice_bad_field": {"steps": [{"name": "t", "tpuJob": {**JOB, "bogus": 1}}]},
}


def _parse(mod, d):
    try:
        return "ok", mod.WorkflowSpec.from_dict(d).to_dict()
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("case", sorted(SPEC_DICTS))
def test_workflow_spec_dicts_equal_jax(case):
    j, t = _parse(jwf, SPEC_DICTS[case]), _parse(twf, SPEC_DICTS[case])
    assert t == j
    if t[0] == "ok":
        # Each parses the other's serialization to the same spec.
        assert _parse(twf, j[1]) == _parse(jwf, t[1]) == j


@pytest.mark.parametrize("case", ["diamond", "slice_step", "with_items"])
def test_step_specs_and_lookups_equal_jax(case):
    j = jwf.WorkflowSpec.from_dict(SPEC_DICTS[case])
    t = twf.WorkflowSpec.from_dict(SPEC_DICTS[case])
    assert [dataclass_tuple(s) for s in t.steps] == [dataclass_tuple(s) for s in j.steps]
    for s in j.steps:
        assert dataclass_tuple(t.step(s.name)) == dataclass_tuple(s)
    with pytest.raises(KeyError):
        t.step("ghost")


def dataclass_tuple(step) -> tuple:
    return (step.name, step.command, step.args, step.image, step.env, step.dependencies,
            step.retries, step.with_items, step.when, step.tpu_job)


# -- templating, drawn ------------------------------------------------------

NAMES = st.sampled_from(["a", "b", "probe", "train", "x-1", "v.2"])
PARAM_REF = NAMES.map("${{workflow.parameters.{}}}".format)
OUTPUT_REF = NAMES.map("${{steps.{}.output}}".format)
LITERAL = st.sampled_from(["", " ", "ok", "promote", "==", "!=", "'q'", '"d"', "${",
                           "}", "$", "x == y", "a != b", "${item}", "${steps.}",
                           "${workflow.parameters.evil}", "0", "false", "False"])
TEXT = st.lists(st.one_of(PARAM_REF, OUTPUT_REF, LITERAL), max_size=5).map("".join)
VALUES = st.dictionaries(NAMES, TEXT, max_size=4)


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)


@HYP
@given(value=TEXT, params=VALUES, outputs=VALUES, partial=st.booleans())
def test_render_value_equals_jax(value, params, outputs, partial):
    assert (_outcome(twf.render_value, value, params, outputs, partial=partial)
            == _outcome(jwf.render_value, value, params, outputs, partial=partial))


@HYP
@given(lhs=TEXT, op=st.sampled_from([" == ", " != ", "==", "!=", ""]), rhs=TEXT,
       params=VALUES, outputs=VALUES)
def test_eval_when_equals_jax(lhs, op, rhs, params, outputs):
    expr = lhs + op + rhs
    assert (_outcome(twf.eval_when, expr, params, outputs)
            == _outcome(jwf.eval_when, expr, params, outputs))


def _step(mod, name, command, args, env, when, job):
    return mod.StepSpec(name=name, command=tuple(command), args=tuple(args),
                        env=tuple(env), when=when, tpu_job=job)


JOBS = st.one_of(st.none(), st.fixed_dictionaries({
    "replicas": st.integers(1, 4), "command": st.lists(TEXT, max_size=3),
    "env": st.lists(st.fixed_dictionaries({"name": NAMES, "value": TEXT}), max_size=2),
    "tpu": st.fixed_dictionaries({"chipsPerWorker": st.integers(0, 8)})}))


@HYP
@given(command=st.lists(TEXT, max_size=3), args=st.lists(TEXT, max_size=3),
       env=st.lists(st.tuples(NAMES, TEXT), max_size=3), when=TEXT, job=JOBS,
       params=VALUES, outputs=VALUES, partial=st.booleans())
def test_render_step_equals_jax(command, args, env, when, job, params, outputs, partial):
    j = _outcome(jwf.render_step, _step(jwf, "s", command, args, env, when, job), params,
                 outputs, partial=partial)
    t = _outcome(twf.render_step, _step(twf, "s", command, args, env, when, job), params,
                 outputs, partial=partial)
    assert t[0] == j[0]
    assert (dataclass_tuple(t[1]) == dataclass_tuple(j[1])) if t[0] == "ok" else t == j


@HYP
@given(steps=st.lists(st.tuples(st.lists(TEXT, max_size=2),
                                st.lists(st.sampled_from(["1", "two", "${item}x", "=="]),
                                         max_size=3),
                                st.lists(st.integers(0, 5), max_size=2), JOBS),
                      min_size=1, max_size=4))
def test_expand_with_items_equals_jax(steps):
    def build(mod):
        out = []
        for i, (command, items, deps, job) in enumerate(steps):
            out.append(mod.StepSpec(
                name=f"s{i}", command=tuple(command) if job is None else (),
                tpu_job=job, with_items=tuple(items),
                dependencies=tuple(f"s{d}" for d in deps if d < i)))
        return tuple(out)

    j_steps, j_fan = jwf._expand_with_items(build(jwf))
    t_steps, t_fan = twf._expand_with_items(build(twf))
    assert t_fan == j_fan
    assert [dataclass_tuple(s) for s in t_steps] == [dataclass_tuple(s) for s in j_steps]


# -- cron ---------------------------------------------------------------------

FIELD = st.one_of(
    st.just("*"), st.integers(1, 20).map("*/{}".format),
    st.integers(0, 31).map(str),
    st.tuples(st.integers(0, 31), st.integers(0, 31)).map("{0[0]}-{0[1]}".format),
    st.tuples(st.integers(0, 31), st.integers(0, 31), st.integers(1, 9)).map(
        "{0[0]}-{0[1]}/{0[2]}".format),
    st.lists(st.integers(0, 31).map(str), min_size=2, max_size=3).map(",".join),
    st.sampled_from(["a", "*/0", "1-", "-3", "61", "7", ""]))
EXPRS = st.lists(FIELD, min_size=4, max_size=6).map(" ".join)
T0 = 1_700_000_000.0


def _schedule(mod, expr):
    try:
        s = mod.CronSchedule.parse(expr)
    except ValueError as e:
        return "ValueError", str(e)
    return "ok", (s.minute, s.hour, s.dom, s.month, s.dow, s.dom_star, s.dow_star)


@HYP
@given(expr=EXPRS)
def test_cron_parse_equals_jax(expr):
    assert _schedule(tcron, expr) == _schedule(jcron, expr)


@pytest.fixture
def tz():
    """Set TZ for the test; restored after."""
    old = os.environ.get("TZ")

    def use(name):
        os.environ["TZ"] = name
        time.tzset()

    yield use
    if old is None:
        os.environ.pop("TZ", None)
    else:
        os.environ["TZ"] = old
    time.tzset()


VALID = st.tuples(
    st.sampled_from(["*", "0", "30", "*/15", "5,35", "0-10/5", "59"]),
    st.sampled_from(["*", "0", "1", "2", "3", "9-17", "*/6", "23"]),
    st.sampled_from(["*", "1", "15", "29", "31", "1,15", "*/10"]),
    st.sampled_from(["*", "2", "3", "11", "1,6", "*/4"]),
    st.sampled_from(["*", "0", "1", "7", "1-5", "0,6", "*/2"])).map(" ".join)


@pytest.mark.parametrize("zone", ["UTC", "America/New_York"])
def test_cron_next_after_equals_jax(tz, zone):
    tz(zone)

    @HYP
    @given(expr=VALID, offset=st.integers(0, 4 * 365 * 86400))
    def check(expr, offset):
        t = T0 + offset
        j = _outcome(jcron.CronSchedule.parse(expr).next_after, t)
        got = _outcome(tcron.CronSchedule.parse(expr).next_after, t)
        assert got == j
        if got[0] == "ok":
            assert tcron.CronSchedule.parse(expr).matches(got[1])

    check()


def _brute(schedule, t: float) -> float:
    base = int(t // 60) * 60
    return float(next(base + i * 60 for i in range(1, 200_000)
                      if schedule.matches(base + i * 60)))


@pytest.mark.parametrize("expr, start", [
    ("30 1 * * *", (2026, 10, 31, 23, 0)),   # fall back: the first 01:30
    ("30 2 * * *", (2026, 3, 7, 23, 0)),     # spring forward: 02:30 is skipped
    ("0,30 1 * * *", (2026, 11, 1, 1, 15)),  # inside the repeated hour
    ("*/20 2 * * *", (2026, 3, 8, 1, 50)),   # just before the skipped hour
    ("0 0 29 2 *", (2027, 12, 1, 0, 0)),     # sparse: the next leap day
    ("0 0 1,15 * 1", (2026, 6, 30, 12, 0)),  # Vixie OR of the day fields
])
def test_cron_dst_edges_equal_jax_and_a_minute_scan(tz, expr, start):
    tz("America/New_York")
    t = time.mktime((*start, 0, 0, 0, -1))
    want = _brute(jcron.CronSchedule.parse(expr), t)
    assert jcron.CronSchedule.parse(expr).next_after(t) == want
    assert tcron.CronSchedule.parse(expr).next_after(t) == want


def test_cron_unsatisfiable_refused_alike():
    for mod in (jcron, tcron):
        with pytest.raises(ValueError, match="no matching time"):
            mod.CronSchedule.parse("0 0 31 2 *").next_after(T0)


WF = {"steps": [{"name": "tick", "command": ECHO}]}


@pytest.mark.parametrize("d", [
    {"schedule": "* * * * *", "workflowSpec": WF},
    {"schedule": "0 3 * * 1-5", "workflowSpec": WF, "suspend": True,
     "concurrencyPolicy": "Forbid", "historyLimit": 0},
    {"schedule": "*/5 * * * *", "workflowSpec": WF, "concurrencyPolicy": "Replace"},
    {"schedule": "* * * *", "workflowSpec": WF},
    {"schedule": "* * * * *", "workflowSpec": {}},
    {"schedule": "* * * * *", "workflowSpec": WF, "concurrencyPolicy": "Sometimes"},
    {"schedule": "* * * * *", "workflowSpec": WF, "historyLimit": -1},
], ids=["every-minute", "weekdays-forbid", "replace", "four-fields", "no-steps",
        "bad-policy", "negative-history"])
def test_cron_workflow_spec_equals_jax(d):
    def parse(mod):
        return _outcome(lambda: mod.CronWorkflowSpec.from_dict(d).to_dict())

    assert parse(tcron) == parse(jcron)
