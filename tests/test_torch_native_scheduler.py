"""The port's gang scheduler (`kubeflow_tpu_torch/native/scheduler.py`:
the compiled `GangScheduler` over ``csrc/scheduler.cc`` and its Python
twin `PyGangScheduler`) against the JAX package's.

First JAX's own tests/test_native_scheduler.py runs on the port, its
imports pointed at the port's modules: placements, all-or-nothing, the
torus and the ring, and the operator placing through the compiled
scheduler (counted ``native``). Then the twin against JAX's twin (moved
here with the twin from ``controllers/gang.py``), and a property test:
scripts of `add_node`, `set_pool_topology`, `reserve`, `place_gang`,
`release_gang` and `remove_node` through JAX's compiled scheduler, the
port's and the port's twin give the same placements, ring costs,
`PlacementError`s and free accelerators.
"""

import random
import re
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubeflow_tpu.native.scheduler import GangScheduler as JGangScheduler
from kubeflow_tpu.native.scheduler import PlacementError as JPlacementError
from kubeflow_tpu.native.scheduler import PyGangScheduler as JPyGangScheduler
from kubeflow_tpu_torch.api import make_tpujob, new_resource
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.native.scheduler import (
    GangScheduler,
    PlacementError,
    PyGangScheduler,
    make_gang_scheduler,
)
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_native_scheduler")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_scheduler_test_is_collected():
    src = (REPO / "tests" / "test_native_scheduler.py").read_text()
    assert set(re.findall(r"^def (test_\w+)", src, re.M)) <= set(JAX_TESTS)


def test_the_operator_places_on_the_compiled_scheduler_or_the_named_twin():
    """`make_gang_scheduler()` is the default; a `scheduler_factory`
    names another, and each placement is counted by its backend."""
    assert isinstance(make_gang_scheduler(), GangScheduler)
    for factory, backend in ((None, "native"), (PyGangScheduler, "python"),
                             (lambda: _Wrapped(), "custom")):
        api = FakeApiServer()
        api.create(new_resource("Node", "n0", "", spec={"pool": "p", "chips": 2}))
        ctl = TpuJobController(api, scheduler_factory=factory)
        api.create(make_tpujob("j", replicas=1, tpu_chips_per_worker=2))
        ctl.controller.run_until_idle()
        assert api.get("Pod", "j-worker-0").spec["nodeName"] == "n0"
        counts = {b: ctl.gang_placements.value(backend=b)
                  for b in ("native", "python", "custom")}
        assert counts == {b: float(b == backend) for b in counts}, backend
        api.close()


class _Wrapped:
    """A caller's own scheduler: the compiled one behind a wrapper."""

    def __init__(self):
        self._inner = GangScheduler()

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("seed", range(6))
def test_gang_scheduler_equals_jax_twin(seed):
    rng = random.Random(seed)
    j, t = JPyGangScheduler(), PyGangScheduler()
    pools = ["4x4", "line", "flat"]
    for i in range(rng.randrange(4, 20)):
        pool = rng.choice(pools)
        kw = dict(x=rng.randrange(4), y=rng.randrange(4), chips=rng.choice([1, 2, 4, 8]))
        for s in (j, t):
            s.add_node(f"n{i}", pool, **kw)
    for s in (j, t):
        s.set_pool_topology("4x4", 4, 4)
    for g in range(12):
        args = (f"g{g}", rng.choice(pools), rng.randrange(1, 6), rng.choice([0, 1, 2, 4]))
        outcome = []
        for s, err in ((j, JPlacementError), (t, PlacementError)):
            try:
                outcome.append(s.place_gang(*args))
            except err as e:
                outcome.append(("refused", str(e)))
        assert outcome[1] == outcome[0], args
        if rng.random() < 0.3:
            victim = f"g{rng.randrange(g + 1)}"
            assert t.release_gang(victim) == j.release_gang(victim)
        assert [t.free_chips(p) for p in pools] == [j.free_chips(p) for p in pools]


# -- the property: three schedulers, one script -------------------------------

POOLS = ("4x4", "line", "flat")
NODES = [f"n{i}" for i in range(10)]

_op = st.one_of(
    st.tuples(st.just("add_node"), st.sampled_from(NODES), st.sampled_from(POOLS),
              st.integers(0, 4), st.integers(0, 3), st.sampled_from([0, 1, 2, 4, 8])),
    st.tuples(st.just("set_pool_topology"), st.sampled_from(POOLS), st.integers(0, 5),
              st.integers(0, 4)),
    st.tuples(st.just("reserve"), st.sampled_from(["r0", "r1", "g0"]), st.sampled_from(NODES),
              st.integers(0, 4)),
    st.tuples(st.just("place_gang"), st.sampled_from([f"g{i}" for i in range(6)]),
              st.sampled_from(POOLS), st.integers(0, 6), st.sampled_from([0, 1, 2, 4])),
    st.tuples(st.just("release_gang"), st.sampled_from(["r0", "r1"] + [f"g{i}" for i in range(6)])),
    st.tuples(st.just("remove_node"), st.sampled_from(NODES)),
)


def _apply(sched, errors, op):
    name, *args = op
    try:
        if name == "add_node":
            node, pool, x, y, chips = args
            return sched.add_node(node, pool, x=x, y=y, chips=chips)
        return getattr(sched, name)(*args)
    except errors as e:
        # The refusal, without the backend-specific wording of a
        # malformed call's code.
        return ("refused", re.sub(r"\(code -?\d+\) ", "", str(e)))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_op, min_size=1, max_size=40))
def test_three_schedulers_answer_one_script_alike(ops):
    jax_native = JGangScheduler()
    port_native, port_twin = GangScheduler(), PyGangScheduler()
    for op in ops:
        want = _apply(jax_native, JPlacementError, op)
        assert _apply(port_native, PlacementError, op) == want, op
        assert _apply(port_twin, PlacementError, op) == want, op
        free = [jax_native.free_chips(p) for p in POOLS]
        assert [port_native.free_chips(p) for p in POOLS] == free, op
        assert [port_twin.free_chips(p) for p in POOLS] == free, op


def test_the_binary_reports_compiled_queues_and_placements(tmp_path):
    """The controller-manager binary on a job plane with one Node: its
    ``plane`` line at exit names every controller's work queue compiled
    and the gang's placement counted ``native``."""
    import sys

    from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
    from kubeflow_tpu_torch.testing.job_plane import JobPlane

    with JobPlane(controllers=("tpujob", "workflow"), capture_dir=str(tmp_path / "logs"),
                  extra_env={"OMP_NUM_THREADS": "1"}) as plane:
        plane.manager.wait_for("plane ", 30)  # printed just after "manager ready"
        ready = plane.manager.plane()
        assert ready == {"workqueue": {"tpujob-controller": "native",
                                       "workflow-controller": "native"},
                         "tpujob_gang_placements_total": {"native": 0, "python": 0,
                                                          "custom": 0}}
        plane.add_node("n0", chips=2)
        plane.api.create(make_tpujob("placed", replicas=2, tpu_chips_per_worker=1,
                                     command=(sys.executable, "-c", "print('hi')")))
        plane.run_until(
            lambda: plane.api.get("TpuJob", "placed").status.get("phase") == "Succeeded",
            60, "the placed gang to succeed")
        pods = plane.api.list("Pod", label_selector={LABEL_JOB: "placed"})
        assert [p.spec["nodeName"] for p in pods] == ["n0", "n0"]
        assert plane.stop_manager() == 0
        assert plane.plane_reports() == {"manager-0": {
            **ready, "tpujob_gang_placements_total": {"native": 1, "python": 0, "custom": 0}}}
