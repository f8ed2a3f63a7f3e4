"""Gang priority preemption in the port's TpuJob operator
(`kubeflow_tpu_torch/controllers/tpujob.py` `_preempt_for`) against the
JAX package's.

- JAX's own tests (tests/test_tpujob_priority.py: strictly lower
  priority only, no eviction unless a what-if placement succeeds,
  lowest priority and youngest first, victims back to Pending with their
  restart budget, the backoff, victims found by node overlap) run
  against the port.
- One seeded script of submissions, completions and deletions over two
  pools, at mixed priorities, replicas and accelerators per worker, goes
  through JAX's operator (handed its compiled `GangScheduler`) and the port's,
  each on its own store, with one fake clock for both operators'
  backoffs and retries. After every reconcile pass both give the same
  victims in the same order, the same phase and reason for every job and
  the same pods on the same nodes, exactly.
- `elasticMinReplicas > 0` is still refused, by admission and by
  reconcile, beside gangs whose priorities preempt.
"""

import random
import re
import threading
import time
import types
from pathlib import Path

import pytest

from kubeflow_tpu.api import make_tpujob as j_make_tpujob
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import runtime as j_runtime
from kubeflow_tpu.controllers import tpujob as j_tpujob
from kubeflow_tpu.native.scheduler import GangScheduler as JGangScheduler
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.api.tpujob import make_tpujob as t_make_tpujob
from kubeflow_tpu_torch.controllers import runtime as t_runtime
from kubeflow_tpu_torch.controllers import tpujob as t_tpujob
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, Invalid

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.` (the port's `testing` package
    exports nothing, so its store is named by module): its test
    functions by name."""
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items() if k.startswith("test_") and callable(v)}


JAX_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_tpujob_priority.py")


def test_all_of_jax_priority_tests_are_collected():
    assert len(JAX_TESTS) == 8


@pytest.mark.parametrize("name", sorted(JAX_TESTS))
def test_jax_priority_tests_on_the_port(name):
    JAX_TESTS[name]()


# -- one seeded script through both operators ----------------------------------

NODES = ([(f"t{i}", {"pool": "4x4", "x": i % 4, "y": i // 4, "chips": 4}) for i in range(4)]
         + [(f"l{i}", {"pool": "line", "x": i, "chips": 4}) for i in range(3)])


class Clock:
    """The operators' wall clock (`time.time()` in each module) and their
    work queues' clock, both moved by the script only: the 3 s backoff,
    the retries and every `requeue_after` (0.5 s after a preemption) come
    due on both sides at once, however long a drain takes."""

    def __init__(self):
        self.now = time.time()
        self.start = self.now
        self.mono_start = time.monotonic()

    def monotonic(self) -> float:
        return self.mono_start + (self.now - self.start)

    def module(self):
        return types.SimpleNamespace(time=lambda: self.now, monotonic=self.monotonic,
                                     sleep=time.sleep, perf_counter=time.perf_counter)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(j_tpujob, "time", c.module())
    monkeypatch.setattr(t_tpujob, "time", c.module())
    # JAX's Python work queue reads its module's `time.monotonic`.
    monkeypatch.setattr(j_runtime, "time", c.module())
    return c


class ScriptQueue:
    """A controller's work queue as the script drives it. A watch event
    reaches the queue from the store's dispatcher thread, and whether it
    lands while the reconcile that caused it is still in flight (the key
    marked dirty, re-added when it is done) or after (added in event
    order) depends on the threads' timing; the order of the next keys
    differs between the two, and with it which gang places first. Adds
    from any thread but the one driving the script wait here until that
    thread next asks for a key, so every event a reconcile causes lands
    after it is done, on both sides alike."""

    def __init__(self, inner):
        self._inner = inner
        self._held: list[tuple[str, float]] = []
        self._lock = threading.Lock()
        self._driver = threading.current_thread()

    def add(self, key: str, *, after: float = 0.0) -> None:
        if threading.current_thread() is self._driver:
            self._inner.add(key, after=after)
            return
        with self._lock:
            self._held.append((key, after))

    def _release(self) -> None:
        with self._lock:
            held, self._held = self._held, []
        for key, after in held:
            self._inner.add(key, after=after)

    def get(self, timeout: float = 0.0):
        self._release()
        return self._inner.get(timeout)

    def __len__(self) -> int:
        self._release()
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Pair:
    def __init__(self, clock: Clock):
        self.j_api, self.t_api = JFakeApiServer(), FakeApiServer()
        for name, spec in NODES:
            self.j_api.create(j_new_resource("Node", name, "", spec=dict(spec)))
            self.t_api.create(t_new_resource("Node", name, "", spec=dict(spec)))
        self.j_ctl = j_tpujob.TpuJobController(self.j_api, scheduler=JGangScheduler)
        self.t_ctl = t_tpujob.TpuJobController(self.t_api)
        # Both operators on work queues that read the script's clock (JAX's
        # may have built its native queue, which reads the real one) and
        # take watch events only between reconciles (`ScriptQueue`).
        assert not self.j_ctl.controller.has_pending() and not self.t_ctl.controller.has_pending()
        self.j_ctl.controller._queue = ScriptQueue(j_runtime._PyWorkQueue())
        self.t_ctl.controller._queue = ScriptQueue(t_runtime.PyWorkQueue(clock=clock.monotonic))

    def both(self, fn):
        fn(self.j_api, j_make_tpujob)
        fn(self.t_api, t_make_tpujob)

    def drain(self):
        self.j_ctl.controller.run_until_idle()
        self.t_ctl.controller.run_until_idle()

    def fire_timers(self):
        """What the timed requeues would do once due: every job again."""
        for api, ctl in ((self.j_api, self.j_ctl), (self.t_api, self.t_ctl)):
            for job in api.list("TpuJob"):
                ctl.controller.enqueue((job.metadata.namespace, job.metadata.name))

    def snapshot(self):
        def side(api):
            jobs = {j.metadata.name: (j.status.get("phase"), j.status.get("reason"),
                                      j.status.get("restarts", 0))
                    for j in api.list("TpuJob")}
            pods = sorted((p.metadata.name, p.spec.get("nodeName"), p.status.get("phase"))
                          for p in api.list("Pod"))
            events = sorted(api.list("Event"), key=lambda e: e.metadata.resource_version)
            # The victims in eviction order. The port's
            # PreemptedLowerPriority message names the victims, so a second
            # eviction by one preemptor is a second event where JAX's
            # repeats a message and lands on the first: the preemptors are
            # compared as a set.
            victims = [(e.spec["involvedObject"]["name"], e.spec["message"])
                       for e in events if e.spec["reason"] == "Preempted"]
            preemptors = {e.spec["involvedObject"]["name"] for e in events
                          if e.spec["reason"] == "PreemptedLowerPriority"}
            return {"jobs": jobs, "pods": pods, "victims": victims, "preemptors": preemptors}

        return side(self.j_api), side(self.t_api)


def _script(seed: int, steps: int):
    """(action, args) pairs: submit a job, finish one, delete one."""
    rng = random.Random(seed)
    out, n = [], 0
    for _ in range(steps):
        r = rng.random()
        if r < 0.75 or n < 4:
            n += 1
            out.append(("submit", dict(
                name=f"j{n:02d}", priority=rng.choice([0, 1, 2, 5, 9]),
                replicas=rng.choice([1, 1, 2, 3]), tpu_chips_per_worker=rng.choice([1, 2, 4]),
                topology=rng.choice(["4x4", "line", ""]), command=("true",))))
        elif r < 0.88:
            out.append(("finish", rng.random()))
        else:
            out.append(("delete", rng.random()))
    return out


def _pick(api, u: float, placed: bool):
    jobs = [j.metadata.name for j in api.list("TpuJob")
            if j.status.get("phase") not in ("Succeeded", "Failed")
            and (not placed or api.list("Pod", label_selector={
                t_tpujob.LABEL_JOB: j.metadata.name}))]
    return jobs[int(u * len(jobs))] if jobs else None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_script_same_victims_phases_and_reasons_as_jax(clock, seed):
    pair = Pair(clock)
    seen = {"victims": 0, "reasons": set(), "finished": 0, "deleted": 0}
    for action, arg in _script(seed, 44):
        if action == "submit":
            pair.both(lambda api, make: api.create(make(**arg)))
        else:
            name = _pick(pair.t_api, arg, placed=action == "finish")
            assert name == _pick(pair.j_api, arg, placed=action == "finish")
            if name is None:
                continue
            if action == "delete":
                pair.both(lambda api, _: api.delete("TpuJob", name))
                seen["deleted"] += 1
            else:
                def finish(api, _):
                    for p in api.list("Pod", label_selector={t_tpujob.LABEL_JOB: name}):
                        p = p.thaw()
                        p.status["phase"] = "Succeeded"
                        api.update_status(p)
                pair.both(finish)
                seen["finished"] += 1
        for rounds in range(4):
            if rounds:
                clock.now += 4.0  # past the 3 s backoff; retries come due
                pair.fire_timers()
            pair.drain()
            want, got = pair.snapshot()
            assert got == want, (seed, action, arg, rounds)
        seen["reasons"] |= {r for _, r, _ in got["jobs"].values()}
        seen["victims"] = len(got["victims"])
    # The script exercised what it is for.
    assert seen["victims"] >= 2, seen
    assert {"Unschedulable"} <= seen["reasons"], seen
    assert seen["finished"] and seen["deleted"], seen
    # Both operators place on their compiled schedulers, the same gangs.
    assert pair.t_ctl.gang_placements.value(backend="native") == \
        pair.j_ctl.gang_placements.value(backend="native") > 0
    assert pair.t_ctl.gang_placements.value(backend="python") == 0


def test_what_if_placements_are_not_counted():
    """Only real placements count in tpujob_gang_placements_total."""
    api = FakeApiServer()
    for i in range(2):
        api.create(t_new_resource("Node", f"n{i}", "", spec={"pool": "4x4", "chips": 4, "x": i}))
    ctl = t_tpujob.TpuJobController(api)
    api.create(t_make_tpujob("v1", priority=1, replicas=1, tpu_chips_per_worker=4,
                             topology="4x4", command=("true",)))
    api.create(t_make_tpujob("v2", priority=2, replicas=1, tpu_chips_per_worker=4,
                             topology="4x4", command=("true",)))
    ctl.controller.run_until_idle()
    assert ctl.gang_placements.value(backend="native") == 2
    api.create(t_make_tpujob("hi", priority=9, replicas=2, tpu_chips_per_worker=4,
                             topology="4x4", command=("true",)))
    # Two what-ifs (v1 alone, then v1 and v2), both victims evicted, and
    # the preemptor placed by its next pass: one more real placement.
    ctl.controller.run_until_idle()
    assert len(api.list("Pod", label_selector={t_tpujob.LABEL_JOB: "hi"})) == 2
    assert ctl.gang_placements.value(backend="native") == 3
    assert ctl.gang_placements.value(backend="python") == 0
    events = [e.spec for e in api.list("Event") if e.spec["reason"] == "PreemptedLowerPriority"]
    assert len(events) == 1 and events[0]["message"].endswith("default/v1, default/v2")


# -- what stays refused ---------------------------------------------------------


def test_elastic_gang_still_refused_beside_priority_preemption():
    api = FakeApiServer()
    t_tpujob.register_admission(api)
    api.create(t_new_resource("Node", "n0", "", spec={"pool": "4x4", "chips": 4}))
    ctl = t_tpujob.TpuJobController(api)
    elastic = t_make_tpujob("elastic", replicas=2, priority=1, command=("true",))
    elastic.spec["elasticMinReplicas"] = 1
    with pytest.raises(Invalid, match="elastic gang resize is not ported"):
        api.create(elastic)
    api.create(t_make_tpujob("low", priority=1, replicas=1, tpu_chips_per_worker=4,
                             topology="4x4", command=("true",)))
    ctl.controller.run_until_idle()
    api.create(t_make_tpujob("high", priority=5, replicas=1, tpu_chips_per_worker=4,
                             topology="4x4", command=("true",)))
    ctl.controller.run_until_idle()
    assert api.get("TpuJob", "low").status["reason"] in ("Preempted", "PreemptedBackoff")
    # A store without the admission: reconcile fails the elastic gang and
    # evicts nothing for it.
    bare = FakeApiServer()
    bare_ctl = t_tpujob.TpuJobController(bare)
    bare.create(t_new_resource("Node", "n0", "", spec={"pool": "4x4", "chips": 4}))
    bare.create(t_make_tpujob("low", priority=0, replicas=1, tpu_chips_per_worker=4,
                              topology="4x4", command=("true",)))
    bare_ctl.controller.run_until_idle()
    elastic.spec["tpu"] = {"chipsPerWorker": 4, "topology": "4x4", "numSlices": 1}
    bare.create(elastic)
    bare_ctl.controller.run_until_idle()
    assert bare.get("TpuJob", "elastic").status["phase"] == "Failed"
    assert bare.get("TpuJob", "low").status.get("reason") is None
    assert len(bare.list("Pod", label_selector={t_tpujob.LABEL_JOB: "low"})) == 1
    assert {e.spec["reason"] for e in bare.list("Event")} >= {"Unsupported"}
    assert "Preempted" not in {e.spec["reason"] for e in bare.list("Event")}
