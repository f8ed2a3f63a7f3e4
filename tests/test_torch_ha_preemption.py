"""Leader election against priority preemption in the port, on the CPU:
both variants of the JAX package's tests/e2e/test_ha_preemption_e2e.py
against the port's `testing/workers/preempt_ha.py` replicas.

The leader dies in the widest-damage window preemption has: the victims
evicted, their accelerators free, the preemptor not yet placed
(``KFTPU_PREEMPT_STALL`` holds it open). The same arithmetic as JAX's:
one pool of 4 nodes x 4 chips; a bystander (priority 1, 1 x 4 chips,
oldest) and a victim (priority 1, 2 x 4 chips, younger) leave 4 free; the
preemptor (priority 10, 3 x 4 chips) is unblocked by evicting the victim
alone (youngest first within a priority), so any touch of the
bystander is a double eviction, which its pods' uids would show.

- SIGKILL: the standby takes the Lease within the lease duration and
  places the preemptor with the victim set unchanged: the bystander's
  pods are the same pods, the victim stays evicted with restarts 0.
- SIGSTOP: the leader is paused in the window, the standby takes over
  and places; resumed, the stale leader's writes are fenced at the store
  and it exits 2, deposed, with the successor's placement untouched.

No pod runs (as in JAX's e2e, nothing execs them). Every wait on a
subprocess has its own timeout of at most 60 s.
"""

import os
import signal
import time

from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.tpujob import KIND
from kubeflow_tpu_torch.controllers.leader import LEASE_KIND
from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
from kubeflow_tpu_torch.testing.job_plane import JobPlane

LEASE_DURATION = 2.0
STALL = 6.0  # the evicted-but-not-placed window the leader dies inside


def _wait(pred, timeout=30.0, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _job(name, *, priority, replicas):
    return make_tpujob(name, replicas=replicas, tpu_chips_per_worker=4, command=("true",),
                       priority=priority)


def _pods(api, name):
    return api.list("Pod", "default", label_selector={LABEL_JOB: name})


def _plane():
    plane = JobPlane(controllers=(), run_pods=False)
    for i in range(4):
        plane.add_node(f"n{i}", chips=4, x=i)
    kw = dict(lease_duration=LEASE_DURATION, renew_deadline=LEASE_DURATION * 0.6, stall=STALL,
              timeout=60)
    a = plane.start_preempt_ha("preempt-a", wait_for="leading preempt-a", **kw)
    b = plane.start_preempt_ha("preempt-b", **kw)
    return plane, a, b


def _stage(plane, a) -> set:
    """Bystander and victim placed by the leader, then the preemptor: the
    leader evicts the victim and stalls before placing. Returns the
    bystander's pod uids."""
    api = plane.api
    api.create(_job("bystander", priority=1, replicas=1))
    assert _wait(lambda: len(_pods(api, "bystander")) == 1), plane.diagnostics()
    time.sleep(0.05)  # a strictly younger creation timestamp for the victim
    api.create(_job("victim", priority=1, replicas=2))
    assert _wait(lambda: len(_pods(api, "victim")) == 2), plane.diagnostics()
    bystander_uids = {p.metadata.uid for p in _pods(api, "bystander")}
    assert all(p.spec.get("nodeName") for p in _pods(api, "victim"))
    api.create(_job("preemptor", priority=10, replicas=3))
    a.wait_for("evicted preempt-a", timeout=30)
    assert _wait(lambda: len(_pods(api, "victim")) == 0), plane.diagnostics()
    assert len(_pods(api, "preemptor")) == 0, "placed before the window closed"
    return bystander_uids


def _assert_converged(plane, bystander_uids):
    api = plane.api
    assert _wait(lambda: len(_pods(api, "preemptor")) == 3, timeout=40), plane.diagnostics()
    assert all(p.spec.get("nodeName") for p in _pods(api, "preemptor"))
    assert {p.metadata.uid for p in _pods(api, "bystander")} == bystander_uids
    victim = api.get(KIND, "victim", "default")
    assert len(_pods(api, "victim")) == 0
    assert victim.status.get("restarts", 0) == 0, victim.status
    assert victim.status.get("phase") != "Failed", victim.status
    # One eviction, by one preemptor.
    preempted = [e.spec for e in api.list("Event", "default") if e.spec["reason"] == "Preempted"]
    assert [e["involvedObject"]["name"] for e in preempted] == ["victim"]
    lowered = [e.spec for e in api.list("Event", "default")
               if e.spec["reason"] == "PreemptedLowerPriority"]
    assert len(lowered) == 1 and lowered[0]["message"].endswith(": default/victim")


def test_sigkill_leader_mid_preemption_successor_places_no_double_eviction():
    plane, a, b = _plane()
    with plane:
        bystander_uids = _stage(plane, a)
        t_kill = a.kill()  # inside the window: no release, no warning
        t_lead = b.wait_for("leading preempt-b", timeout=LEASE_DURATION + 10)
        assert t_lead - t_kill < LEASE_DURATION + 5, plane.diagnostics()
        assert plane.api.get(LEASE_KIND, "tpujob-controller", "").spec[
            "leaseTransitions"] == 2
        _assert_converged(plane, bystander_uids)
        assert b.stop(timeout=30) == 0


def test_sigstop_leader_mid_preemption_late_writes_fenced():
    plane, a, b = _plane()
    with plane:
        bystander_uids = _stage(plane, a)
        a.signal(signal.SIGSTOP)  # the partition begins
        b.wait_for("leading preempt-b", timeout=LEASE_DURATION + 10)
        _assert_converged(plane, bystander_uids)
        preemptor_uids = {p.metadata.uid for p in _pods(plane.api, "preemptor")}
        rv = plane.api.current_rv
        # Resumed inside its preemption pass, the stale leader tries to
        # finish the term it lost: its writes are fenced, and its next
        # renewal sees the successor's generation: exit 2, deposed.
        a.expect_exit = True
        os.kill(a.proc.pid, signal.SIGCONT)
        assert a.proc.wait(timeout=30) == 2, plane.diagnostics()
        assert a.line_time("deposed preempt-a") is not None
        assert {p.metadata.uid for p in _pods(plane.api, "preemptor")} == preemptor_uids
        assert {p.metadata.uid for p in _pods(plane.api, "bystander")} == bystander_uids
        assert len(_pods(plane.api, "victim")) == 0
        # Nothing the deposed leader did after resuming reached the store:
        # every commit since is the successor's lease renewal or its own.
        later = [obj.kind for _, _, obj in plane.api.events_since(rv)[0]]
        assert set(later) <= {LEASE_KIND, KIND, "Event"}, later
        assert b.stop(timeout=30) == 0
