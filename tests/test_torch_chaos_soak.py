"""The chaos soak on the port's control plane: the Notebook and TpuJob
controllers converging through the port's `ChaosProxy` under every
fault class.

JAX's tier-1 soak (tests/e2e/test_chaos_soak_e2e.py
`test_chaos_soak_converges`: `faults_per_class=2`, 3 notebooks and 2
quota-metered notebooks, 2 gangs) on the port's store, facade, client
and controllers:

    FakeApiServer (quota admission)
        └─ ApiServerApp, HTTP/1.1 keep-alive, streaming and long-poll watch
            └─ ChaosProxy (the seeded FaultSchedule)
                └─ HttpApiClient (retries, breakers, stream degrade)
                    └─ Notebook + TpuJob controllers (threaded manager)

with its three gates: CONVERGENCE (every notebook has exactly its
StatefulSet, Service and VirtualService at the last churned image, every
gang exactly its workers, the quota its cap and status.used), ZERO
DUPLICATE SIDE EFFECTS (no object live twice, replayed GangCreated events
collapsed onto one, no watch delivery of a mutable object) and COVERAGE
(every fault class fired, the schedule exhausted). The port's plan for
the seed is held to JAX's. JAX's lock-graph witness (`testing/lockgraph`,
not ported) is left out, as is its compiled-store backend. The whole
soak runs under a 60 s limit, where JAX's churn alone may take 120 s.
"""

import os
import threading
import time
from collections import Counter

import pytest

from kubeflow_tpu.testing.chaos import FaultSchedule as JFaultSchedule
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.tpujob import KIND as TPUJOB_KIND
from kubeflow_tpu_torch.api.tpujob import make_tpujob
from kubeflow_tpu_torch.controllers import quota
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.controllers.runtime import ControllerManager
from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB, TpuJobController
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.chaos import FAULT_CLASSES, ChaosProxy, FaultSchedule
from kubeflow_tpu_torch.testing.fake_apiserver import Conflict, FakeApiServer, Invalid
from kubeflow_tpu_torch.web.wsgi import serve

# JAX's default seed; KFTPU_CHAOS_SEED reruns another schedule.
DEFAULT_SEED = 20260804
# The whole test's wall limit, seconds.
LIMIT_S = 60.0


class _SideEffectLedger:
    """ADDED/DELETED per object key straight off the store's watch: a key
    with `adds - dels > 1` at any moment was live twice."""

    def __init__(self):
        self.adds = Counter()
        self.dels = Counter()
        self.violations: list[tuple] = []
        self.mutable_deliveries: list[tuple] = []
        self._lock = threading.Lock()

    def __call__(self, event: str, obj) -> None:
        key = (obj.kind, obj.metadata.namespace, obj.metadata.name)
        with self._lock:
            if not getattr(obj, "frozen", False):
                self.mutable_deliveries.append((event, key))
            if event == "ADDED":
                self.adds[key] += 1
                if self.adds[key] - self.dels[key] > 1:
                    self.violations.append(key)
            elif event == "DELETED":
                self.dels[key] += 1


def _poll(pred, timeout, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def test_chaos_soak_converges():
    t0 = time.monotonic()
    seed = int(os.environ.get("KFTPU_CHAOS_SEED") or DEFAULT_SEED)
    repro = f"[chaos seed={seed}; reproduce with KFTPU_CHAOS_SEED={seed}]"
    n_notebooks, n_jobs = 3, 2
    schedule = FaultSchedule(seed, faults_per_class=2)
    assert FaultSchedule(seed, faults_per_class=2).plan == schedule.plan, repro
    assert [(f.cls, f.param, f.gap) for f in schedule.plan] == [
        (f.cls, f.param, f.gap) for f in JFaultSchedule(seed, faults_per_class=2).plan], repro

    api = FakeApiServer()
    quota.register(api)
    ledger = _SideEffectLedger()
    api.watch(ledger)
    app = ApiServerApp(api)
    # Short stream lifetimes, so the soak cycles enough stream requests
    # to consume every stream-class fault inside its deadline.
    app.STREAM_DURATION = 6.0
    app.STREAM_SLICE = 0.3
    server, _ = serve(app, host="127.0.0.1", port=0)
    proxy = ChaosProxy("127.0.0.1", server.server_port, schedule).start()
    client = HttpApiClient(proxy.base_url, timeout=5.0, watch_poll_timeout=1.0,
                           watch_retry=0.05, retry_base=0.02, breaker_threshold=4,
                           breaker_cooldown=0.3, stream_failure_threshold=2,
                           stream_degraded_seconds=0.5)
    nb_ctl = NotebookController(client)
    job_ctl = TpuJobController(client, quota_retry_seconds=1.0)
    manager = ControllerManager()
    manager.add(nb_ctl.controller)
    manager.add(job_ctl.controller)
    manager.start()

    nb_names = [("default", f"soak-nb-{i}") for i in range(n_notebooks)]
    nb_names += [("team-a", "quota-nb-0"), ("team-a", "quota-nb-1")]
    job_names = [f"soak-job-{i}" for i in range(n_jobs)]
    try:
        # The user side writes straight to the store; the faults target
        # the controllers' client.
        api.create(new_resource("Namespace", "team-a", ""))
        api.create(new_resource("ResourceQuota", quota.QUOTA_NAME, "team-a",
                                spec={"hard": {"count/notebooks": 2}}))
        for ns, name in nb_names:
            api.create(new_resource("Notebook", name, ns, spec={"image": "nb:v0"}))
        with pytest.raises(Invalid):
            api.create(new_resource("Notebook", "quota-nb-overflow", "team-a",
                                    spec={"image": "nb:v0"}))
        for name in job_names:
            api.create(make_tpujob(name, replicas=2, tpu_chips_per_worker=0,
                                   command=("sleep", "60")))

        # Churn until the schedule is exhausted.
        churn_deadline = t0 + LIMIT_S * 0.6
        i = 0
        while not schedule.exhausted:
            assert time.monotonic() < churn_deadline, \
                f"fault schedule not exhausted before the deadline: {schedule} {repro}"
            i += 1
            ns, name = nb_names[i % len(nb_names)]
            try:
                nb = api.get("Notebook", name, ns).thaw()
                nb.spec["image"] = f"nb:v{i}"
                api.update(nb)
            except (Conflict, Invalid):
                pass  # racing the controllers is the point
            time.sleep(0.25)

        final_images = {(ns, name): api.get("Notebook", name, ns).spec["image"]
                        for ns, name in nb_names}

        def converged() -> bool:
            for ns, name in nb_names:
                for kind, child in (("StatefulSet", name), ("Service", name),
                                    ("VirtualService", f"notebook-{ns}-{name}")):
                    try:
                        api.get(kind, child, ns)
                    except Exception:
                        return False
                sts = api.get("StatefulSet", name, ns)
                if sts.spec["template"]["spec"]["containers"][0]["image"] != \
                        final_images[(ns, name)]:
                    return False
            for name in job_names:
                job = api.get(TPUJOB_KIND, name, "default")
                pods = api.list("Pod", "default", label_selector={LABEL_JOB: name})
                if len(pods) != 2 or job.status.get("phase") != "Pending":
                    return False
            rq = api.get("ResourceQuota", quota.QUOTA_NAME, "team-a")
            return rq.status.get("used", {}).get("count/notebooks") == 2

        remaining = t0 + LIMIT_S - time.monotonic() - 2.0
        assert _poll(converged, timeout=max(1.0, remaining)), (
            f"fleet did not converge {repro}; breakers={client.breaker_state()} "
            f"retries={client.retries_total} watch={client.watch_stats()}")
    finally:
        manager.stop()
        client.close()
        proxy.stop()
        server.shutdown()
        server.server_close()

    coverage = schedule.coverage()
    assert schedule.exhausted and all(coverage[c] >= 1 for c in FAULT_CLASSES), \
        f"incomplete fault coverage: {coverage} {repro}"
    assert ledger.violations == [], f"an object identity was live twice: " \
        f"{ledger.violations} {repro}"
    assert ledger.mutable_deliveries == [], ledger.mutable_deliveries[:5]
    for ns in ("default", "team-a"):
        nbs = {n for s, n in nb_names if s == ns}
        for kind, expected in (("StatefulSet", nbs),
                               ("VirtualService", {f"notebook-{ns}-{n}" for n in nbs})):
            got = {o.metadata.name for o in api.list(kind, ns)}
            assert got == expected, (kind, ns, got, repro)
    for name in job_names:
        pods = api.list("Pod", "default", label_selector={LABEL_JOB: name})
        indexes = sorted(p.metadata.labels.get("kubeflow-tpu.org/worker-index") for p in pods)
        assert indexes == ["0", "1"], (name, indexes, repro)
        gang_created = [e for e in api.list("Event", "default")
                        if e.spec.get("reason") == "GangCreated"
                        and e.spec.get("involvedObject", {}).get("name") == name]
        assert len(gang_created) == 1, (name, gang_created, repro)
    assert time.monotonic() - t0 < LIMIT_S, f"the soak took {time.monotonic() - t0:.1f} s"
    print(f"chaos soak converged in {time.monotonic() - t0:.1f} s: coverage={coverage} "
          f"retries={client.retries_total} watch={client.watch_stats()} {repro}")


TINY_LM = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 2, "head_dim": 16,
           "d_ff": 64, "batch": 2, "seq": 32, "dtype": "float32", "lr": 1e-3}


def test_lm_job_through_the_chaos_proxy(tmp_path, monkeypatch):
    """chip_smoke's chaos_job on the CPU at a tiny LM: the facade process
    behind the proxy (seed 0, two faults a class), the binary, the pod
    runner and the worker all on the proxy. Every control-plane gate of
    `testing/chaos_job.checks` holds, the worker's steps are acked once
    each from one process, and its losses are finite."""
    import json
    import math

    from kubeflow_tpu_torch.testing import chaos_job

    steps = 4
    for key, value in (("KFTPU_DEVICE", "cpu"), ("OMP_NUM_THREADS", "1"),
                       ("MKL_NUM_THREADS", "1")):
        monkeypatch.setenv(key, value)
    rec = chaos_job.run_chaos_job(
        str(tmp_path), steps=steps, gpus=1, timeout=120.0,
        job_env={"KFTPU_CKPT_DIR": str(tmp_path / "ckpt"), "KFTPU_TOTAL_STEPS": str(steps),
                 "KFTPU_SAVE_EVERY": str(steps), "KFTPU_LM_SIZE": json.dumps(TINY_LM)})
    failed = [k for k, ok in chaos_job.checks(rec, steps).items() if not ok]
    assert not failed, (failed, rec["coverage"], rec["binary_client"], rec["diagnostics"])
    records = [json.loads(line) for line in rec["logs"].splitlines() if line.startswith("{")]
    steps_seen = [r for r in records if r["event"] == "step"]
    assert [r["step"] for r in steps_seen] == list(range(1, steps + 1))
    assert all(math.isfinite(r["loss"]) for r in steps_seen)
    assert len({r["pid"] for r in records}) == 1
    metrics = {p["step"]: p["loss"] for p in rec["job_status"]["metrics"]}
    assert metrics == {r["step"]: r["loss"] for r in steps_seen}
    assert rec["seconds"]["total"] < 100.0, rec["seconds"]
