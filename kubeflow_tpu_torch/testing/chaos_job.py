"""A training job through a faulty link to the apiserver, end to end.

`run_chaos_job` stands up a `JobPlane` in its chaos mode: the facade as
its own process over a state directory (plain http, so the proxy can
read it), a `ChaosProxy` in front of it running a seeded
`FaultSchedule` over the seven wire fault classes, and the
controller-manager binary (the tpujob and notebook controllers) on the
proxy. The pod runner and materializer, and through the pod env every
worker, reach the store only through the proxy too. The caller's own
reads (`JobPlane.observer`) and ``kftpu`` go straight to the facade.

1. An observer watch from resourceVersion 0 keeps a ledger of every
   object's ADDED and DELETED events.
2. The binary starts, its watch's stream breaker short; TpuJob `job`
   (the LM worker under the launcher, one GPU, `job_env`) is created and
   a Notebook is applied with ``kftpu apply`` as a v1alpha1 manifest.
3. Until the pods start, the binary is the one client streaming through
   the proxy, so the plan's first stream faults meet its watch: the
   flow waits until one is bound to the binary's stream, a long-poll
   request follows and then a stream request again.
4. The pod runner and materializer start; the job runs to its end and
   the Notebook to Ready; the Notebook is read back with ``kftpu get
   --api-version`` at every served version.
5. The Notebook is churned (an annotation a round) until every planned
   fault has taken effect; the binary is stopped with SIGTERM and its
   ``client`` and ``plane`` lines read.

With `nodes`, that many Nodes of `gpus` accelerators each are created
(through the observer) before the job, so its gang is placed by the
operator's scheduler.

Returns what it saw and timed (wall-clock seconds), for the caller to
hold to its checks; `checks(rec, steps)` gives the control-plane ones.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TPUJOB_COMMAND = ("-m", "kubeflow_tpu_torch.launcher", "--module",
                  "kubeflow_tpu_torch.testing.workers.lm_job:main")
VERSIONS = ("v1", "v1beta1", "v1alpha1")
# The Notebook applied at v1alpha1.
NOTEBOOK = {"apiVersion": "kubeflow-tpu.org/v1alpha1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": "default", "labels": {"app": "nb"}},
            "spec": {"containerImage": "kubeflow-tpu/torch-notebook:latest", "cpu": "1",
                     "memory": "2Gi", "env": {"A": "1", "B": "2"}}}
# The binary's client flags: one failed stream degrades its watch for
# 1 s. At the soak's threshold of 2 the seed-0 schedule never fails two
# of the binary's streams in a row (a stream that lives to its end comes
# between), and the watch never degrades.
BINARY_FLAGS = ("--write-retries", "3", "--breaker-cooldown", "0.3",
                "--stream-failure-threshold", "1", "--stream-degraded", "1.0",
                "--stream-reprobe", "60")


class Ledger:
    """ADDED/DELETED per object key off the observer's watch: a key with
    `adds - dels > 1` at any moment was live twice."""

    def __init__(self):
        self.adds = Counter()
        self.dels = Counter()
        self.violations: list[tuple] = []
        self._lock = threading.Lock()

    def __call__(self, event: str, obj) -> None:
        key = (obj.kind, obj.metadata.namespace, obj.metadata.name)
        with self._lock:
            if event == "ADDED":
                self.adds[key] += 1
                if self.adds[key] - self.dels[key] > 1:
                    self.violations.append(key)
            elif event == "DELETED":
                self.dels[key] += 1

    def added(self, kind: str) -> dict:
        with self._lock:
            return {k: n for k, n in self.adds.items() if k[0] == kind}


def _tapped_schedule(seed: int, faults_per_class: int):
    """A `FaultSchedule` that also records every request it is asked
    about: (time, method, query, the fault class bound or None)."""
    from kubeflow_tpu_torch.testing.chaos import FaultSchedule

    class Tapped(FaultSchedule):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.requests: list[tuple[float, str, str, str | None]] = []

        def next_fault(self, method, path, query):
            fault = super().next_fault(method, path, query)
            self.requests.append((time.time(), method, query, fault.cls if fault else None))
            return fault

    return Tapped(seed, faults_per_class=faults_per_class)


def _cli(url: str, *argv: str, stdin: str | None = None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.cli", "--server", url,
                           *argv], cwd=REPO, input=stdin, capture_output=True, text=True,
                          timeout=60)


def _degraded_and_back(schedule, since: float):
    """When a stream request was bound to a fault that severs it (a
    truncated stream or a 503), a long-poll request followed and a
    stream request after that; None until all three (request arrival
    times at the proxy)."""
    reqs = list(schedule.requests)
    stream = [(t, c) for t, m, q, c in reqs if t >= since and "stream=true" in q]
    bound = next((t for t, c in stream if c in ("truncate_stream", "error_5xx")), None)
    if bound is None:
        return None
    poll = next((t for t, m, q, c in reqs if t > bound and "watch=true" in q
                 and "stream=true" not in q), None)
    back = next((t for t, c in stream if poll is not None and t > poll), None)
    if back is None:
        return None
    return {"stream_fault_bound": bound, "long_poll": poll, "stream_again": back}


def run_chaos_job(root: str, *, job_env: dict, steps: int, seed: int = 0,
                  faults_per_class: int = 2, job: str = "lm-chaos", gpus: int = 1,
                  timeout: float = 300.0, ready_timeout: float = 120.0,
                  nodes: int = 0) -> dict:
    import yaml

    from kubeflow_tpu_torch.api import make_tpujob, new_resource
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
    from kubeflow_tpu_torch.testing.job_plane import JobPlane

    schedule = _tapped_schedule(seed, faults_per_class)
    rec: dict = {"seconds": {}, "schedule": schedule}
    sec = rec["seconds"]
    t0 = time.time()
    plane = JobPlane(controllers=(), capture_dir=os.path.join(root, "logs"), run_pods=False,
                     ready_timeout=ready_timeout, chaos_state_dir=os.path.join(root, "state"),
                     chaos_schedule=schedule)
    try:
        obs = plane.observer
        ledger = Ledger()
        obs.watch(ledger)
        sec["facade_and_proxy_ready"] = time.time() - t0
        t_manager = time.time()
        manager = plane.start_manager(("tpujob", "notebook"), extra_args=BINARY_FLAGS,
                                      timeout=ready_timeout)
        sec["binary_ready"] = time.time() - t_manager
        for i in range(nodes):  # the cluster model: the gang places on one
            node = new_resource("Node", f"node-{i}", "", spec={"pool": "default", "chips": gpus})
            node.status = {"ready": True}
            obs.create(node)

        t_create = time.time()
        obs.create(make_tpujob(job, replicas=1, tpu_chips_per_worker=gpus, max_restarts=1,
                               command=(sys.executable, *TPUJOB_COMMAND),
                               env=tuple(job_env.items())))
        t_apply = time.time()
        applied = _cli(plane.facade_url, "apply", "-f", "-", stdin=yaml.safe_dump(NOTEBOOK))
        rec["notebook_apply"] = (applied.returncode, applied.stdout, applied.stderr)

        marks = {}

        def degraded_and_back():
            marks.update(_degraded_and_back(schedule, t_manager) or {})
            return bool(marks)

        plane.run_until(degraded_and_back, 60.0,
                        "a stream fault on the binary's watch, a long-poll round and the "
                        "stream again")
        rec["binary_degraded_marks"] = {k: v - t_manager for k, v in marks.items()}
        plane.start_pods()
        sec["binary_alone"] = time.time() - t_manager

        seen: dict = {}

        def tick():
            if "running" not in seen and any(
                    p.status.get("phase") == "Running" for p in obs.list(
                        "Pod", "default", label_selector={LABEL_JOB: job})):
                seen["running"] = time.time()
            if "ready" not in seen and obs.get("Notebook", "nb").status.get(
                    "readyReplicas", 0) >= 1:
                seen["ready"] = time.time()

        plane.run_until(lambda: obs.get("TpuJob", job).status.get("phase")
                        in ("Succeeded", "Failed") and "ready" in seen, timeout,
                        f"TpuJob {job} to finish and Notebook nb to be ready", tick=tick)
        t_done = time.time()
        sec["job_wall"] = t_done - t_create
        sec["cr_to_pod_running"] = seen["running"] - t_create if "running" in seen else None
        sec["notebook_apply_to_ready"] = seen["ready"] - t_apply
        rec["t_running"] = seen.get("running")
        rec["job_status"] = dict(obs.get("TpuJob", job).status)
        rec["pods"] = [p.metadata.name for p in obs.list(
            "Pod", "default", label_selector={LABEL_JOB: job})]
        rec["notebook_stored_version"] = obs.get("Notebook", "nb").api_version
        rec["notebook_read_back"] = {}
        for version in VERSIONS:
            got = _cli(plane.facade_url, "get", "notebook", "nb", "-n", "default",
                       "--api-version", version, "-o", "json")
            rec["notebook_read_back"][version] = (
                got.returncode, json.loads(got.stdout) if got.returncode == 0 else got.stderr)
        nb_uid = obs.get("Notebook", "nb").metadata.uid
        rec["notebook_children"] = {
            kind: sorted(o.metadata.name for o in obs.list(kind, "default")
                         if any(r.get("uid") == nb_uid for r in o.metadata.owner_references))
            for kind in ("StatefulSet", "Service", "VirtualService")}

        # Churn until every planned fault has taken effect.
        t_churn, i = time.time(), 0

        def churn():
            nonlocal i
            time.sleep(0.2)
            i += 1
            nb = obs.get("Notebook", "nb").thaw()
            nb.metadata.annotations["kubeflow-tpu.org/churn"] = str(i)
            obs.update(nb)

        plane.run_until(lambda: schedule.exhausted, 120.0, "the fault schedule to be exhausted",
                        tick=churn)
        sec["churn_to_exhausted"] = time.time() - t_churn
        rec["churn_rounds"] = i
        rec["coverage"] = schedule.coverage()
        rec["exhausted"] = schedule.exhausted
        rec["runner_client"] = {"retries": plane.api.retries_total,
                                "watch": plane.api.watch_stats()}
        rec["binary_rc"] = manager.stop()
        rec["plane"] = manager.plane()
        rec["binary_client"] = json.loads(next(
            line for _, line in reversed(manager.lines)
            if line.startswith("client "))[len("client "):])
        time.sleep(0.5)  # the observer's watch catches up with the last writes
        rec["ledger_violations"] = list(ledger.violations)
        rec["job_pods_added"] = sum(n for (k, ns, name), n in ledger.added("Pod").items()
                                    if name.startswith(f"{job}-"))
        events = obs.list("Event")
        occurrences = Counter(
            (e.spec.get("involvedObject", {}).get("uid"), e.spec.get("reason"),
             e.spec.get("message")) for e in events)
        rec["events"] = len(events)
        rec["events_twice"] = [k for k, n in occurrences.items() if n > 1]
        rec["event_adds_twice"] = [k for k, n in ledger.added("Event").items() if n > 1]
        rec["logs"] = plane.pod_logs().get(f"{job}-worker-0.log", "")
        rec["diagnostics"] = plane.diagnostics()
    except BaseException:
        print(plane.diagnostics(), file=sys.stderr, flush=True)
        raise
    finally:
        plane.close()
    rec["seconds"]["total"] = time.time() - t0
    return rec


def checks(rec: dict, steps: int) -> dict:
    """The control plane's gates of a `run_chaos_job` record (the caller
    adds the worker's: losses, launches, processes)."""
    from kubeflow_tpu_torch.testing.chaos import FAULT_CLASSES

    status = rec["job_status"]
    watch = rec["binary_client"].get("watch", {})
    manifest = {k: NOTEBOOK[k] for k in ("apiVersion", "kind")}
    alpha = rec["notebook_read_back"]["v1alpha1"]
    return {
        "job_succeeded": status.get("phase") == "Succeeded",
        "restarts_0": status.get("restarts", 0) == 0,
        "one_pod": len(rec["pods"]) == 1 and rec["job_pods_added"] == 1,
        "acked_every_step": [p["step"] for p in status.get("metrics", [])]
        == list(range(1, steps + 1)),
        "notebook_applied": rec["notebook_apply"][0] == 0
        and "notebook/nb created" in rec["notebook_apply"][1],
        "notebook_stored_at_v1": rec["notebook_stored_version"] == "kubeflow-tpu.org/v1",
        "notebook_read_at_every_version": all(
            rc == 0 and body["apiVersion"] == f"kubeflow-tpu.org/{v}"
            for v, (rc, body) in rec["notebook_read_back"].items()),
        "notebook_v1alpha1_round_trip": alpha[0] == 0
        and {k: alpha[1][k] for k in manifest} == manifest
        and alpha[1]["spec"] == NOTEBOOK["spec"]
        and alpha[1]["metadata"]["labels"] == NOTEBOOK["metadata"]["labels"],
        "notebook_children_one_each": rec["notebook_children"] == {
            "StatefulSet": ["nb"], "Service": ["nb"], "VirtualService": ["notebook-default-nb"]},
        "every_class_fired": all(rec["coverage"].get(c, 0) >= 1 for c in FAULT_CLASSES),
        "schedule_exhausted": rec["exhausted"],
        "no_object_live_twice": rec["ledger_violations"] == [],
        "no_event_twice": rec["events_twice"] == [] and rec["event_adds_twice"] == [],
        "binary_long_polled_degraded": watch.get("longpoll_rounds_degraded", 0) >= 1,
        "binary_streamed_again": watch.get("streams_after_degraded", 0) >= 1,
        "binary_exit_0": rec["binary_rc"] == 0,
    }
