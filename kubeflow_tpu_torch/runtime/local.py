"""Local pod runner: executes Pod resources as subprocesses.

Counterpart of `kubeflow_tpu/runtime/local.py` (a module with no JAX in
it): the kubelet the in-process API server lacks. It watches Pods,
launches each as a local process with the container's env injected,
mirrors the process's lifecycle onto the pod's status (Running →
Succeeded/Failed) and terminates processes whose pods are deleted.

With the TpuJob operator this closes the loop in one host: TpuJob CR →
operator creates a gang → runner execs N local processes → phases flow
back → operator marks the job Succeeded (or restarts the gang).

Pods are exec'd (`subprocess.Popen` of the container's command), never
forked from this process, so a worker never inherits a CUDA context.
Coordinator DNS names (``<pod>.<svc>.<ns>.svc``) don't resolve locally,
so the runner rewrites TPUJOB_COORDINATOR to ``localhost:<port>``, one
port per gang incarnation. With `capture_dir`, a pod's output goes to
``<capture_dir>/<pod>.log``; a restarted gang's pod APPENDS to its
predecessor's log, after a header line naming its incarnation (the JAX
runner truncates it), so the killed incarnation's output survives.

A process whose pod is deleted (a teardown, or a preemption's eviction)
gets SIGTERM and is untracked at once: its exit never becomes a pod
phase, since the pod is gone. The runner keeps each such process until
it has exited and records, in `evictions`, when the SIGTERM went out
and when the exit was seen (by `step`), with its exit code.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import threading
import time

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

log = logging.getLogger(__name__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class LocalPodRunner:
    def __init__(
        self,
        api: FakeApiServer,
        *,
        cwd: str | None = None,
        extra_env: dict[str, str] | None = None,
        capture_dir: str | None = None,
    ):
        self.api = api
        self.cwd = cwd
        self.extra_env = dict(extra_env or {})
        self.capture_dir = capture_dir
        self._procs: dict[tuple[str, str], subprocess.Popen] = {}
        # The uid of the pod each tracked process runs. Watch events
        # arrive on the store's dispatcher thread, late: a pod deleted
        # and created again under its name (a gang restart) may have its
        # new process started before the old pod's DELETED event lands.
        self._uids: dict[tuple[str, str], str] = {}
        self._job_ports: dict[str, int] = {}
        self._lock = threading.Lock()
        # Processes of deleted pods until they exit, and each deletion's
        # SIGTERM and exit times: (ns, name, uid) -> {"sigterm": t,
        # "exit": t | None, "returncode": rc | None}.
        self._terminating: dict[tuple[str, str, str], subprocess.Popen] = {}
        self.evictions: dict[tuple[str, str, str], dict] = {}
        api.watch(self._on_pod, "Pod")

    def _on_pod(self, event: str, pod: Resource) -> None:
        if event == "DELETED":
            with self._lock:
                slot = (pod.metadata.namespace, pod.metadata.name)
                if self._uids.get(slot) != pod.metadata.uid:
                    return  # not this pod's process (or none)
                proc = self._procs.pop(slot)
                del self._uids[slot]
                if proc.poll() is not None:
                    return
                key = (pod.metadata.namespace, pod.metadata.name, pod.metadata.uid)
                self._terminating[key] = proc
                self.evictions[key] = {"sigterm": time.time(), "exit": None,
                                       "returncode": None}
            proc.terminate()

    def _pod_env(self, pod: Resource) -> dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        for e in pod.spec["containers"][0].get("env", []):
            # Rendered trial templates may carry typed values; process env
            # must be strings.
            env[e["name"]] = str(e["value"])
        coord = env.get("TPUJOB_COORDINATOR")
        if coord:
            # One port per gang *incarnation*: a restarted gang must not
            # bind the port its terminating predecessor may still hold.
            labels = pod.metadata.labels
            gang = (
                labels.get("kubeflow-tpu.org/job", ""),
                labels.get("kubeflow-tpu.org/gang-incarnation", "0"),
            )
            with self._lock:
                port = self._job_ports.setdefault(gang, _free_port())
            env["TPUJOB_COORDINATOR"] = f"localhost:{port}"
        return env

    def step(self) -> None:
        """Start new pods, reap finished ones (and the processes of
        deleted pods). Call in a loop."""
        with self._lock:
            for key, proc in list(self._terminating.items()):
                if proc.poll() is not None:
                    del self._terminating[key]
                    self.evictions[key].update(exit=time.time(), returncode=proc.returncode)
        for pod in self.api.list("Pod"):
            key = (pod.metadata.namespace, pod.metadata.name)
            phase = pod.status.get("phase")
            with self._lock:
                proc = self._procs.get(key)
                if proc is not None and self._uids[key] != pod.metadata.uid:
                    # A deleted predecessor's process, until its DELETED
                    # event untracks it.
                    continue
            if proc is None and phase is None:
                self._start(pod, key)
            elif proc is not None and proc.poll() is not None:
                # Report the exit BEFORE untracking: if the status write
                # fails (apiserver outage), the process stays tracked and
                # the next step() retries — otherwise the exit is lost
                # and the pod reads Running forever.
                self._set_phase(
                    pod, "Succeeded" if proc.returncode == 0 else "Failed"
                )
                with self._lock:
                    self._procs.pop(key, None)
                    self._uids.pop(key, None)

    def _start(self, pod: Resource, key: tuple[str, str]) -> None:
        c = pod.spec["containers"][0]
        # argv must be strings; rendered trial templates may carry typed
        # parameter values (e.g. a float lr) in args.
        cmd = [
            str(x) for x in list(c.get("command", [])) + list(c.get("args", []))
        ]
        if not cmd:
            self._set_phase(pod, "Failed")
            return
        stdout = None
        log_path = None
        if self.capture_dir:
            os.makedirs(self.capture_dir, exist_ok=True)
            log_path = os.path.abspath(
                os.path.join(self.capture_dir, f"{pod.metadata.name}.log")
            )
            stdout = open(log_path, "a")
            incarnation = pod.metadata.labels.get("kubeflow-tpu.org/gang-incarnation", "0")
            stdout.write(f"--- pod {pod.metadata.name} incarnation {incarnation} ---\n")
            stdout.flush()
        log.info("starting pod %s: %s", pod.metadata.name, " ".join(cmd))
        try:
            proc = subprocess.Popen(
                cmd,
                env=self._pod_env(pod),
                cwd=self.cwd,
                stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None,
            )
        except OSError as e:
            log.error("pod %s failed to start: %s", pod.metadata.name, e)
            self._set_phase(pod, "Failed")
            return
        finally:
            # The child holds its own copy of the fd; keeping ours open
            # would leak one per pod start.
            if stdout is not None:
                stdout.close()
        with self._lock:
            self._procs[key] = proc
            self._uids[key] = pod.metadata.uid
        # One status write: Running phase plus (when capturing) where the
        # pod's stdout lands, so the apiserver facade can serve `kubectl
        # logs` (`/apis/Pod/<ns>/<name>/log`, the kubelet log-endpoint
        # analog). A separate logPath write would double the MODIFIED
        # events every watcher sees per pod start.
        try:
            fresh = self.api.get(
                "Pod", pod.metadata.name, pod.metadata.namespace
            )
        except NotFound:
            return
        fresh = fresh.thaw()
        changed = fresh.status.get("phase") != "Running"
        fresh.status["phase"] = "Running"
        if log_path and fresh.status.get("logPath") != log_path:
            fresh.status["logPath"] = log_path
            changed = True
        if changed:
            self.api.update_status(fresh)

    def _set_phase(self, pod: Resource, phase: str) -> None:
        try:
            fresh = self.api.get(
                "Pod", pod.metadata.name, pod.metadata.namespace
            )
        except NotFound:
            return
        if fresh.status.get("phase") != phase:
            fresh = fresh.thaw()
            fresh.status["phase"] = phase
            self.api.update_status(fresh)

    def running_count(self) -> int:
        with self._lock:
            return sum(1 for p in self._procs.values() if p.poll() is None)

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.values()) + list(self._terminating.values())
            self._procs.clear()
            self._uids.clear()
            self._terminating.clear()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
