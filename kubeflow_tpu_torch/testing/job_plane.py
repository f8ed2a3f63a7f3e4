"""The job plane on one host: store, facade, controller managers, kubelet.

`JobPlane` stands up what a TpuJob or a Study needs to run end to end
on one machine, as the JAX package's e2e soaks do:

- an in-process `FakeApiServer` with the TpuJob admission hook and
  ResourceQuota admission (`controllers/quota.register`; a namespace
  without a ResourceQuota is unmetered), durable in `persist_dir` when
  one is given (its WAL and snapshot, `testing/persist.py`; `close`
  checkpoints it), served over HTTP by `ApiServerApp` on a free
  localhost port;
- controller-manager processes (`Manager`), each waited on until it
  prints its marker: the binary (``python -m kubeflow_tpu_torch.controllers
  --apiserver <facade> --controllers ...``, with ``--leader-elect`` or
  without), or the `testing/workers/preempt_ha.py` replica, which can
  stall mid-preemption; the first is started by the constructor unless
  `controllers` is empty;
- a `LocalPodRunner` in this process, stepped by `run_until`, that execs
  each pod (every pod gets ``KFTPU_APISERVER``, the facade's URL), and
  beside it the `WorkloadMaterializer` (`runtime/workloads.py`), which
  turns StatefulSets and Deployments (a Notebook's, a Tensorboard's)
  into pods born Running, which the runner never execs;
  `run_pods=False` leaves pods unrun and workloads unmaterialized, as
  the JAX HA tests do;
- `add_node` and `set_quota`, the cluster model's Nodes and a tenant's
  ResourceQuota, and `lose_node`, a host's failure;
- `plane_reports()`: each manager's last ``plane {json}`` line, its
  compiled tier (work-queue backends, gang placements by scheduler
  backend), every line read once the manager is stopped or killed.

With `ha_state_dir` the control plane is an active-passive pair
instead (`testing/failover.py`): two facade processes
(`testing/workers/apiserver.py`, "facade-a" and "facade-b", started
together; the first to take the lease serves) over one durable store
in that directory, each on its own localhost port, over
https with a CA minted into ``<ha_state_dir>/tls``, the apiserver lease
3 s (renew deadline 2 s) as in the JAX package's facade worker.
`api` is then an `HttpApiClient` on the endpoint list (the active's
first), which the pod runner, the managers (``--apiserver a,b --ca``)
and, through the pod env, every worker use as well; `url` is the
comma-joined list and `endpoints` the facades' URLs in their order.
`kill_active_facade()` SIGKILLs the facade serving now and returns when
the signal went out; `active_facade()` names it. While no facade serves,
`run_until` treats a refused or failed call as a tick that saw nothing.

With `chaos_state_dir` the store is one facade process
(`testing/workers/apiserver.py`, "facade", durable in that directory,
over plain http, which the proxy must read: an explicit opt-in) behind a
`ChaosProxy` that injects `chaos_schedule`'s faults, in this process.
`url` is the proxy's: the managers, the pod runner (`api`, an
`HttpApiClient` with `CHAOS_CLIENT`'s settings, the chaos soak's) and,
through the pod env, every worker reach the store only through it.
`observer` is a client on the facade itself, which no fault touches,
for the caller's reads and checks. The facade's stream lives
`CHAOS_STREAM_TIMING[0]` s and bookmarks every `[1]` s, so a short run
meets enough stream requests to consume every stream fault of its
plan. `run_pods=False` with `start_pods()` later starts the runner and
the materializer when the caller chooses. Under faults `run_until`
treats any failed call as a tick that saw nothing.

Every wait has a deadline and fails loudly with `diagnostics()`: each
manager's and facade's output stamped with seconds since the plane
started, the leadership timeline (which replica led, stood by, evicted
and was deposed, and which facade took the apiserver lease over, when)
and the pod logs. A wait that times out adds `stall_report()`: every
live manager's thread stacks and client counters (it dumps them on
SIGUSR1), this process's threads, the requests the facade served and
the store's objects, so a plane that stalled names where. `close` reaps the pods, the managers and the facades
on every exit path (use it as a context manager); a facade pair stops
gracefully, so the active checkpoints its store and releases the lease.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers import quota
from kubeflow_tpu_torch.controllers.tpujob import register_admission
from kubeflow_tpu_torch.runtime.local import LocalPodRunner
from kubeflow_tpu_torch.runtime.workloads import WorkloadMaterializer
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import ApiError, FakeApiServer, Unavailable
from kubeflow_tpu_torch.web.wsgi import serve

ROOT = Path(__file__).resolve().parents[2]
# The markers a leader-elected replica prints, in the timeline.
LEADERSHIP_MARKERS = ("standby ", "leading ", "evicted ", "deposed ")
# A facade's takeover lines, in the timeline too.
FACADE_MARKERS = LEADERSHIP_MARKERS + ("takeover ", "apiserver ready ")
# What a call meets while no facade of a pair serves.
OUTAGE_ERRORS = (Unavailable, http.client.HTTPException, OSError)
# The chaos mode's pod-runner client (the chaos soak's settings) and the
# facade's stream lifetime and bookmark cadence, seconds.
CHAOS_CLIENT = dict(timeout=5.0, watch_poll_timeout=1.0, watch_retry=0.05, retry_base=0.02,
                    breaker_threshold=4, breaker_cooldown=0.3, stream_failure_threshold=2,
                    stream_degraded_seconds=0.5)
CHAOS_STREAM_TIMING = (2.0, 0.2)
# The kinds whose objects a stall report lists.
STALL_KINDS = ("Study", "Workflow", "TpuJob", "Pod", "Event")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Manager:
    """One controller-manager process: its output lines, each with the
    wall-clock time it arrived, marker waits, stop and kill. A manager
    stopped or killed through these methods is expected to have exited;
    any other exit fails `JobPlane.run_until`."""

    def __init__(self, name: str, argv: list[str], env: dict[str, str]):
        self.name = name
        self.lines: list[tuple[float, str]] = []
        self.expect_exit = False
        self._cv = threading.Condition()
        self.proc = subprocess.Popen(argv, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, name=f"manager-{name}",
                                        daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append((time.time(), line.rstrip("\n")))
                self._cv.notify_all()

    def line_time(self, prefix: str) -> float | None:
        """When the first line starting with `prefix` arrived, or None."""
        with self._cv:
            return next((t for t, line in self.lines if line.startswith(prefix)), None)

    def wait_for(self, prefix: str, timeout: float) -> float:
        """Block until a line starts with `prefix`; returns its arrival
        time. Raises if the process exits first or after `timeout`."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                t = next((t for t, line in self.lines if line.startswith(prefix)), None)
                if t is not None:
                    return t
                if self.proc.poll() is not None:
                    raise RuntimeError(f"manager {self.name} exited {self.proc.returncode} "
                                       f"before printing {prefix!r}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"manager {self.name}: no {prefix!r} line in "
                                       f"{timeout} s")
                self._cv.wait(min(remaining, 0.1))

    def signal(self, sig: int) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, sig)

    def kill(self) -> float:
        """SIGKILL, the death without warning; returns when it was sent."""
        self.expect_exit = True
        t = time.time()
        self.signal(signal.SIGKILL)
        self.proc.wait(timeout=10)
        self._reader.join(timeout=5)
        return t

    def stop(self, timeout: float = 30.0) -> int:
        """SIGTERM (after SIGCONT, in case it was stopped) and wait;
        returns the exit code, SIGKILLing it after `timeout`."""
        self.expect_exit = True
        self.signal(signal.SIGCONT)
        self.signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=5)  # every line it printed, read
        return self.proc.returncode

    def plane(self) -> dict | None:
        """Its last ``plane {json}`` line (the compiled tier's report:
        each controller's work-queue backend and gang placements by
        scheduler backend, `controllers.runtime.plane_report`), or None."""
        with self._cv:
            last = next((line for _, line in reversed(self.lines)
                         if line.startswith("plane ")), None)
        return json.loads(last[len("plane "):]) if last is not None else None


class JobPlane:
    def __init__(
        self,
        *,
        controllers: tuple[str, ...] = ("tpujob", "study"),
        extra_env: dict[str, str] | None = None,
        capture_dir: str | None = None,
        ready_timeout: float = 120.0,
        run_pods: bool = True,
        ha_state_dir: str | None = None,
        persist_dir: str | None = None,
        chaos_state_dir: str | None = None,
        chaos_schedule=None,
    ):
        self.started = time.time()
        self.managers: list[Manager] = []
        self.facades: list[Manager] = []
        self.manager_ready_s: float | None = None
        self.runner: LocalPodRunner | None = None
        self.materializer: WorkloadMaterializer | None = None
        self.capture_dir = capture_dir
        self.ha_state_dir = ha_state_dir
        self.server = None
        self.proxy = None
        self.observer: HttpApiClient | None = None
        self.ca: str | None = None
        self.tls_tool: str | None = None
        self._outage_errors: tuple = ()
        self._pod_env = pod_env = dict(extra_env or {})
        try:
            if chaos_state_dir is not None:
                self._start_chaos(chaos_state_dir, chaos_schedule, ready_timeout)
                pod_env.setdefault("KFTPU_APISERVER", self.url)
            elif ha_state_dir is None:
                self.api = FakeApiServer(persist_dir=persist_dir)
                register_admission(self.api)
                quota.register(self.api)
                self.server, _ = serve(ApiServerApp(self.api), host="127.0.0.1", port=0)
                self.url = f"http://127.0.0.1:{self.server.server_port}"
                pod_env.setdefault("KFTPU_APISERVER", self.url)
            else:
                self._start_facades(ready_timeout)
            if controllers:
                t0 = time.monotonic()
                self.start_manager(controllers, timeout=ready_timeout)
                # Process start to "manager ready".
                self.manager_ready_s = time.monotonic() - t0
            if run_pods:
                self.start_pods()
        except BaseException:
            self.close()
            raise

    def start_pods(self) -> None:
        """Start the pod runner and the workload materializer on `api`."""
        self.runner = LocalPodRunner(self.api, cwd=str(ROOT), extra_env=self._pod_env,
                                     capture_dir=self.capture_dir)
        self.materializer = WorkloadMaterializer(self.api)

    # -- the facade behind a fault-injecting proxy ----------------------------

    def _start_chaos(self, state_dir: str, schedule, timeout: float) -> None:
        from kubeflow_tpu_torch.testing.chaos import ChaosProxy

        port = _free_port()
        duration, slice_s = CHAOS_STREAM_TIMING
        env = {"KFTPU_STATE_DIR": state_dir, "KFTPU_PORT": str(port), "KFTPU_PLAINTEXT": "1",
               "KFTPU_STREAM_DURATION": str(duration), "KFTPU_STREAM_SLICE": str(slice_s)}
        argv = [sys.executable, "-m", "kubeflow_tpu_torch.testing.workers.apiserver"]
        facade = Manager("facade", argv, self._env(env))
        self.facades.append(facade)
        try:
            facade.wait_for("apiserver ready", timeout)
        except (RuntimeError, TimeoutError) as e:
            raise RuntimeError(f"{e}\n{self.diagnostics()}") from None
        self.facade_url = f"http://127.0.0.1:{port}"
        self.observer = HttpApiClient(self.facade_url)
        self.proxy = ChaosProxy("127.0.0.1", port, schedule).start()
        self.url = self.proxy.base_url
        self.api = HttpApiClient(self.url, **CHAOS_CLIENT)
        self._outage_errors = OUTAGE_ERRORS + (ApiError,)

    # -- the facade pair ----------------------------------------------------

    def _start_facades(self, timeout: float) -> None:
        from kubeflow_tpu_torch.web import tls

        # Minted here, before either facade boots: the clients pin it and
        # both facades serve it.
        self.tls_tool = tls.mint_tool()
        self.ca = tls.ensure_tls_dir(os.path.join(self.ha_state_dir, "tls")).ca_cert
        env = {"KFTPU_STATE_DIR": self.ha_state_dir}
        self.endpoints = []
        # Both start at once (each takes seconds to import); the first to
        # take the lease is the active.
        argv = [sys.executable, "-m", "kubeflow_tpu_torch.testing.workers.apiserver"]
        for identity in ("facade-a", "facade-b"):
            port = _free_port()
            self.endpoints.append(f"https://127.0.0.1:{port}")
            self.facades.append(Manager(identity, argv, self._env(
                {**env, "KFTPU_PORT": str(port), "KFTPU_HA_IDENTITY": identity})))
        deadline = time.monotonic() + timeout
        try:
            for facade in self.facades:
                facade.wait_for(f"standby {facade.name}", deadline - time.monotonic())
            while self.active_facade() is None:
                dead = [f for f in self.facades if f.proc.poll() is not None]
                if dead:
                    raise RuntimeError(f"facade {dead[0].name} exited {dead[0].proc.returncode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no facade took the apiserver lease in {timeout} s")
                time.sleep(0.05)
        except (RuntimeError, TimeoutError) as e:
            raise RuntimeError(f"{e}\n{self.diagnostics()}") from None
        # Clients start at the first endpoint of their list: name the
        # active first, so a client's one failover is the takeover's.
        active = self.active_facade()
        listed = sorted(self.endpoints,
                        key=lambda url: self.facades[self.endpoints.index(url)] is not active)
        self.url = ",".join(listed)
        self.api = HttpApiClient(listed, ca=self.ca)
        self._outage_errors = OUTAGE_ERRORS

    def active_facade(self) -> Manager | None:
        """The live facade whose last lease line is ``leading``, if any."""
        latest = None
        for facade in self.facades:
            if facade.proc.poll() is not None:
                continue
            t = facade.line_time(f"leading {facade.name}")
            if t is not None and (latest is None or t > latest[0]):
                latest = (t, facade)
        return latest[1] if latest else None

    def kill_active_facade(self) -> float:
        """SIGKILL the facade serving now; returns when the signal went out."""
        facade = self.active_facade()
        if facade is None:
            raise RuntimeError(f"no facade is serving\n{self.diagnostics()}")
        return facade.kill()

    # -- managers ---------------------------------------------------------

    def _env(self, extra: dict[str, str] | None = None) -> dict[str, str]:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.update(extra or {})
        return env

    def _spawn(self, name: str, argv: list[str], env: dict[str, str], marker: str,
               timeout: float) -> Manager:
        manager = Manager(name, argv, env)
        self.managers.append(manager)
        try:
            manager.wait_for(marker, timeout)
        except (RuntimeError, TimeoutError) as e:
            raise RuntimeError(f"{e}\n{self.diagnostics()}") from None
        return manager

    def start_manager(
        self,
        controllers: tuple[str, ...] = ("tpujob",),
        *,
        extra_args: tuple[str, ...] = (),
        leader_elect: bool = False,
        identity: str | None = None,
        lease_name: str = "controller-manager",
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        wait_for: str | None = None,
        timeout: float = 120.0,
    ) -> Manager:
        """Start the controller-manager binary (`extra_args` appended to its
        argv) and wait for `wait_for` (default: ``manager ready``, or
        ``standby <identity>`` with `leader_elect`)."""
        argv = [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver",
                self.url, "--controllers", ",".join(controllers), *extra_args]
        if self.ca:
            argv += ["--ca", self.ca]
        name = identity or f"manager-{len(self.managers)}"
        if leader_elect:
            argv += ["--leader-elect", "--identity", name, "--lease-name", lease_name,
                     "--lease-duration", str(lease_duration),
                     "--renew-deadline", str(renew_deadline),
                     "--retry-period", str(retry_period)]
        marker = wait_for or (f"standby {name}" if leader_elect else "manager ready")
        return self._spawn(name, argv, self._env(), marker, timeout)

    def start_preempt_ha(
        self,
        identity: str,
        *,
        lease_name: str = "tpujob-controller",
        lease_duration: float = 3.0,
        renew_deadline: float = 2.0,
        stall: float = 0.0,
        wait_for: str | None = None,
        timeout: float = 120.0,
    ) -> Manager:
        """Start a `testing/workers/preempt_ha.py` replica (the TpuJob
        operator alone, stalling `stall` s after a preemption's
        evictions) and wait for `wait_for` (default ``standby
        <identity>``)."""
        env = self._env({
            **({"KFTPU_CA": self.ca} if self.ca else {}),
            "KFTPU_APISERVER": self.url, "KFTPU_IDENTITY": identity,
            "KFTPU_LEASE_NAME": lease_name, "KFTPU_LEASE_DURATION": str(lease_duration),
            "KFTPU_RENEW_DEADLINE": str(renew_deadline), "KFTPU_PREEMPT_STALL": str(stall),
        })
        argv = [sys.executable, "-m", "kubeflow_tpu_torch.testing.workers.preempt_ha"]
        return self._spawn(identity, argv, env, wait_for or f"standby {identity}", timeout)

    @property
    def manager(self) -> Manager:
        """The first manager started."""
        return self.managers[0]

    @property
    def manager_output(self) -> list[str]:
        return [line for _, line in self.manager.lines]

    def plane_reports(self) -> dict[str, dict | None]:
        """Each manager's last ``plane`` line, by manager name."""
        return {m.name: m.plane() for m in self.managers}

    def stop_manager(self, timeout: float = 30.0) -> int:
        """SIGTERM the first manager and wait for it; returns its exit code."""
        return self.manager.stop(timeout)

    # -- the cluster model -----------------------------------------------

    def add_node(self, name: str, *, pool: str = "default", chips: int = 1, x: int = 0,
                 y: int = 0) -> None:
        """A Node of the cluster model: once one exists the TpuJob operator
        places every gang through its scheduler."""
        node = new_resource("Node", name, "", spec={"pool": pool, "chips": chips, "x": x,
                                                    "y": y})
        node.status = {"ready": True}
        self.api.create(node)

    def lose_node(self, name: str) -> list[str]:
        """A host failure: SIGKILL the runner's processes of the pods bound
        to Node `name`, then delete the Node; returns the killed pods'
        names. Call it between two `run_until` calls (between two runner
        steps), so that the runner never mirrors the kills' exits: the
        pods stay Running until the nodehealth controller fails them with
        reason NodeLost.

        The kill is what a lost host does to its processes. Without it the
        runner would SIGTERM a pod's process only once the operator
        deletes the pod, and the process's preemption save would race the
        restarted gang's restore: an artefact of running the cluster on
        one machine, not a host failure."""
        killed = []
        if self.runner is not None:
            for pod in self.api.list("Pod"):
                if pod.spec.get("nodeName") == name and self.runner.kill(
                        pod.metadata.namespace, pod.metadata.name):
                    killed.append(pod.metadata.name)
        self.api.delete("Node", name, "")
        return killed

    def set_quota(self, namespace: str, hard: dict) -> None:
        """The namespace's ResourceQuota (`quota.QUOTA_NAME`) with `hard` caps."""
        self.api.create(new_resource("ResourceQuota", quota.QUOTA_NAME, namespace,
                                     spec={"hard": dict(hard)}))

    # -- driving ------------------------------------------------------------

    def run_until(self, predicate, timeout: float, what: str, tick=None) -> float:
        """Step the pod runner and the materializer every 50 ms (calling
        `tick` too) until `predicate()` holds; returns the seconds it
        took. Raises with `diagnostics()` after `timeout`, or at once if a
        manager that was not stopped or killed exited."""
        t0 = time.monotonic()
        while True:
            try:
                if self.runner is not None:
                    self.runner.step()
                    self.materializer.step()
                if tick is not None:
                    tick()
                if predicate():
                    return time.monotonic() - t0
            except self._outage_errors:
                pass  # a pair between actives: the next tick asks again
            dead = [m for m in self.managers + self.facades
                    if not m.expect_exit and m.proc.poll() is not None]
            if dead:
                raise RuntimeError(
                    f"{dead[0].name} exited ({dead[0].proc.returncode}) while "
                    f"waiting for {what}\n{self.diagnostics()}")
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"timed out after {timeout} s waiting for {what}\n"
                                   f"{self.diagnostics()}\n{self.stall_report()}")
            time.sleep(0.05)

    def pod_logs(self) -> dict[str, str]:
        out = {}
        if self.capture_dir and os.path.isdir(self.capture_dir):
            for name in sorted(os.listdir(self.capture_dir)):
                with open(os.path.join(self.capture_dir, name), errors="replace") as f:
                    out[name] = f.read()
        return out

    def leadership(self) -> list[tuple[float, str]]:
        """Every manager's standby/leading/evicted/deposed line and every
        facade's lease and takeover lines, in time order, each with its
        seconds since the plane started."""
        return sorted(
            [(t - self.started, line) for m in self.managers for t, line in m.lines
             if line.startswith(LEADERSHIP_MARKERS)]
            + [(t - self.started, line) for f in self.facades for t, line in f.lines
               if line.startswith(FACADE_MARKERS)])

    def diagnostics(self, tail: int = 60) -> str:
        parts = ["--- leadership (s since the plane started) ---",
                 *(f"{t:9.3f} {line}" for t, line in self.leadership())]
        for kind, procs in (("facade", self.facades), ("manager", self.managers)):
            for m in procs:
                parts.append(f"--- {kind} {m.name} (exit {m.proc.poll()}) ---")
                parts += [f"{t - self.started:9.3f} {line}" for t, line in m.lines[-tail:]]
        for name, text in self.pod_logs().items():
            parts += [f"--- {name} ---", *text.splitlines()[-tail:]]
        return "\n".join(parts)

    def stall_report(self, wait: float = 3.0) -> str:
        """Where a stalled plane is stuck: each live manager's thread
        stacks and client counters (SIGUSR1; up to `wait` s for them to
        arrive), this process's threads, the requests the in-process
        facade served, and the store's objects of `STALL_KINDS`."""
        marks = {m.name: len(m.lines) for m in self.managers if m.proc.poll() is None}
        for m in self.managers:
            if m.name in marks:
                m.signal(signal.SIGUSR1)
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline and not all(
                any(line.startswith("client ") for _, line in m.lines[marks[m.name]:])
                for m in self.managers if m.name in marks):
            time.sleep(0.1)
        parts = []
        for m in self.managers:
            if m.name in marks:
                parts.append(f"--- manager {m.name} on SIGUSR1 ---")
                parts += [line for _, line in m.lines[marks[m.name]:]]
        parts.append("--- this process's threads ---")
        frames = sys._current_frames()
        for thread in threading.enumerate():
            frame = frames.get(thread.ident)
            if frame is not None:
                parts.append(f"thread {thread.name}:")
                parts += [ln.rstrip("\n") for ln in traceback.format_stack(frame)]
        if self.server is not None:
            parts.append(f"--- the facade served {self.server.requests_served} requests ---")
        parts.append("--- the store's objects ---")
        for kind in STALL_KINDS:
            try:
                objects = self.api.list(kind)
            except Exception as e:  # a stalled or absent store is a finding too
                parts.append(f"{kind}: list failed: {e!r}")
                continue
            for obj in objects:
                if kind == "Event":
                    detail = f"{obj.spec.get('reason')}: {obj.spec.get('message')}"
                else:
                    detail = f"{obj.status.get('phase')} restarts={obj.status.get('restarts', 0)}"
                parts.append(f"{kind} {obj.metadata.namespace}/{obj.metadata.name} {detail}")
        return "\n".join(parts)

    def close(self) -> None:
        if self.runner is not None:
            self.runner.shutdown()
        for m in self.managers:
            m.stop()
        if self.proxy is not None:
            self.proxy.stop()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        # Standbys first (they leave their acquire loop), then the active,
        # whose graceful stop checkpoints the store under the term it
        # still holds and releases the lease with nobody left to take it.
        active = self.active_facade()
        for facade in sorted(self.facades, key=lambda f: f is active):
            facade.stop()
        for client in (getattr(self, "api", None), self.observer):
            if client is not None:
                client.close()

    def __enter__(self) -> "JobPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
