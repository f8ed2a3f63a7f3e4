"""The platform in a box as a child process, and its clients.

`Platform` starts ``python -m kubeflow_tpu_torch.apps`` (`apps/__main__.py`)
on five free consecutive ports, reads the admin token, the token file
and the CA from its output, and talks to it only through its entry
points: HTTP to the four web apps (`request`, as the header-authenticated
user), the apiserver facade over https (`client`, an `HttpApiClient`
with a bearer token) and the kubectl-style CLI as a subprocess
(`cli`, `cli_popen`: ``python -m kubeflow_tpu_torch.cli``). `stop`
sends SIGTERM and returns the exit code; `start` again on the same state
directory is a durable restart. The process's output goes to a log file
beside the state directory (`output`).

    with Platform(state_dir, user="p@example.com", admin="p@example.com") as p:
        p.start()
        status, body = p.request("dashboard", "POST", "/api/workgroup/create",
                                 {"namespace": "team-p"})
        p.cli("get", "profiles")
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

APPS = ("dashboard", "kfam", "jupyter", "tensorboards", "apiserver")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
USER_HEADER = "x-goog-authenticated-user-email"
# Requests to the apps go straight to localhost, never through a proxy
# the environment names.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def free_port_base(n: int = len(APPS), tries: int = 200) -> int:
    """A base port with `n` free consecutive ports above it on localhost."""
    rng = random.Random()
    for _ in range(tries):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} free consecutive ports found")


class _PortTaken(RuntimeError):
    """A boot failed to bind one of its ports."""


class Platform:
    """One platform process at a time over `state_dir` (see the module
    docstring). `env` adds to the child's environment (and so to every
    pod it runs); `nodes` is passed as ``--nodes`` when given."""

    def __init__(self, state_dir: str, *, user: str, admin: str | None = None,
                 nodes: int | None = None, env: dict | None = None,
                 ready_timeout: float = 120.0):
        self.state_dir = state_dir
        self.user = user
        self.admin = admin
        self.nodes = nodes
        self.env = {**os.environ, **(env or {})}
        self.ready_timeout = ready_timeout
        self.base = free_port_base()
        self.proc: subprocess.Popen | None = None
        self.boots = 0
        self.served = False  # a boot has served: the ports are fixed
        self.admin_token = self.token_file = self.ca = None
        self.log_path = None

    def url(self, app: str) -> str:
        scheme = "https" if app == "apiserver" else "http"
        return f"{scheme}://127.0.0.1:{self.base + APPS.index(app)}"

    # -- the process ------------------------------------------------------

    def start(self) -> float:
        """Boot and wait until every server listens; returns the seconds
        from the spawn to serving. A first boot that loses one of its
        ports to another process between the probe and the bind moves to
        other free ports (a restart keeps its ports: URLs in stored
        objects name them)."""
        for attempt in range(3):
            try:
                seconds = self._boot()
            except _PortTaken:
                if self.served or attempt == 2:
                    raise
                self.base = free_port_base()
                continue
            self.served = True
            return seconds
        raise AssertionError("unreachable")

    def _boot(self) -> float:
        if self.proc is not None:
            raise RuntimeError("the platform is already running")
        self.boots += 1
        self.log_path = f"{self.state_dir}.boot{self.boots}.log"
        argv = [sys.executable, "-m", "kubeflow_tpu_torch.apps", "--port-base", str(self.base),
                "--anonymous", self.user, "--state-dir", self.state_dir]
        if self.admin:
            argv += ["--admin", self.admin]
        if self.nodes is not None:
            argv += ["--nodes", str(self.nodes)]
        t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(argv, cwd=REPO, env=self.env, stdout=log,
                                         stderr=subprocess.STDOUT)
        deadline = time.monotonic() + self.ready_timeout
        while True:
            lines = self.output().splitlines()
            if any(line.startswith("apiserver: https://") for line in lines):
                break
            if self.proc.poll() is not None:
                code, self.proc = self.proc.returncode, None
                error = _PortTaken if "Address already in use" in self.output() \
                    else RuntimeError
                raise error(f"the platform exited {code} while booting:\n"
                            f"{self.output()[-4000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the platform did not serve within {self.ready_timeout}"
                                   f" s:\n{self.output()[-4000:]}")
            time.sleep(0.05)
        for line in lines:
            if line.startswith("apiserver admin token: "):
                self.admin_token = line.split(": ", 1)[1].strip()
            elif line.startswith("apiserver token file: "):
                self.token_file = line.split(": ", 1)[1].strip()
            elif line.startswith("apiserver CA (pin via --ca/KFTPU_CA): "):
                self.ca = line.split(": ", 1)[1].strip()
        return time.perf_counter() - t0

    def stop(self, timeout: float = 60.0) -> int:
        """SIGTERM, then wait; the exit code (SIGKILL past `timeout`)."""
        proc, self.proc = self.proc, None
        if proc is None:
            return 0
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise

    def output(self) -> str:
        if not self.log_path or not os.path.exists(self.log_path):
            return ""
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def planes(self) -> list[dict]:
        """The ``plane {json}`` lines of the current boot's output (the
        compiled tier's report the process prints at exit)."""
        return [json.loads(line[len("plane "):]) for line in self.output().splitlines()
                if line.startswith("plane ")]

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc = None

    def __enter__(self) -> "Platform":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- its entry points ---------------------------------------------------

    def request(self, app: str, method: str, path: str, body=None,
                timeout: float = 30.0, user: str | None = None) -> tuple[int, object]:
        """One HTTP request to a web app as the platform's user (or
        `user`): the status and the parsed JSON body."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.url(app) + path, data=data, method=method,
                                     headers={"Content-Type": "application/json",
                                              USER_HEADER: user or self.user})
        try:
            with _OPENER.open(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    def client(self, token: str | None = None):
        """An `HttpApiClient` on the facade (the admin's token by default)."""
        from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient

        return HttpApiClient(self.url("apiserver"), token=token or self.admin_token,
                             ca=self.ca)

    def cli_argv(self, *argv: str, token: str | None = None) -> list[str]:
        return [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--server",
                self.url("apiserver"), "--ca", self.ca, "--token",
                token or self.admin_token, *argv]

    def cli(self, *argv: str, token: str | None = None, stdin: str | None = None,
            timeout: float = 60.0) -> subprocess.CompletedProcess:
        """``kftpu <argv>`` as a subprocess (the admin's token by default)."""
        return subprocess.run(self.cli_argv(*argv, token=token), cwd=REPO, env=self.env,
                              input=stdin, capture_output=True, text=True, timeout=timeout)

    def cli_popen(self, *argv: str, token: str | None = None) -> subprocess.Popen:
        """A long-running ``kftpu`` (``get -w``): stdout a text pipe."""
        return subprocess.Popen(self.cli_argv(*argv, token=token), cwd=REPO, env=self.env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# -- the whole flow -----------------------------------------------------------------

TPUJOB_COMMAND = ("-m", "kubeflow_tpu_torch.launcher", "--module",
                  "kubeflow_tpu_torch.testing.workers.lm_job:main")
FACADE_ENV = ("KFTPU_APISERVER", "KFTPU_CA", "KFTPU_TOKEN")
# A user bound by RBAC alone, whom no mesh rule admits.
OUTSIDER = "mallory@example.com"


def _wait(predicate, timeout: float, what: str, poll: float = 0.1) -> float:
    """Seconds until `predicate()` holds; raises after `timeout`."""
    t0 = time.perf_counter()
    while True:
        if predicate():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: not within {timeout} s")
        time.sleep(poll)


def _env_of(pod) -> dict:
    return {e["name"]: e.get("value") for e in pod.spec["containers"][0].get("env", [])}


def parse_traces(text: str) -> list[dict]:
    """`kftpu traces` lines as {trace, name, attributes}."""
    spans = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 3 or not parts[1].endswith("ms"):
            continue
        attrs = dict(p.split("=", 1) for p in parts[3:] if "=" in p)
        spans.append({"trace": parts[0], "name": parts[2], "attributes": attrs})
    return spans


def run_flow(state_dir: str, *, user: str, job_env: dict, env: dict | None = None,
             nodes: int | None = None, namespace: str = "team-p", job: str = "lm-platform",
             gpus: int = 1, timeout: float = 600.0) -> dict:
    """The platform in a box end to end, through its entry points only:

    1. boot (a team-p service-account token written to the token file
       first, as a static ``--token-auth-file`` entry);
    2. the dashboard's workgroup create to the Profile's Ready, the
       owner's binding, kfam's edit binding for that service account;
       then the mesh gate: an outsider given an edit RoleBinding in the
       namespace directly (no kfam, so no AuthorizationPolicy rule)
       lists its notebooks through the Jupyter app, beside the owner;
    3. `kftpu apply` of a PodDefault selecting every pod of the
       namespace (a TpuJob's pods carry no label of their CR) with the
       facade's env: its URL, the CA and the service-account token;
    4. the Jupyter app's notebook POST with that PodDefault among its
       configurations, to ready, its pod's env, a PATCH that stops it;
    5. `kftpu apply` of TpuJob `job` (the LM worker under the launcher,
       `gpus` GPUs, `job_env`), followed by `kftpu get tpujobs -w` to
       Succeeded, then `describe`, `logs --job` and `top`;
    6. the dashboard's workloads and activities;
    7. `kftpu traces`;
    8. SIGTERM, exit code, the process's ``plane`` line (its work-queue
       backends and gang placements), a boot on the same state
       directory: the admin token, the job and the notebook;
    9. the dashboard's nuke-self to the Profile and Namespace gone, the
       service-account token before and after, the admin's; SIGTERM and
       the second boot's ``plane`` line.

    Returns what it saw and timed (seconds on the host's clock); the
    caller holds it to its checks."""
    from kubeflow_tpu_torch.api import make_tpujob, new_resource
    from kubeflow_tpu_torch.api.rbac import EDIT_ROLE
    from kubeflow_tpu_torch.api.tokens import TokenRegistry, service_account
    from kubeflow_tpu_torch.testing.fake_apiserver import Forbidden, NotFound
    import yaml

    sa = service_account(namespace, "default-editor")
    os.makedirs(state_dir, mode=0o700, exist_ok=True)
    static = TokenRegistry()
    sa_token = static.issue(sa)
    static.save(os.path.join(state_dir, "tokens"))
    rec: dict = {"seconds": {}, "user": user, "service_account": sa}
    sec = rec["seconds"]
    p = Platform(state_dir, user=user, admin=user, nodes=nodes, env=env)
    try:
        # 1. Boot.
        sec["boot_to_serving"] = p.start()
        admin_token = p.admin_token
        rec["credentials_printed"] = all((p.admin_token, p.token_file, p.ca))
        api = p.client()

        # 2. A workgroup.
        t0 = time.perf_counter()
        rec["workgroup_create"] = p.request("dashboard", "POST", "/api/workgroup/create",
                                            {"namespace": namespace})

        def profile_condition():
            try:
                return api.get("Profile", namespace, "default").status.get("condition")
            except NotFound:
                return None

        _wait(lambda: profile_condition() == "Ready", timeout, "Profile Ready")
        sec["workgroup_create_to_profile_ready"] = time.perf_counter() - t0
        owner = api.get("RoleBinding", "namespaceAdmin", namespace)
        rec["owner_binding"] = [s.get("name") for s in owner.spec.get("subjects", [])]
        rec["env_info"] = p.request("dashboard", "GET", "/api/workgroup/env-info")
        rec["kfam_binding"] = p.request("kfam", "POST", "/kfam/v1/bindings", {
            "user": {"kind": "ServiceAccount", "name": sa}, "referredNamespace": namespace,
            "roleRef": {"kind": "ClusterRole", "name": "edit"}})
        rec["kfam_bindings"] = p.request("kfam", "GET", f"/kfam/v1/bindings?namespace={namespace}")
        # RBAC without a mesh rule: the namespace's policies admit the
        # owner and kfam's contributors only, so the second gate refuses.
        api.create(new_resource("RoleBinding", "outsider-edit", namespace, spec={
            "roleRef": {"kind": "ClusterRole", "name": EDIT_ROLE},
            "subjects": [{"kind": "User", "name": OUTSIDER}]}))
        notebooks = f"/api/namespaces/{namespace}/notebooks"
        rec["mesh_outsider"] = p.request("jupyter", "GET", notebooks, user=OUTSIDER)
        rec["mesh_owner"] = p.request("jupyter", "GET", notebooks)

        # 3. A PodDefault with the facade's env.
        facade_env = {"KFTPU_APISERVER": p.url("apiserver"), "KFTPU_CA": p.ca,
                      "KFTPU_TOKEN": sa_token}
        poddefault = {"apiVersion": "kubeflow-tpu.org/v1", "kind": "PodDefault",
                      "metadata": {"name": "facade-env", "namespace": namespace},
                      "spec": {"selector": {}, "desc": "the apiserver facade's env",
                               "env": [{"name": k, "value": v} for k, v in facade_env.items()]}}
        applied = p.cli("apply", "-f", "-", stdin=yaml.safe_dump(poddefault))
        rec["poddefault_apply"] = (applied.returncode, applied.stdout, applied.stderr)
        rec["facade_env"] = facade_env

        # 4. A notebook from the spawner's form.
        t0 = time.perf_counter()
        rec["notebook_post"] = p.request("jupyter", "POST",
                                         f"/api/namespaces/{namespace}/notebooks",
                                         {"name": "nb", "cpu": "0.5", "memory": "1Gi",
                                          "configurations": ["facade-env"]})

        def notebook_ready() -> bool:
            return api.get("Notebook", "nb", namespace).status.get("readyReplicas", 0) >= 1

        _wait(notebook_ready, timeout, "Notebook nb ready")
        sec["notebook_post_to_ready"] = time.perf_counter() - t0
        nb_pods = api.list("Pod", namespace, label_selector={"notebook": "nb"})
        rec["notebook_pod_env"] = [{k: _env_of(pod).get(k) for k in FACADE_ENV}
                                   for pod in nb_pods]
        t0 = time.perf_counter()
        rec["notebook_stop"] = p.request("jupyter", "PATCH",
                                         f"/api/namespaces/{namespace}/notebooks/nb",
                                         {"stopped": True})
        _wait(lambda: not api.list("Pod", namespace, label_selector={"notebook": "nb"}),
              timeout, "Notebook nb stopped")
        sec["notebook_stop_to_no_pod"] = time.perf_counter() - t0

        # 5. The TpuJob through the CLI.
        tpujob = make_tpujob(job, namespace, replicas=1, tpu_chips_per_worker=gpus,
                             max_restarts=0, command=(sys.executable, *TPUJOB_COMMAND),
                             env=tuple(job_env.items())).to_dict()
        watch = p.cli_popen("get", "tpujobs", "-n", namespace, "-w")
        rows: list = []

        def read_watch():
            for line in watch.stdout:
                rows.append((time.time(), line.rstrip("\n")))

        reader = threading.Thread(target=read_watch, daemon=True)
        reader.start()
        _wait(lambda: rows, 60, "the watch's table header")
        t_apply = time.time()
        applied = p.cli("apply", "-f", "-", stdin=yaml.safe_dump(tpujob))
        rec["tpujob_apply"] = (applied.returncode, applied.stdout, applied.stderr)
        running: dict = {}

        def succeeded_row() -> bool:
            if "running" not in running:
                for pod in api.list("Pod", namespace, label_selector={"kubeflow-tpu.org/job": job}):
                    if pod.status.get("phase") in ("Running", "Succeeded"):
                        running["running"] = time.time()
            if any(job in row and ("Failed" in row) for _, row in rows):
                raise RuntimeError(f"TpuJob {job} failed: {rows}")
            return any(job in row and "Succeeded" in row for _, row in rows)

        _wait(succeeded_row, timeout, f"`kftpu get -w` showing {job} Succeeded", poll=0.05)
        t_succeeded = next(t for t, row in rows if job in row and "Succeeded" in row)
        watch.send_signal(signal.SIGINT)
        rec["watch_rc"] = watch.wait(timeout=30)
        reader.join(timeout=10)
        rec["watch_rows"] = [row for _, row in rows]
        rec["t_apply"], rec["t_running"], rec["t_succeeded"] = \
            t_apply, running.get("running"), t_succeeded
        sec["apply_to_pod_running"] = running["running"] - t_apply if running else None
        sec["job_wall"] = t_succeeded - t_apply
        rec["job_status"] = dict(api.get("TpuJob", job, namespace).status)
        worker = api.list("Pod", namespace, label_selector={"kubeflow-tpu.org/job": job})
        rec["worker_pod_env"] = [{k: _env_of(pod).get(k) for k in FACADE_ENV} for pod in worker]
        rec["pod_log_root"] = [os.path.dirname(pod.status.get("logPath", "")) for pod in worker]
        described = p.cli("describe", "tpujob", job, "-n", namespace)
        rec["describe"] = (described.returncode, described.stdout)
        logs = p.cli("logs", job, "-n", namespace, "--job")
        rec["logs"] = (logs.returncode, logs.stdout)
        top = p.cli("top")
        rec["top"] = (top.returncode, top.stdout)

        # 6. The dashboard.
        rec["workloads"] = p.request("dashboard", "GET", f"/api/workloads/{namespace}")
        rec["activities"] = p.request("dashboard", "GET", f"/api/activities/{namespace}")

        # 7. The trace drain.
        traces = p.cli("traces")
        rec["traces"] = (traces.returncode, parse_traces(traces.stdout), traces.stderr)

        # 8. A durable restart.
        rec["stop_rc"] = p.stop()
        rec["planes"] = p.planes()
        api.close()
        sec["restart_to_serving"] = p.start()
        api = p.client()
        rec["restart_same_admin_token"] = p.admin_token == admin_token
        rec["restart_job_phase"] = api.get("TpuJob", job, namespace).status.get("phase")
        rec["restart_notebook"] = api.get("Notebook", "nb", namespace).metadata.name

        # 9. Nuke the workgroup.
        sa_api = p.client(sa_token)
        rec["sa_before_nuke"] = sa_api.get("TpuJob", job, namespace).metadata.name
        t0 = time.perf_counter()
        rec["nuke_self"] = p.request("dashboard", "DELETE", "/api/workgroup/nuke-self")

        def gone(kind, name, ns) -> bool:
            try:
                api.get(kind, name, ns)
            except NotFound:
                return True
            return False

        _wait(lambda: gone("Profile", namespace, "default") and gone("Namespace", namespace, ""),
              timeout, f"Profile and Namespace {namespace} gone")
        sec["nuke_to_drained"] = time.perf_counter() - t0
        try:
            sa_api.get("TpuJob", job, namespace)
            rec["sa_after_nuke"] = "accepted"
        except Forbidden as e:
            rec["sa_after_nuke"] = str(e)
        sa_api.close()
        rec["admin_after_nuke"] = [o.metadata.name for o in api.list("Profile")]
        with open(p.token_file) as f:
            rec["sa_token_in_file"] = sa_token in f.read()
        rec["token_file"] = p.token_file
        api.close()
        rec["final_stop_rc"] = p.stop()
        rec["planes"] += p.planes()
        rec["output"] = p.output()[-4000:]
        return rec
    except BaseException:
        print(p.output()[-8000:], file=sys.stderr, flush=True)
        raise
    finally:
        p.close()
