"""The platform in a box: every backend against one API server.

Counterpart of `kubeflow_tpu/apps/__main__.py`, with its flags and boot:

    python -m kubeflow_tpu_torch.apps [--port-base 8080] [--anonymous me@x.co]
        [--admin me@x.co] [--state-dir DIR] [--insecure-apiserver]

One process holds the store (durable under ``--state-dir``: the WAL and
snapshot of `testing/persist.py`, and the token file beside them), every
controller of the JAX launcher (profile, notebook, tensorboard, tpujob,
nodehealth, study, workflow, cronworkflow) with the PodDefault, quota
and TpuJob admission hooks, the local pod runner (pods are processes,
their stdout captured for the facade's log route) with the workload
materializer beside it, and five servers: base+0 the dashboard, +1
kfam, +2 the Jupyter spawner, +3 Tensorboards (http, behind header
authentication; ``--anonymous`` is the dev mode's user) and +4 the
apiserver facade, the CLI's target (``python -m kubeflow_tpu_torch.cli``).

The facade is secure by default: https with the platform CA, bearer
tokens and RBAC. The boot mints (or, on a durable restart, reloads) a
cluster-admin token and prints it, the token file (kube-apiserver's
``--token-auth-file`` format; a file present at boot under the state
directory is loaded, so a static token written there before the first
boot is honoured) and the CA. The token file is never under the pod-log
root. Deleting a Profile revokes its namespace's service-account tokens.
``--insecure-apiserver`` serves the facade open over http (dev only).
SIGTERM or SIGINT shuts it down, prints ``plane {json}`` (the
controller-manager binary's line, `controllers.runtime.plane_report`:
each controller's work-queue backend and the TpuJob operator's gang
placements by scheduler backend) and exits 0.

The seeded Nodes are the port's: ``--nodes`` (default 1) Nodes in pool
``--node-pool``, each advertising as ``chips`` the GPUs the CUDA driver
reports on this host (none without a driver: pass ``--nodes 0`` on a
host without a GPU, so pods place without a cluster model), never the
JAX launcher's four TPU chips a Node.
"""

from __future__ import annotations

import argparse
import atexit
import faulthandler
import hashlib
import json
import logging
import os
import shutil
import signal
import tempfile
import threading

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import make_cluster_role_binding, seed_cluster_roles
from kubeflow_tpu_torch.api.tokens import TokenRegistry
from kubeflow_tpu_torch.apps.dashboard import DashboardApp
from kubeflow_tpu_torch.apps.jupyter import JupyterApp
from kubeflow_tpu_torch.apps.kfam import KfamApp
from kubeflow_tpu_torch.apps.tensorboards import TensorboardsApp
from kubeflow_tpu_torch.controllers import poddefault, quota
from kubeflow_tpu_torch.controllers import tpujob as tpujob_mod
from kubeflow_tpu_torch.controllers.cronworkflow import CronWorkflowController
from kubeflow_tpu_torch.controllers.nodehealth import NodeHealthController
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.controllers.runtime import ControllerManager, plane_report
from kubeflow_tpu_torch.controllers.study import StudyController
from kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.controllers.workflow import WorkflowController
from kubeflow_tpu_torch.runtime import LocalPodRunner, WorkloadMaterializer
from kubeflow_tpu_torch.sidecar.controller import driver_device_count
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import AlreadyExists, FakeApiServer
from kubeflow_tpu_torch.utils import signals
from kubeflow_tpu_torch.web import tls
from kubeflow_tpu_torch.web.authn import HeaderAuthn
from kubeflow_tpu_torch.web.wsgi import serve


def _tls_hosts(args, tls_dir: str) -> tuple[str, ...]:
    """The facade cert's names: loopback and the bind host, every name a
    durable restart's cert already carries (dropping one would re-mint
    the CA under every pinned client), and --advertise-host, or for a
    0.0.0.0 bind this machine's own names."""
    hosts = ["localhost", "127.0.0.1"]
    if args.host not in hosts and args.host != "0.0.0.0":
        hosts.append(args.host)
    prior = tls.read_hosts_marker(tls_dir)
    hosts.extend(h for h in prior if h not in hosts)
    if args.advertise_host:
        hosts.extend(h for h in args.advertise_host if h not in hosts)
    elif args.host == "0.0.0.0" and not prior:
        import socket

        candidates = [socket.gethostname(), socket.getfqdn()]
        # A UDP connect sends nothing; it picks the default route's IP.
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("10.255.255.255", 1))
            candidates.append(probe.getsockname()[0])
        except OSError:
            pass
        finally:
            probe.close()
        hosts.extend(h for h in candidates if h and h not in hosts)
    return tuple(hosts)


def main() -> None:
    # SIGUSR1 dumps every thread's stack (a wedged shutdown, a stuck
    # controller) without killing the platform.
    faulthandler.register(signal.SIGUSR1)
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-apps")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--advertise-host", action="append", default=None,
        help="extra hostname/IP for the facade cert's SANs (repeat for several); "
        "with --host 0.0.0.0 the default is this machine's hostname, FQDN and IP")
    parser.add_argument("--port-base", type=int, default=8080)
    parser.add_argument("--anonymous", default=None,
                        help="dev-mode user for requests to the web apps without an "
                        "identity header")
    parser.add_argument("--admin", default=None, help="grant this user cluster-admin")
    parser.add_argument(
        "--insecure-apiserver", action="store_true",
        help="serve the facade over http without bearer tokens (dev only); by default "
        "it is https with an admin token minted, printed and saved to a token file")
    parser.add_argument(
        "--state-dir", default=None,
        help="durable control-plane state: the store's WAL and snapshot, the token "
        "file and the TLS material, so a restart keeps its objects and credentials; "
        "default: in memory")
    parser.add_argument(
        "--nodes", type=int, default=1,
        help="Nodes to seed on a fresh store (0: none), each advertising the GPUs "
        "the CUDA driver reports on this host as its chips")
    parser.add_argument(
        "--node-pool", default="gpu",
        help="pool of the seeded Nodes; a TpuJob asking a topology places only onto "
        "Nodes of that pool")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    # Installed before the store and the servers start: a SIGTERM during
    # the boot shuts down cleanly.
    shutdown_requested = signals.install_shutdown_handlers()

    if args.state_dir:
        os.makedirs(args.state_dir, mode=0o700, exist_ok=True)
        api = FakeApiServer(persist_dir=os.path.join(args.state_dir, "store"))
    else:
        api = FakeApiServer()
    # Seed only a fresh store: a durable restart restores them.
    if api.current_rv == 0:
        seed_cluster_roles(api)
        chips = driver_device_count() if args.nodes else 0
        for i in range(args.nodes):
            node = new_resource("Node", f"gpu-node-{i}", "",
                                spec={"pool": args.node_pool, "chips": chips, "x": i, "y": 0})
            node.status = {"ready": True, "cpuUtilization": 0.1, "memoryUtilization": 0.2,
                           "tpuDutyCycle": 0.0}
            api.create(node)
    if args.admin:
        # Also on a durable restart; the binding's name is per user.
        suffix = hashlib.sha256(args.admin.encode()).hexdigest()[:8]
        try:
            api.create(make_cluster_role_binding(f"boot-admin-{suffix}", "kubeflow-admin",
                                                 args.admin))
        except AlreadyExists:
            pass

    manager = ControllerManager()
    built = (
        ProfileController(api),
        NotebookController(api),
        TensorboardController(api),
        TpuJobController(api),
        NodeHealthController(api),
        StudyController(api),
        WorkflowController(api),
        CronWorkflowController(api),
    )
    for ctl in built:
        manager.add(ctl.controller)
    poddefault.register(api)
    quota.register(api)
    tpujob_mod.register_admission(api)
    manager.start()

    # Pods run as subprocesses, their stdout captured for the facade's
    # log route; server-shaped workloads are materialized as Running pods.
    log_dir = tempfile.mkdtemp(prefix="kftpu-pod-logs-")
    atexit.register(shutil.rmtree, log_dir, True)
    runner = LocalPodRunner(api, capture_dir=log_dir)
    materializer = WorkloadMaterializer(api)
    runner_stop = threading.Event()

    def run_pods():
        while not runner_stop.is_set():
            # Separate recovery domains: one failing stepper must not
            # starve the other.
            try:
                runner.step()
            except Exception:
                logging.exception("pod runner step failed; continuing")
            try:
                materializer.step()
            except Exception:
                logging.exception("materializer step failed; continuing")
            runner_stop.wait(0.2)

    pods_thread = threading.Thread(target=run_pods, name="pod-runner", daemon=True)
    pods_thread.start()

    authn = HeaderAuthn(anonymous=args.anonymous)
    tokens = None
    tls_paths = None
    if not args.insecure_apiserver:
        if args.state_dir:
            # Durable: the restart keeps the admin credential.
            token_file = os.path.join(args.state_dir, "tokens")
            tokens = TokenRegistry.load(token_file) if os.path.exists(token_file) \
                else TokenRegistry()
        else:
            # Not under log_dir: that is the log route's root, and
            # status.logPath is client-writable.
            token_dir = tempfile.mkdtemp(prefix="kftpu-apiserver-")
            atexit.register(shutil.rmtree, token_dir, True)
            token_file = os.path.join(token_dir, "tokens")
            tokens = TokenRegistry()
        # Every mutation persists: a restart must not resurrect a revoked
        # credential.
        tokens.autosave(token_file)
        admin_token = tokens.token_for("system:admin") or tokens.issue("system:admin")
        tokens.watch_profiles(api)
        try:
            api.create(make_cluster_role_binding("system-admin", "kubeflow-admin",
                                                 "system:admin"))
        except AlreadyExists:
            pass  # restored from disk
        tls_dir = os.path.join(os.path.dirname(token_file), "tls")
        tls_paths = tls.ensure_tls_dir(tls_dir, hosts=_tls_hosts(args, tls_dir))
        print(f"apiserver admin token: {admin_token}")
        print(f"apiserver token file:  {token_file}")
        print(f"apiserver CA (pin via --ca/KFTPU_CA): {tls_paths.ca_cert}")
    apps = [
        DashboardApp(api, authn=authn),
        KfamApp(api, authn=authn),
        JupyterApp(api, authn=authn),
        TensorboardsApp(api, authn=authn),
        ApiServerApp(api, log_root=log_dir, tokens=tokens),
    ]
    servers = []
    for offset, app in enumerate(apps):
        # Only the facade carries bearer tokens; the web apps sit behind
        # header authentication and stay http.
        is_facade = app.name == "apiserver"
        server, _ = serve(app, host=args.host, port=args.port_base + offset,
                          tls=tls_paths if is_facade else None)
        servers.append(server)
        scheme = "https" if (is_facade and tls_paths) else "http"
        print(f"{app.name}: {scheme}://{args.host}:{server.server_port}", flush=True)
    signals.wait_for_shutdown(shutdown_requested)
    runner_stop.set()
    pods_thread.join(timeout=10.0)
    runner.shutdown()
    manager.stop()
    print("plane " + json.dumps(plane_report(built)), flush=True)
    for server in servers:
        server.shutdown()
        server.server_close()
    api.close()  # durable: fold the WAL into a snapshot


if __name__ == "__main__":
    main()
