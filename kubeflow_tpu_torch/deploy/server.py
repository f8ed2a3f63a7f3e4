"""Deploy service — the click-to-deploy bootstrap server analog.

Counterpart of `kubeflow_tpu/deploy/server.py`, whole, its imports
pointed at the port. In process mode each deployment's worker is
``python -m kubeflow_tpu_torch.deploy.worker``, reaching the store
through the port's secure facade (`testing/apiserver_http.ApiServerApp`
with `api/tokens.py` credentials over `web/tls.py` certificates). Neither
the server nor its workers import torch.

Parity with `bootstrap/cmd/bootstrap/app/` (SURVEY.md §3.1): the router
accepts `POST /kfctl/apps/v1/create` and hands each named deployment to a
dedicated worker (the reference spawns a per-deployment kfctl StatefulSet,
`router.go:275`; here a per-deployment worker thread), which serializes
that deployment's applies through a queue (`kfctlServer.go:311-330`) and
reports status via the PlatformDeployment conditions. `gc_older_than`
mirrors the gc mode (`server.go:293-344` mode dispatch).
"""

from __future__ import annotations

import logging
import os
import pathlib
import queue
import subprocess
import sys
import threading
import time

from kubeflow_tpu_torch.deploy.apply import apply_platform, delete_platform
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import CloudProvider
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils import threads
from kubeflow_tpu_torch.web import (
    App,
    HttpError,
    Request,
    Response,
    json_response,
    success_response,
)

log = logging.getLogger(__name__)


class _Worker:
    """Per-deployment serializer: one queue, one thread — concurrent
    applies for the same deployment cannot interleave."""

    def __init__(self, api: FakeApiServer):
        self.api = api
        # Items are (spec, cloud): the provider is chosen per spec, so a
        # deployment can move between fake and gke across re-applies.
        self.queue: "queue.Queue[tuple[PlatformSpec, CloudProvider] | None]" = (
            queue.Queue()
        )
        self.last_applied: float = 0.0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            spec, cloud = item
            try:
                apply_platform(spec, self.api, cloud)
            except Exception:
                log.exception("deploy %s failed", spec.name)
            finally:
                self.last_applied = time.time()
                self.queue.task_done()

    def stop(self) -> None:
        self.queue.put(None)


class _ProcessWorker:
    """Per-deployment worker PROCESS — the kfctl-StatefulSet-per-
    deployment analog (`router.go:275`): one deployment's crash or leak
    cannot take down the deploy service or its neighbors. Desired state
    rides the PlatformDeployment CR, so a respawned worker recovers by
    re-reading it (`deploy/worker.py`)."""

    def __init__(
        self,
        name: str,
        apiserver_url: str,
        token: str,
        ca: str,
        extra_args: tuple[str, ...] = (),
    ):
        self.name = name
        self.apiserver_url = apiserver_url
        self.token = token
        self.ca = ca
        self.extra_args = extra_args
        self.respawns = 0
        self.last_applied: float = 0.0
        # Respawn backoff: a worker dying at startup (bad flags, broken
        # env) must not be fork+exec'd 3x/second forever.
        self.backoff = 0.5
        self.next_respawn = 0.0
        self.proc: subprocess.Popen | None = None
        self.spawn()

    def spawn(self) -> None:
        repo_root = str(pathlib.Path(__file__).resolve().parents[2])
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "kubeflow_tpu_torch.deploy.worker",
                "--apiserver", self.apiserver_url,
                "--name", self.name,
                *self.extra_args,
            ],
            env={
                **os.environ,
                "PYTHONPATH": os.pathsep.join(
                    p for p in (repo_root, os.environ.get("PYTHONPATH"))
                    if p
                ),
                "KFTPU_TOKEN": self.token,
                "KFTPU_CA": self.ca,
            },
            stdout=subprocess.DEVNULL,
            # stderr inherits: a worker failing its CR polls (RBAC, bad
            # facade URL) must leave a trace somewhere findable.
            stderr=None,
        )

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class DeployServer(App):
    def __init__(
        self,
        api: FakeApiServer,
        cloud: CloudProvider,
        gke_transport=None,
        worker_mode: str = "thread",
        worker_args: tuple[str, ...] = (),
    ):
        super().__init__("deploy-server")
        self.api = api
        self.cloud = cloud
        # Specs selecting provider "gke" get a GkeCloud over this
        # transport (default: recording — request construction is
        # observable without a cloud; production injects a token-bearing
        # HTTP transport, the kfctlServer.go:179-201 TokenSource slot).
        explicit_gke_transport = gke_transport is not None
        if gke_transport is None:
            from kubeflow_tpu_torch.deploy.gke import RecordingTransport

            gke_transport = RecordingTransport()
        self.gke_transport = gke_transport
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.worker_args = tuple(worker_args)
        if (
            worker_mode == "process"
            and explicit_gke_transport
            and "--gke-token-file" not in self.worker_args
            and "--gke-api-base" not in self.worker_args
        ):
            # Worker processes rebuild their cloud from worker_args; an
            # in-memory transport cannot cross the process boundary, and
            # silently falling back to RecordingTransport would report
            # Ready without sending a single real GKE call (while delete
            # still sends real deletes server-side).
            raise ValueError(
                "worker_mode='process' with a programmatic gke_transport: "
                "pass the credentials via worker_args "
                "('--gke-token-file', path, '--gke-api-base', url) so the "
                "worker processes can reconstruct the transport"
            )
        self._workers: dict[str, _Worker | _ProcessWorker] = {}
        self._specs: dict[str, PlatformSpec] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if worker_mode == "process":
            self._start_worker_plane()
        self.add_route("/kfctl/apps/v1/create", self.create, ("POST",))
        self.add_route("/kfctl/apps/v1/status/<name>", self.status)
        self.add_route("/kfctl/apps/v1/delete/<name>", self.delete, ("DELETE",))

    # -- process-mode plumbing ---------------------------------------------

    def _start_worker_plane(self) -> None:
        """Serve the store over the (secure) HTTP facade for worker
        processes, and babysit them: a dead worker whose deployment has
        not converged is respawned — crash containment WITH recovery
        (`router.go:275` lets the StatefulSet controller do this; we are
        that controller here)."""
        from kubeflow_tpu_torch.api.rbac import (
            make_cluster_role_binding,
            seed_cluster_roles,
        )
        from kubeflow_tpu_torch.api.tokens import TokenRegistry, service_account
        from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
        from kubeflow_tpu_torch.web.wsgi import serve

        seed_cluster_roles(self.api)
        tokens = TokenRegistry()
        worker_user = service_account("kubeflow", "deploy-worker")
        # The K8S phase applies arbitrary bundle resources — the worker
        # runs with the deployer's full authority, like kfctl does with
        # the owner's credential.
        from kubeflow_tpu_torch.testing.fake_apiserver import AlreadyExists

        try:
            self.api.create(make_cluster_role_binding(
                "deploy-worker", "kubeflow-admin", worker_user
            ))
        except AlreadyExists:
            pass  # second server over the same store
        self._worker_token = tokens.issue(worker_user)
        # The worker credential rides TLS (the facade refuses plaintext
        # tokens by design); workers pin the minted CA via KFTPU_CA.
        import atexit
        import shutil
        import tempfile

        from kubeflow_tpu_torch.web import tls as tlsmod

        tls_dir = tempfile.mkdtemp(prefix="kftpu-deploy-tls-")
        atexit.register(shutil.rmtree, tls_dir, True)
        tls_paths = tlsmod.ensure_tls_dir(tls_dir)
        self._worker_ca = tls_paths.ca_cert
        self._facade, _ = serve(
            ApiServerApp(self.api, tokens=tokens), host="127.0.0.1", port=0,
            tls=tls_paths,
        )
        self._facade_url = f"https://127.0.0.1:{self._facade.server_port}"
        self._monitor = threading.Thread(
            target=self._babysit, name="deploy-worker-monitor", daemon=True
        )
        self._monitor.start()

    def _converged(self, name: str) -> bool:
        try:
            dep = self.api.get("PlatformDeployment", name, "")
        except NotFound:
            return False
        return (
            dep.status.get("observedGeneration") == dep.metadata.generation
            and dep.status.get("phase") in ("Ready", "Failed")
        )

    def _babysit(self) -> None:
        while not self._stop.wait(0.3):
            with self._lock:
                workers = [
                    (name, w) for name, w in self._workers.items()
                    if isinstance(w, _ProcessWorker)
                ]
            for name, worker in workers:
                if time.time() < worker.next_respawn:
                    continue
                if not worker.alive() and not self._converged(name):
                    # Membership re-check under the lock (a concurrent
                    # delete/gc may have popped this worker since the
                    # snapshot), but the Popen itself runs OUTSIDE it —
                    # fork+exec must not stall every HTTP handler. The
                    # post-spawn re-check reaps the new process if the
                    # deployment was deleted mid-spawn.
                    with self._lock:
                        if self._workers.get(name) is not worker:
                            continue
                        worker.respawns += 1
                        worker.next_respawn = time.time() + worker.backoff
                        worker.backoff = min(worker.backoff * 2, 30.0)
                    log.warning(
                        "deploy worker %s died mid-apply; respawning", name
                    )
                    worker.spawn()
                    with self._lock:
                        orphaned = self._workers.get(name) is not worker
                    if orphaned:
                        worker.stop()

    def _submit_cr(self, spec: PlatformSpec) -> None:
        """Desired state into the PlatformDeployment CR (spec change bumps
        metadata.generation; the worker chases observedGeneration)."""
        from kubeflow_tpu_torch.api.objects import new_resource
        from kubeflow_tpu_torch.deploy.apply import retry_rmw

        def mutate(dep):
            dep.spec = {**dep.spec, "platformSpec": spec.to_dict()}

        retry_rmw(
            self.api, "PlatformDeployment", spec.name, "",
            mutate, self.api.update,
            factory=lambda: new_resource(
                "PlatformDeployment", spec.name, ""
            ),
        )

    def shutdown_workers(self) -> None:
        """Stop all workers and (process mode) the facade + monitor."""
        self._stop.set()
        if self.worker_mode == "process":
            # The monitor must be fully parked before workers are
            # stopped, or it could respawn one mid-shutdown.
            self._monitor.join(timeout=5)
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for worker in workers:
            worker.stop()
        if self.worker_mode == "process":
            self._facade.shutdown()

    # -- routing (router.go:91-407) ---------------------------------------

    def _worker_for(self, name: str) -> _Worker | _ProcessWorker:
        with self._lock:
            worker = self._workers.get(name)
        if worker is not None:
            return worker
        # Construct OUTSIDE the lock: a process worker's __init__ spawns
        # a subprocess (blocking under the lock), and _lock is on
        # every request path. Two racing first-requests may both build a
        # candidate; the double-checked insert picks one winner and the
        # loser is stopped before it ever receives work.
        if self.worker_mode == "process":
            candidate: _Worker | _ProcessWorker = _ProcessWorker(
                name,
                self._facade_url,
                self._worker_token,
                self._worker_ca,
                self.worker_args,
            )
        else:
            candidate = _Worker(self.api)
        with self._lock:
            worker = self._workers.get(name)
            if worker is None:
                self._workers[name] = worker = candidate
        if worker is not candidate:
            candidate.stop()
        return worker

    def _cloud_for(self, spec: PlatformSpec) -> CloudProvider:
        if spec.provider == "fake":
            return self.cloud
        if spec.provider == "gke":
            from kubeflow_tpu_torch.deploy.gke import GkeCloud

            return GkeCloud(self.gke_transport)
        raise HttpError(
            400, f"unknown provider {spec.provider!r} (fake | gke)"
        )

    def create(self, req: Request) -> Response:
        body = req.json()
        # Validate before from_dict — the parser defaults a missing name,
        # which would silently merge into an existing deployment.
        if not body.get("metadata", {}).get("name"):
            raise HttpError(400, "spec needs metadata.name")
        spec = PlatformSpec.from_dict(body)
        cloud = self._cloud_for(spec)  # validates provider before queueing
        with self._lock:
            self._specs[spec.name] = spec
        if self.worker_mode == "process":
            # Desired state into the CR first, then make sure a worker
            # process exists to chase it (the CR is the queue: a spec
            # bump increments metadata.generation and the worker applies
            # until observedGeneration catches up — serialization for
            # free, per deployment).
            self._submit_cr(spec)
            self._worker_for(spec.name)
        else:
            self._worker_for(spec.name).queue.put((spec, cloud))
        return success_response("name", spec.name)

    def status(self, req: Request) -> Response:
        name = req.path_params["name"]
        try:
            dep = self.api.get("PlatformDeployment", name, "")
        except NotFound:
            raise HttpError(404, f"deployment {name!r} not found")
        return json_response(
            {"name": name, "status": dep.status}
        )

    def delete(self, req: Request) -> Response:
        name = req.path_params["name"]
        with self._lock:
            spec = self._specs.pop(name, None)
            worker = self._workers.pop(name, None)
        if spec is None:
            raise HttpError(404, f"deployment {name!r} not found")
        if isinstance(worker, _Worker):
            # Drain in-flight applies first — bounded, so a wedged apply
            # fails the delete loudly instead of hanging the request.
            threads.join_queue(
                worker.queue, what=f"deployment {name!r} apply queue"
            )
            worker.stop()
        elif worker is not None:
            worker.stop()  # the CR below is deleted; nothing to drain
        delete_platform(spec, self.api, self._cloud_for(spec))
        return success_response()

    # -- gc mode -----------------------------------------------------------

    def gc_older_than(self, max_age_seconds: float) -> list[str]:
        """Collect deployments whose last apply is older than the cutoff
        (bootstrap's `gc` mode garbage-collects stale click-to-deploy
        instances the same way)."""
        now = time.time()
        doomed = []
        with self._lock:
            for name, worker in list(self._workers.items()):
                if isinstance(worker, _ProcessWorker):
                    # Converged deployments age from the moment gc first
                    # observes convergence; an unconverged one is never
                    # collected (the babysitter may still be respawning
                    # its worker).
                    if not self._converged(name):
                        worker.last_applied = 0.0
                        continue
                    if worker.last_applied == 0.0:
                        worker.last_applied = now
                    if now - worker.last_applied > max_age_seconds:
                        doomed.append(name)
                    continue
                # unfinished_tasks counts queued AND in-flight applies —
                # queue.empty() alone would let gc race a running apply.
                if (
                    worker.queue.unfinished_tasks == 0
                    and worker.last_applied
                    and now - worker.last_applied > max_age_seconds
                ):
                    doomed.append(name)
        for name in doomed:
            with self._lock:
                spec = self._specs.pop(name, None)
                worker = self._workers.pop(name, None)
            if worker:
                worker.stop()
            if spec is not None:
                # Same provider the spec deployed with — gc of a gke
                # deployment must send the node-pool deletes on the gke
                # transport, or real (billed) GPU pools leak.
                delete_platform(spec, self.api, self._cloud_for(spec))
        return doomed

    def wait_idle(self, timeout: float = 120.0) -> None:
        """Block until every queued apply has finished (tests)."""
        with self._lock:
            items = list(self._workers.items())
        deadline = time.time() + timeout
        for name, worker in items:
            if isinstance(worker, _ProcessWorker):
                while not self._converged(name):
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"deployment {name} did not converge"
                        )
                    time.sleep(0.1)
            else:
                threads.join_queue(
                    worker.queue,
                    timeout=max(0.1, deadline - time.time()),
                    what=f"deployment {name!r} apply queue",
                )
