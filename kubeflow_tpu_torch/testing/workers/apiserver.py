"""The durable apiserver facade as its own process: the kill target.

Counterpart of the JAX package's ``tests/e2e/apiserver_worker.py``, with
the same env contract minus tokens (this process serves the facade
open; `apps/__main__.py` serves it with tokens and RBAC), over https
unless told otherwise:

    python -m kubeflow_tpu_torch.testing.workers.apiserver

    KFTPU_STATE_DIR       the state directory, the same across restarts and
                          for both replicas of a pair: the store in
                          <state>/store, the apiserver lease in <state>/lease
    KFTPU_PORT            the port to serve on (the same across restarts, so
                          clients and watch streams reconnect)
    KFTPU_TLS_DIR         the TLS directory it serves https with (default
                          <state>/tls, minted by `web.tls.ensure_tls_dir` if
                          empty; clients pin its ca.crt)
    KFTPU_PLAINTEXT       1: serve plain http instead (an explicit opt-in, for
                          a fault-injecting proxy that must read the HTTP)
    KFTPU_STREAM_DURATION, KFTPU_STREAM_SLICE
                          the streaming watch's lifetime and bookmark cadence
                          in seconds (`ApiServerApp`'s defaults otherwise)
    KFTPU_HA_IDENTITY     this replica's identity; set, it runs in HA mode
    KFTPU_LEASE_DURATION  the apiserver lease's TTL in seconds (default 3)
    KFTPU_RENEW_DEADLINE  default 2

The store gets the TpuJob admission and ResourceQuota admission, as the
job plane's in-process store does, and prints ``apiserver ready <port>``
once serving. On SIGTERM it stops serving, prints ``served {json}``
(the TLS handshakes it completed and the requests it served), closes
the store (a checkpoint) and exits 0.

HA mode (`testing/failover.py`): N replicas over one state directory,
each on its own port. A replica prints ``standby <identity>`` and parks
in the lease's acquire loop, serving nothing (it does not bind its
port). On winning the lease it takes over (`open_active_store`: replay
the WAL, checkpoint, which moves the log to a new inode, serve fenced to
this term), prints ``takeover {json}`` (the WAL and snapshot bytes it
found and the inode of ``wal.log`` it found, `open_active_store`'s
seconds, the WAL backend, the inode of ``wal.log`` after the checkpoint,
the rv and the object count), then
``apiserver ready <port>`` and ``leading <identity> gen <n>``, the last
line of its boot. On losing the lease it prints ``deposed <identity>``
and exits 2 without closing the store: a deposed active's checkpoint is
the late write the fence exists to stop. On SIGTERM it closes the store
(a checkpoint, under the term it still holds) and then releases the
lease, so a standby takes over on its next poll.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import time

# Imported before the standby parks, so a takeover pays none of it.
from kubeflow_tpu_torch.controllers import quota
from kubeflow_tpu_torch.controllers.leader import LeaderElector
from kubeflow_tpu_torch.controllers.tpujob import register_admission
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.failover import FileLeaseStore, WalFenced, open_active_store
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, Unavailable
from kubeflow_tpu_torch.utils import signals as sigutil
from kubeflow_tpu_torch.web import tls
from kubeflow_tpu_torch.web.wsgi import serve


def _size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except FileNotFoundError:
        return 0


def _inode(path: str) -> int | None:
    try:
        return os.stat(path).st_ino
    except FileNotFoundError:
        return None


def _admit(api) -> None:
    register_admission(api)
    quota.register(api)


def _serve(api):
    paths = None
    if os.environ.get("KFTPU_PLAINTEXT") != "1":
        paths = tls.ensure_tls_dir(os.environ.get("KFTPU_TLS_DIR") or os.path.join(
            os.environ["KFTPU_STATE_DIR"], "tls"))
    app = ApiServerApp(api)
    for attr in ("STREAM_DURATION", "STREAM_SLICE"):
        if os.environ.get(f"KFTPU_{attr}"):
            setattr(app, attr, float(os.environ[f"KFTPU_{attr}"]))
    server, _ = serve(app, host="127.0.0.1", port=int(os.environ["KFTPU_PORT"]), tls=paths)
    print(f"apiserver ready {server.server_port}", flush=True)
    return server


def _shutdown(server, api) -> None:
    print("shutting down: server", flush=True)
    server.shutdown()
    server.server_close()
    print("served " + json.dumps({"tls_handshakes": server.tls_handshakes,
                                  "requests_served": server.requests_served}), flush=True)
    print("shutting down: store", flush=True)
    api.close()  # the graceful path folds the WAL into a snapshot
    print("shutdown complete", flush=True)


def main() -> int:
    # SIGUSR1 dumps every thread's stack: a supervisor sends it before
    # killing a replica that missed its SIGTERM deadline.
    faulthandler.register(signal.SIGUSR1)
    state = os.environ["KFTPU_STATE_DIR"]
    store_dir = os.path.join(state, "store")
    identity = os.environ.get("KFTPU_HA_IDENTITY")
    stop = sigutil.install_shutdown_handlers()

    if identity is None:
        api = FakeApiServer(persist_dir=store_dir)
        _admit(api)
        server = _serve(api)
        sigutil.wait_for_shutdown(stop)
        _shutdown(server, api)
        return 0

    leases = FileLeaseStore(os.path.join(state, "lease"))
    elector = LeaderElector(
        leases, "apiserver", identity,
        lease_duration=float(os.environ.get("KFTPU_LEASE_DURATION", "3")),
        renew_deadline=float(os.environ.get("KFTPU_RENEW_DEADLINE", "2")),
        retry_period=0.25)
    print(f"standby {identity}", flush=True)
    if not elector.acquire(stop):
        return 0  # stopped while parked: it never served
    wal_log = os.path.join(store_dir, "wal.log")
    found = {"wal_bytes": _size(wal_log),
             "snapshot_bytes": _size(os.path.join(store_dir, "snapshot.json")),
             "wal_inode_found": _inode(wal_log)}
    t0 = time.perf_counter()
    api = open_active_store(store_dir, leases, "apiserver", identity, elector.transitions)
    found["open_active_store_s"] = time.perf_counter() - t0
    found.update(wal_backend=api.wal_backend, wal_inode=_inode(wal_log))
    found.update(rv=api.current_rv, objects=sum(len(api.list(k)) for k in api.kinds()),
                 time=time.time())
    print(f"takeover {json.dumps(found)}", flush=True)
    _admit(api)
    server = _serve(api)
    print(f"leading {identity} gen {elector.transitions}", flush=True)
    elector.hold(stop)  # renew until stopped or deposed
    if not stop.is_set():
        print(f"deposed {identity}", flush=True)
        server.shutdown()
        return 2
    try:
        _shutdown(server, api)
    except (WalFenced, Unavailable):
        # SIGTERM raced a deposition: the close-path checkpoint met the
        # fence. That is the fence working; leave the lease to the
        # successor.
        print(f"deposed {identity}", flush=True)
        return 2
    elector.release()  # the checkpoint needed the term; now hand it over
    return 0


if __name__ == "__main__":
    sys.exit(main())
