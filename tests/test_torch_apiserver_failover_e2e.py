"""The port's durable, highly available control plane as real processes
on the CPU: the facade worker (`testing/workers/apiserver.py`) SIGKILLed
under load and restarted, the counterparts of JAX's
tests/e2e/test_apiserver_failover_e2e.py and
tests/e2e/test_apiserver_restart_e2e.py.

- An active-passive pair over one state directory, over https with one
  pinned CA: writer threads, streaming watchers and a level-triggered
  controller all on endpoint-list clients; the active is SIGKILLed
  mid-load and the standby takes over within the lease's TTL. No acked
  write is lost, by the WAL diff (a fresh store booted over the
  directory once the pair is down holds every acked object), and every
  reconciled object has exactly one generated-name child (two actives,
  or a retried write applied twice, would make two).
- One durable facade SIGKILLed and restarted on its port: objects, uids
  and resourceVersions survive, a bookmark from before the restart gets
  410, and the informer relists and then sees live events.
- The nightly soak (``slow``): seeded kill cycles from the port's
  `FaultSchedule` (the plan JAX's draws, `test_torch_chaos.py`) under a
  continuous writer, the corpse restarted as a
  fresh standby each time.

Every wait has its own deadline; every process is reaped on every path.
"""

import os
import signal
import socket
import sys
import threading
import time
from pathlib import Path

import pytest

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers.runtime import Controller, Result, retry_on_conflict
from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    FakeApiServer,
    Gone,
    NotFound,
    Unavailable,
)
from kubeflow_tpu_torch.testing.job_plane import Manager
from kubeflow_tpu_torch.web import tls

REPO = Path(__file__).resolve().parents[1]
LEASE_DURATION = 2.0
DEFAULT_SEED = 20260804
WRITERS = 3
OBJECTS_PER_WRITER = 25
WATCHERS = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Replica(Manager):
    """One facade process of the port (HA unless `ha` is False); its
    output lines, marker waits, kill and stop are the job plane's."""

    def __init__(self, identity: str, port: int, state, ha: bool = True):
        self.identity = identity
        self.port = port
        self.url = f"https://127.0.0.1:{port}"
        env = {**os.environ, "PYTHONPATH": str(REPO), "KFTPU_STATE_DIR": str(state),
               "KFTPU_PORT": str(port)}
        if ha:
            env.update(KFTPU_HA_IDENTITY=identity, KFTPU_LEASE_DURATION=str(LEASE_DURATION),
                       KFTPU_RENEW_DEADLINE=str(LEASE_DURATION * 0.6))
        super().__init__(identity, [sys.executable, "-m",
                                    "kubeflow_tpu_torch.testing.workers.apiserver"], env)


def _boot_pair(tmp_path):
    ca = tls.ensure_tls_dir(str(tmp_path / "state" / "tls")).ca_cert
    a = _Replica("facade-a", free_port(), tmp_path / "state")
    a.wait_for("leading facade-a", timeout=60)
    b = _Replica("facade-b", free_port(), tmp_path / "state")
    b.wait_for("standby facade-b", timeout=60)
    return a, b, ca


def _client(endpoints, ca, **kw) -> HttpApiClient:
    kw.setdefault("timeout", 5.0)
    kw.setdefault("watch_retry", 0.1)
    kw.setdefault("retry_base", 0.02)
    kw.setdefault("breaker_cooldown", 0.5)
    return HttpApiClient(endpoints, ca=ca, **kw)


def _create_acked(client: HttpApiClient, obj, deadline_s: float = 60.0):
    """A CLI writer across an outage: AlreadyExists can only be this
    writer's earlier attempt that committed before its ack was lost
    (names are writer-unique), so it counts as acked."""
    import http.client

    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return client.create(obj)
        except AlreadyExists:
            return None
        except (Unavailable, http.client.HTTPException, OSError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _reconcile(capi, key):
    """One generated-name child per FailObj (list-empty-then-create: a
    double-active or double-applied retry makes two), then Done."""
    ns, name = key
    try:
        obj = capi.get("FailObj", name, ns)
    except NotFound:
        return Result()
    if obj.status.get("phase") == "Done":
        return Result()
    if not capi.list("ChildObj", namespace=ns, label_selector={"child-of": name}):
        child = new_resource("ChildObj", f"{name}-{os.urandom(4).hex()}", ns, spec={})
        child.metadata.labels["child-of"] = name
        capi.create(child)

    def mark_done():
        fresh = capi.get("FailObj", name, ns).thaw()
        fresh.status["phase"] = "Done"
        capi.update_status(fresh)

    retry_on_conflict(mark_done)
    return Result()


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def test_kill_active_mid_load_fails_over_without_losing_acked_writes(tmp_path):
    a, b, ca = _boot_pair(tmp_path)
    endpoints = [a.url, b.url]
    admin = _client(endpoints, ca)
    ctl_client = _client(endpoints, ca)
    watch_clients = [_client(endpoints, ca) for _ in range(WATCHERS)]
    acked: list[str] = []
    acked_lock = threading.Lock()
    kill_at = threading.Event()
    writer_errors: list[Exception] = []
    seen: list[set] = [set() for _ in range(WATCHERS)]

    for i, wc in enumerate(watch_clients):
        wc.watch(lambda event, obj, i=i: seen[i].add(obj.metadata.name), "FailObj")
    ctl = Controller(ctl_client, "FailObj", _reconcile, name="failover-ctl")
    ctl_stop = threading.Event()
    ctl_thread = threading.Thread(target=ctl.run, args=(ctl_stop,), daemon=True)
    ctl_thread.start()

    def writer(w: int) -> None:
        client = _client(endpoints, ca)
        try:
            for i in range(OBJECTS_PER_WRITER):
                name = f"obj-{w}-{i}"
                _create_acked(client, new_resource("FailObj", name, "load", spec={"w": w}))
                with acked_lock:
                    acked.append(name)
                    if len(acked) >= WRITERS * OBJECTS_PER_WRITER // 3:
                        kill_at.set()
                time.sleep(0.02)  # spread the load across the kill
        except Exception as e:
            writer_errors.append(e)
        finally:
            client.close()

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(WRITERS)]
    try:
        for t in threads:
            t.start()
        assert kill_at.wait(60), "writers never reached the kill point"
        t_kill = time.monotonic()
        a.kill()
        b.wait_for("leading facade-b", timeout=LEASE_DURATION + 10)
        failover = time.monotonic() - t_kill
        assert failover < LEASE_DURATION + 5, f"takeover took {failover:.1f} s"
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "writers hung"
        assert not writer_errors, writer_errors

        with acked_lock:
            acked_names = set(acked)
        assert acked_names == {f"obj-{w}-{i}" for w in range(WRITERS)
                               for i in range(OBJECTS_PER_WRITER)}
        names = {o.metadata.name for o in admin.list("FailObj", "load")}
        assert not acked_names - names, f"acked writes lost: {acked_names - names}"

        def undone():
            return [o.metadata.name for o in admin.list("FailObj", "load")
                    if o.status.get("phase") != "Done"]

        _wait(lambda: not undone(), 90, "the controller never converged")
        per_obj: dict[str, int] = {}
        for c in admin.list("ChildObj", "load"):
            owner = c.metadata.labels["child-of"]
            per_obj[owner] = per_obj.get(owner, 0) + 1
        assert not {k: v for k, v in per_obj.items() if v != 1}, per_obj
        assert set(per_obj) == acked_names
        _wait(lambda: all(acked_names <= s for s in seen), 60,
              f"watchers never converged: {[len(s) for s in seen]}")
        assert admin.failovers >= 1 and ctl_client.failovers >= 1
        assert all(wc.failovers >= 1 for wc in watch_clients)
        assert a.proc.returncode == -signal.SIGKILL
        # The deposed facade serves nothing: its port refuses.
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", a.port), timeout=2).close()
    finally:
        ctl_stop.set()
        ctl_thread.join(timeout=10)
        for c in (admin, ctl_client, *watch_clients):
            c.close()
        a.stop()
        b.stop()

    # The WAL diff: durable truth, read with no server alive.
    restored = FakeApiServer(persist_dir=str(tmp_path / "state" / "store"))
    try:
        durable = {o.metadata.name for o in restored.list("FailObj", "load")}
        assert acked_names <= durable, f"durable state lost {acked_names - durable}"
        assert len(restored.list("ChildObj", "load")) == len(acked_names)
    finally:
        restored.close()


def _wait_port_free(port: int, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                return
            except OSError:
                time.sleep(0.2)
    raise TimeoutError(f"port {port} still busy")


def test_sigkill_restart_preserves_state_and_watch_recovers(tmp_path):
    state = tmp_path / "state"
    ca = tls.ensure_tls_dir(str(state / "tls")).ca_cert
    port = free_port()
    proc = _Replica("single", port, state, ha=False)
    proc.wait_for(f"apiserver ready {port}", timeout=60)
    admin = HttpApiClient(proc.url, ca=ca, watch_retry=0.2)
    try:
        created = admin.create(new_resource("Profile", "team-a", "", spec={"owner": "a@x.co"}))
        rv_early = created.metadata.resource_version
        admin.create(new_resource("ConfigMap", "cm-1", spec={"k": "v"}))
        job = admin.create(new_resource("TpuJob", "held", spec={"replicas": 2}))
        uid_before = job.metadata.uid

        proc.kill()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
        _wait_port_free(port)
        proc = _Replica("single", port, state, ha=False)
        proc.wait_for(f"apiserver ready {port}", timeout=60)

        restored = admin.get("TpuJob", "held")
        assert restored.metadata.uid == uid_before
        assert restored.metadata.resource_version == job.metadata.resource_version
        assert restored.spec["replicas"] == 2
        assert admin.get("Profile", "team-a", "").spec == {"owner": "a@x.co"}
        admin.create(new_resource("ConfigMap", "cm-2", spec={}))
        # A bookmark from before the restart: an honest 410.
        with pytest.raises(Gone):
            admin._stream_once(rv_early)

        seen: list[tuple[str, str]] = []
        got_existing = threading.Event()
        got_live = threading.Event()

        def handler(event, obj):
            seen.append((event, obj.metadata.name))
            if obj.metadata.name == "cm-1":
                got_existing.set()
            if event == "ADDED" and obj.metadata.name == "cm-live":
                got_live.set()

        admin.watch(handler, "ConfigMap")
        assert got_existing.wait(30), seen
        admin.create(new_resource("ConfigMap", "cm-live", spec={}))
        assert got_live.wait(30), seen
    finally:
        admin.close()
        proc.stop()
    assert any(line == "shutdown complete" for _, line in proc.lines)
    assert (state / "store" / "snapshot.json").exists()
    assert (state / "store" / "wal.log").read_text() == ""  # the stop checkpointed


@pytest.mark.slow
def test_failover_soak_nightly(tmp_path):
    """Seeded kill cycles (the port's `FaultSchedule`, apiserver_kill only)
    under a continuous writer: each kill's survivor takes over and the
    corpse restarts as a fresh standby on its port. Gates: every planned
    kill fired and no acked write was lost (KFTPU_FAILOVER_SEED replays
    a run)."""
    from kubeflow_tpu_torch.testing.chaos import APISERVER_KILL, FaultSchedule

    seed = int(os.environ.get("KFTPU_FAILOVER_SEED") or DEFAULT_SEED)
    print(f"# failover soak seed={seed}")
    kills = 3
    schedule = FaultSchedule(seed, faults_per_class=kills, classes=(APISERVER_KILL,))
    a, b, ca = _boot_pair(tmp_path)
    replicas = {a.identity: a, b.identity: b}
    active = a.identity
    endpoints = [a.url, b.url]
    admin = _client(endpoints, ca)
    acked: list[str] = []
    stop_writing = threading.Event()
    writer_errors: list[Exception] = []

    def writer() -> None:
        client = _client(endpoints, ca)
        i = 0
        try:
            while not stop_writing.is_set():
                name = f"soak-{i}"
                _create_acked(client, new_resource("FailObj", name, "soak", spec={}))
                acked.append(name)
                i += 1
                time.sleep(0.01)
        except Exception as e:
            writer_errors.append(e)
        finally:
            client.close()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    takeover_seconds: list[float] = []
    try:
        while not schedule.exhausted:
            fault = schedule.next_fault("GET", "/apis/_", "")
            if fault is None:
                time.sleep(0.05)
                continue
            time.sleep(0.3)  # load in flight at the kill
            corpse = replicas[active]
            t_kill = time.monotonic()
            corpse.kill()
            schedule.mark_injected(fault)
            survivor = next(r for r in replicas.values() if r.identity != active)
            survivor.wait_for(f"leading {survivor.identity}", timeout=LEASE_DURATION + 15)
            takeover_seconds.append(time.monotonic() - t_kill)
            active = survivor.identity
            _wait_port_free(corpse.port, 15.0)
            fresh = _Replica(corpse.identity, corpse.port, tmp_path / "state")
            fresh.wait_for(f"standby {corpse.identity}", timeout=60)
            replicas[corpse.identity] = fresh
        stop_writing.set()
        t.join(timeout=60)
        assert not t.is_alive(), "writer hung past its retry deadline"
        names = {o.metadata.name for o in admin.list("FailObj", "soak")}
        missing = set(acked) - names
        assert not writer_errors, writer_errors
        assert schedule.coverage()[APISERVER_KILL] == kills, (schedule.coverage(), seed)
        assert not missing, f"acked writes lost (seed {seed}): {sorted(missing)[:5]}"
        print(f"# failover soak: {kills} kills, {len(acked)} acked writes kept, takeover "
              f"{max(takeover_seconds):.2f} s worst (seed {seed})")
    finally:
        stop_writing.set()
        admin.close()
        for r in replicas.values():
            r.stop()


CONTROL_PLANE_MODULES = (
    "kubeflow_tpu_torch.testing.persist", "kubeflow_tpu_torch.testing.failover",
    "kubeflow_tpu_torch.testing.fake_apiserver", "kubeflow_tpu_torch.testing.apiserver_http",
    "kubeflow_tpu_torch.web.tls", "kubeflow_tpu_torch.web.wsgi",
    "kubeflow_tpu_torch.testing.workers.apiserver",
)


def test_control_plane_modules_import_no_jax_and_touch_no_cuda():
    """The facade, store, WAL, fence and TLS modules import nothing of
    JAX and never name CUDA: a facade process creates no CUDA context."""
    import json
    import subprocess

    code = ("import importlib, json, sys\n"
            f"for m in {CONTROL_PLANE_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kubeflow_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for module in CONTROL_PLANE_MODULES:
        source = (REPO / (module.replace(".", "/") + ".py")).read_text()
        assert "cuda" not in source.lower(), module
