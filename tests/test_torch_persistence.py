"""The port's durable store (`testing/persist.py`, the store's
`persist_dir=`) and its active-passive fencing (`testing/failover.py`),
against the JAX package's.

First the cases of JAX's tests/test_persistence.py, on the port's store
(on the compiled WAL, its default): a restart restores the
objects, uids, generations and resourceVersions; a bookmark from before
it gets Gone; compaction, a torn tail and its repair, a stale
pre-snapshot record, a snapshot of another format, the fail-stop after a
failed WAL write, and a pending deletion parked by a finalizer and
finalized after the restart. Then the same writes through both packages restore to
equal objects and rv, a directory written by either restores in the
other (on either of the port's WAL backends), and the fence:
`FileLeaseStore` answers a CAS sequence as JAX's does, a store fenced to
a moved term fail-stops on its next write, and the takeover's checkpoint
moves ``wal.log`` to a new inode on both backends, so a deposed fd's
appends are never replayed.
"""

import json
import os

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.testing import failover as j_failover
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.testing import failover, persist
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    Conflict,
    FakeApiServer,
    Gone,
    Invalid,
    NotFound,
    Unavailable,
)


def _server(tmp_path, **kw):
    return FakeApiServer(persist_dir=str(tmp_path / "state"), **kw)


def _jax_server(tmp_path, **kw):
    return JFakeApiServer(persist_dir=str(tmp_path / "state"), wal_backend="python", **kw)


# -- JAX's cases, on the port -------------------------------------------------


def test_cold_start_from_empty_dir(tmp_path):
    api = _server(tmp_path)
    assert api.current_rv == 0
    assert api.list("ConfigMap") == []
    api.create(new_resource("ConfigMap", "a", spec={"k": "v"}))
    api.close()
    snap = json.loads((tmp_path / "state" / "snapshot.json").read_text())
    assert snap["format"] == persist.FORMAT == 1


def test_restart_restores_objects_and_rv(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={"k": "v1"}))
    b = api.create(new_resource("TpuJob", "train", spec={"replicas": 4})).thaw()
    b.spec["replicas"] = 8
    api.update(b)
    job = api.get("TpuJob", "train").thaw()
    job.status = {"phase": "Running"}
    api.update_status(job)
    api.create(new_resource("ConfigMap", "gone", spec={}))
    api.delete("ConfigMap", "gone")
    rv_before = api.current_rv
    uid_before = api.get("TpuJob", "train").metadata.uid
    del api  # no close(): the process dies without a checkpoint

    api2 = _server(tmp_path)
    assert api2.current_rv == rv_before
    restored = api2.get("TpuJob", "train")
    assert restored.spec == {"replicas": 8}
    assert restored.status == {"phase": "Running"}
    assert restored.metadata.uid == uid_before
    assert restored.metadata.generation == 2
    assert api2.get("ConfigMap", "a").spec == {"k": "v1"}
    with pytest.raises(NotFound):
        api2.get("ConfigMap", "gone")
    c = api2.create(new_resource("ConfigMap", "after", spec={}))
    assert c.metadata.resource_version == rv_before + 1


def test_restart_preserves_finalizers_and_deletion_timestamp(tmp_path):
    """finalizers and deletionTimestamp are restored with labels,
    annotations and owner references, and a pending deletion restored
    from the WAL is finalized once its last finalizer is cleared."""
    api = _server(tmp_path)
    owner = api.create(new_resource("Profile", "team", "", spec={}))
    obj = new_resource("ConfigMap", "cm", "team", spec={"k": 1})
    obj.metadata.finalizers = ["profile-finalizer"]
    obj.metadata.deletion_timestamp = 1234.5
    obj.metadata.labels = {"app": "x"}
    obj.metadata.annotations = {"note": "y"}
    obj.metadata.owner_references = [{"kind": "Profile", "name": "team",
                                       "uid": owner.metadata.uid}]
    stored = api.create(obj)
    del api

    api2 = _server(tmp_path)
    got = api2.get("ConfigMap", "cm", "team")
    assert got.to_dict() == stored.to_dict()
    assert got.metadata.finalizers == ["profile-finalizer"]
    assert got.metadata.deletion_timestamp == 1234.5
    # The cascade reaches the dependent through its restored owner
    # reference; held by its finalizer, it stays until that is cleared.
    api2.delete("Profile", "team", "")
    held = api2.get("ConfigMap", "cm", "team")
    assert held.metadata.deletion_timestamp == 1234.5
    held = held.thaw()
    held.metadata.finalizers = []
    api2.update(held)
    with pytest.raises(NotFound):
        api2.get("ConfigMap", "cm", "team")


def test_watch_bookmark_from_before_restart_gets_gone(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.create(new_resource("ConfigMap", "b", spec={}))
    old_rv = 1
    del api

    api2 = _server(tmp_path)
    with pytest.raises(Gone):
        api2.events_since(old_rv)
    events, rv = api2.events_since(api2.current_rv)
    assert events == [] and rv == api2.current_rv
    api2.create(new_resource("ConfigMap", "c", spec={}))
    events, _ = api2.events_since(rv)
    assert [e[1] for e in events] == ["ADDED"]


def test_snapshot_compaction_truncates_wal(tmp_path):
    api = _server(tmp_path, snapshot_every=5)
    for i in range(12):
        api.create(new_resource("ConfigMap", f"cm-{i}", spec={"i": i}))
    wal_lines = [line for line in
                 (tmp_path / "state" / "wal.log").read_text().splitlines() if line]
    assert len(wal_lines) == 2
    del api

    api2 = _server(tmp_path)
    assert len(api2.list("ConfigMap")) == 12
    assert api2.current_rv == 12


def test_torn_tail_is_dropped(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.create(new_resource("ConfigMap", "b", spec={}))
    del api
    wal = tmp_path / "state" / "wal.log"
    wal.write_bytes(wal.read_bytes()[:-20])  # a crash mid-append

    api2 = _server(tmp_path)
    assert [r.metadata.name for r in api2.list("ConfigMap")] == ["a"]
    assert api2.current_rv == 1


def test_future_format_is_refused(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.close()
    snap_path = tmp_path / "state" / "snapshot.json"
    snap = json.loads(snap_path.read_text())
    snap["format"] = persist.FORMAT + 1
    snap_path.write_text(json.dumps(snap))
    with pytest.raises(Invalid, match="format"):
        _server(tmp_path)


def test_graceful_close_then_reopen(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.close()
    assert (tmp_path / "state" / "wal.log").read_text() == ""
    api2 = _server(tmp_path)
    assert api2.get("ConfigMap", "a").metadata.name == "a"


def test_crash_between_snapshot_and_truncate_is_safe(tmp_path):
    api = _server(tmp_path)
    obj = api.create(new_resource("ConfigMap", "a", spec={"v": 1})).thaw()
    obj.spec["v"] = 2
    api.update(obj)
    api.checkpoint()
    del api
    state = tmp_path / "state"
    stale = {"rv": 1, "event": "ADDED",
             "object": new_resource("ConfigMap", "a", spec={"v": 666}).to_dict()}
    existing = (state / "wal.log").read_text()
    (state / "wal.log").write_text(json.dumps(stale) + "\n" + existing)

    api2 = _server(tmp_path)
    assert api2.get("ConfigMap", "a").spec == {"v": 2}


def test_non_durable_server_has_no_side_effects(tmp_path):
    api = FakeApiServer()
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.checkpoint()  # a no-op without persistence
    api.close()
    assert list(tmp_path.iterdir()) == []


def test_pywal_matches_native_layout(tmp_path):
    """JAX's case holds its two WAL backends to one layout; the port has
    one backend, held to JAX's Python WAL both ways: a directory written
    by the JAX store restores in the port, and one the port went on
    writing restores in JAX's."""
    japi = _jax_server(tmp_path)
    japi.create(j_new_resource("ConfigMap", "a", spec={"k": "v"}))
    japi.checkpoint()
    japi.create(j_new_resource("ConfigMap", "b", spec={}))
    jb = japi.get("ConfigMap", "b").to_dict()
    del japi  # the tail stays in the WAL

    api2 = _server(tmp_path)
    assert {r.metadata.name for r in api2.list("ConfigMap")} == {"a", "b"}
    assert api2.get("ConfigMap", "b").to_dict() == jb
    api2.create(new_resource("ConfigMap", "c", spec={}))
    c = api2.get("ConfigMap", "c").to_dict()
    del api2

    japi3 = _jax_server(tmp_path)
    assert {r.metadata.name for r in japi3.list("ConfigMap")} == {"a", "b", "c"}
    assert japi3.get("ConfigMap", "c").to_dict() == c
    assert japi3.current_rv == 3
    japi3.close()


def test_acked_write_after_torn_tail_survives_next_restart(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "a", spec={}))
    api.create(new_resource("ConfigMap", "b", spec={}))
    del api
    wal = tmp_path / "state" / "wal.log"
    wal.write_bytes(wal.read_bytes()[:-20])

    api2 = _server(tmp_path)
    api2.create(new_resource("ConfigMap", "c", spec={}))
    del api2

    api3 = _server(tmp_path)
    assert {r.metadata.name for r in api3.list("ConfigMap")} == {"a", "c"}


def test_wal_failure_fail_stops_the_store(tmp_path):
    api = _server(tmp_path)
    api.create(new_resource("ConfigMap", "good", spec={"k": "v"}))
    real_wal = api._wal

    class _BrokenWal:
        def append(self, line):
            raise OSError("disk full")

        def snapshot(self, text):
            raise OSError("disk full")

        def close(self):
            real_wal.close()

    api._wal = _BrokenWal()
    with pytest.raises(Unavailable):
        api.create(new_resource("ConfigMap", "lost", spec={"k": "v"}))
    for op in (
        lambda: api.get("ConfigMap", "lost"),
        lambda: api.get("ConfigMap", "good"),
        lambda: api.list("ConfigMap"),
        lambda: api.events_since(0),
        lambda: api.create(new_resource("ConfigMap", "later")),
        lambda: api.delete("ConfigMap", "good"),
    ):
        with pytest.raises(Unavailable):
            op()
    api.close()  # must not snapshot the divergent state
    reopened = _server(tmp_path)
    assert reopened.get("ConfigMap", "good").spec["k"] == "v"
    with pytest.raises(NotFound):
        reopened.get("ConfigMap", "lost")
    reopened.close()


def test_writer_racing_a_fail_stop_cannot_commit_unlogged(tmp_path):
    api = _server(tmp_path)
    api._broken = RuntimeError("disk full")  # as _fail_stop_locked leaves it
    api._wal.close()
    api._wal = None
    with api._lock:
        with pytest.raises(Unavailable):
            api._emit("ADDED", new_resource("ConfigMap", "racy"))


# -- the port against the JAX package -----------------------------------------


def _script(new, api) -> None:
    """One write sequence: creates, a spec update, status updates, a
    delete with an owner cascade, a lease."""
    owner = api.create(new("TpuJob", "job", spec={"replicas": 2}))
    for i in range(3):
        pod = new("Pod", f"job-{i}", spec={"i": i})
        pod.metadata.owner_references = [{"kind": "TpuJob", "name": "job",
                                          "uid": owner.metadata.uid}]
        pod.metadata.labels = {"job": "job"}
        api.create(pod)
    job = api.get("TpuJob", "job").thaw()
    job.spec["replicas"] = 3
    api.update(job)
    for step in range(1, 4):
        job = api.get("TpuJob", "job").thaw()
        job.status = {"metrics": [{"step": s, "loss": 1.0 / s} for s in range(1, step + 1)]}
        api.update_status(job)
    api.create(new("Lease", "apiserver", "", spec={"holderIdentity": "a"}))
    api.create(new("ConfigMap", "doomed", spec={}))
    api.delete("ConfigMap", "doomed")
    api.delete("Pod", "job-0")


def _normalized(objs, uids) -> list:
    """to_dict of each object with uids renamed by first appearance and
    creation timestamps dropped (both are minted per store)."""
    out = []
    for o in objs:
        d = o.to_dict()
        d["metadata"]["uid"] = uids.setdefault(d["metadata"]["uid"], len(uids))
        d["metadata"].pop("creationTimestamp")
        for ref in d["metadata"]["ownerReferences"]:
            ref["uid"] = uids.setdefault(ref["uid"], len(uids))
        out.append(d)
    return out


@pytest.mark.parametrize("snapshot_every", [1000, 4])
def test_same_writes_restore_equal_in_both_packages(tmp_path, snapshot_every):
    """One write sequence through JAX's durable store and the port's,
    each restored over its own directory: equal objects and rv, and WAL
    records of one shape."""
    j = JFakeApiServer(persist_dir=str(tmp_path / "jax"), wal_backend="python",
                       snapshot_every=snapshot_every)
    t = FakeApiServer(persist_dir=str(tmp_path / "port"), snapshot_every=snapshot_every)
    _script(j_new_resource, j)
    _script(new_resource, t)
    for d in ("jax", "port"):
        lines = (tmp_path / d / "wal.log").read_text().splitlines()
        assert all(sorted(json.loads(x)) == ["event", "object", "rv"] for x in lines)
    del j, t
    j = JFakeApiServer(persist_dir=str(tmp_path / "jax"), wal_backend="python")
    t = FakeApiServer(persist_dir=str(tmp_path / "port"))
    assert t.current_rv == j.current_rv
    assert t.kinds() == j.kinds()
    for kind in j.kinds():
        assert _normalized(t.list(kind), {}) == _normalized(j.list(kind), {}), kind
    j.close()
    t.close()


def test_open_wal_takes_the_python_backend_only(tmp_path):
    """The Python backend is taken only by name: `open_wal` opens the
    compiled WAL by default and `PyWal` for ``backend="python"``. Both
    write the same files as JAX's `PyWal` for the same appends and
    snapshot."""
    from kubeflow_tpu.testing import persist as j_persist
    from kubeflow_tpu_torch.native.core import NativeWal

    assert isinstance(persist.open_wal(str(tmp_path / "default")), NativeWal)
    with pytest.raises(ValueError, match="unknown wal backend"):
        persist.open_wal(str(tmp_path / "auto"), "auto")
    dirs = {"jax": tmp_path / "jax", "native": tmp_path / "native", "python": tmp_path / "python"}
    for name, d in dirs.items():
        wal = (j_persist.open_wal(str(d), "python") if name == "jax"
               else persist.open_wal(str(d), backend=name))
        assert type(wal).__name__ == {"jax": "PyWal", "native": "NativeWal",
                                      "python": "PyWal"}[name]
        wal.append('{"rv":1}')
        wal.snapshot('{"format":1,"rv":1,"objects":[]}')
        wal.append('{"rv":2}')
        wal.close()
    for name in ("wal.log", "snapshot.json"):
        for d in ("native", "python"):
            assert (dirs[d] / name).read_bytes() == (dirs["jax"] / name).read_bytes()
    for d in dirs.values():
        assert sorted(p.name for p in d.iterdir()) == ["snapshot.json", "wal.log"]


def test_lease_store_answers_a_cas_sequence_as_jax_does(tmp_path):
    """The same get/create/update sequence, stale resourceVersions
    included, against both packages' FileLeaseStore: the same answers,
    and each reads the lease file the other wrote."""
    def run(mod, new, directory):
        leases = mod.FileLeaseStore(str(directory))
        out = []
        for step in (
            lambda: leases.get("Lease", "apiserver"),
            lambda: leases.create(new("Lease", "apiserver", "", spec={"holderIdentity": "a"})),
            lambda: leases.create(new("Lease", "apiserver", "", spec={})),
            lambda: leases.get("Lease", "apiserver"),
        ):
            try:
                got = step()
                out.append((got.metadata.resource_version, dict(got.spec)))
            except Exception as e:
                out.append(type(e).__name__)
        lease = leases.get("Lease", "apiserver").thaw()
        lease.spec = {"holderIdentity": "b", "leaseTransitions": 2}
        out.append(leases.update(lease).metadata.resource_version)
        lease.metadata.resource_version = 1  # stale
        try:
            leases.update(lease)
        except Exception as e:
            out.append(type(e).__name__)
        out.append(leases.read_spec("apiserver"))
        with pytest.raises(ValueError, match="invalid lease name"):
            leases.create(new("Lease", "../x", "", spec={}))
        return out

    got_jax = run(j_failover, j_new_resource, tmp_path / "jax")
    got_port = run(failover, new_resource, tmp_path / "port")
    assert got_port == got_jax
    assert got_port[0] == "NotFound" and got_port[2] == "AlreadyExists"
    assert got_port[-2] == "Conflict"
    # Each package reads the other's lease file.
    assert (failover.FileLeaseStore(str(tmp_path / "jax")).read_spec("apiserver")
            == j_failover.FileLeaseStore(str(tmp_path / "port")).read_spec("apiserver"))


def test_fenced_store_fail_stops_once_the_term_moves(tmp_path):
    """A store opened by `open_active_store` for term (a, 1) acks writes
    while the lease shows that term; once another holder takes the lease
    its next write raises WalFenced inside, fail-stops the store
    (Unavailable, nothing applied), and the successor's takeover finds
    every write the first store acked."""
    leases = failover.FileLeaseStore(str(tmp_path / "lease"))
    leases.create(new_resource("Lease", "apiserver", "",
                               spec={"holderIdentity": "a", "leaseTransitions": 1}))
    store = str(tmp_path / "store")
    api = failover.open_active_store(store, leases, "apiserver", "a", 1)
    api.create(new_resource("ConfigMap", "acked", spec={}))

    lease = leases.get("Lease", "apiserver").thaw()
    lease.spec = {"holderIdentity": "b", "leaseTransitions": 2}
    leases.update(lease)
    with pytest.raises(Unavailable, match="fail-stopped"):
        api.create(new_resource("ConfigMap", "late", spec={}))
    with pytest.raises(Unavailable):
        api.get("ConfigMap", "acked")
    api.close()  # no checkpoint over the successor's log

    successor = failover.open_active_store(store, leases, "apiserver", "b", 2)
    assert [o.metadata.name for o in successor.list("ConfigMap")] == ["acked"]
    successor.create(new_resource("ConfigMap", "after", spec={}))
    successor.close()
    with pytest.raises(failover.WalFenced):
        failover.term_fence(leases, "apiserver", "a", 1)(persist.PyWal(store)).append("{}")


def test_takeover_moves_the_wal_to_a_new_inode(tmp_path):
    """A deposed active that still holds the old log's fd appends into a
    file no restart replays: the takeover's checkpoint renamed a fresh
    log over ``wal.log``. On both of the port's WAL backends (JAX's
    compiled one truncates in place, which is why JAX pins its HA stores
    to its Python WAL)."""
    for backend in persist.BACKENDS:
        store = tmp_path / backend / "store"
        old = FakeApiServer(persist_dir=str(store), wal_backend=backend)
        old.create(new_resource("ConfigMap", "a", spec={}))
        inode = os.stat(store / "wal.log").st_ino
        leases = failover.FileLeaseStore(str(tmp_path / backend / "lease"))
        leases.create(new_resource("Lease", "apiserver", "",
                                   spec={"holderIdentity": "b", "leaseTransitions": 1}))
        new = failover.open_active_store(str(store), leases, "apiserver", "b", 1,
                                         wal_backend=backend)
        assert new.wal_backend == backend
        assert os.stat(store / "wal.log").st_ino != inode, backend
        old.create(new_resource("ConfigMap", "orphaned", spec={}))  # the deposed one's write
        new.create(new_resource("ConfigMap", "b", spec={}))
        del old, new
        restored = FakeApiServer(persist_dir=str(store), wal_backend=backend)
        assert {o.metadata.name for o in restored.list("ConfigMap")} == {"a", "b"}, backend
        restored.close()


def test_the_takeover_runs_on_the_compiled_wal_by_default(tmp_path):
    """`open_active_store` pins no backend: the store it opens writes
    through the compiled WAL, as every durable store of the port does."""
    leases = failover.FileLeaseStore(str(tmp_path / "lease"))
    leases.create(new_resource("Lease", "apiserver", "",
                               spec={"holderIdentity": "a", "leaseTransitions": 1}))
    api = failover.open_active_store(str(tmp_path / "store"), leases, "apiserver", "a", 1)
    assert api.wal_backend == "native"
    assert type(api._wal._inner).__name__ == "NativeWal"
    api.close()


def test_native_snapshot_orphans_a_deposed_fd(tmp_path):
    """Two handles on one directory, the second opened first (a deposed
    active's): after the live handle's snapshot, the old handle's
    appends land in the orphaned inode and never in what a restart
    reads; the live handle's do."""
    from kubeflow_tpu_torch.native.core import NativeWal

    d = tmp_path / "state"
    deposed = NativeWal(str(d))
    live = NativeWal(str(d))
    live.append('{"rv":1}')
    deposed.append('{"rv":2}')  # before the snapshot: the same, live log
    assert live.read_journal() == '{"rv":1}\n{"rv":2}\n'
    inode = os.stat(d / "wal.log").st_ino
    live.snapshot('{"format":1,"rv":2,"objects":[]}')
    assert os.stat(d / "wal.log").st_ino != inode
    assert not (d / "wal.log.tmp").exists()
    deposed.append('{"rv":3,"deposed":true}')
    live.append('{"rv":3}')
    assert live.read_journal() == '{"rv":3}\n'
    deposed.close()
    live.close()
    reopened = persist.open_wal(str(d), backend="python")
    assert reopened.read_journal() == '{"rv":3}\n'
    assert reopened.read_snapshot() == '{"format":1,"rv":2,"objects":[]}'
    reopened.close()


@pytest.mark.parametrize("backend", persist.BACKENDS)
def test_a_directory_restores_across_both_packages(tmp_path, backend):
    """The format contract of `testing/persist.py`: a directory the
    port's store wrote (on either backend; a snapshot and a WAL tail)
    restores in JAX's `FakeApiServer(wal_backend="python")`, which goes
    on writing, and the port restores what JAX wrote after it."""
    api = FakeApiServer(persist_dir=str(tmp_path / "state"), wal_backend=backend)
    api.create(new_resource("ConfigMap", "a", spec={"k": "v"}))
    api.checkpoint()
    api.create(new_resource("ConfigMap", "b", spec={}))
    port = {o.metadata.name: o.to_dict() for o in api.list("ConfigMap")}
    del api  # the tail stays in the WAL

    japi = _jax_server(tmp_path)
    assert {o.metadata.name: o.to_dict() for o in japi.list("ConfigMap")} == port
    japi.create(j_new_resource("ConfigMap", "c", spec={}))
    japi.delete("ConfigMap", "a")
    jax = {o.metadata.name: o.to_dict() for o in japi.list("ConfigMap")}
    jrv = japi.current_rv
    del japi

    api2 = FakeApiServer(persist_dir=str(tmp_path / "state"), wal_backend=backend)
    assert {o.metadata.name: o.to_dict() for o in api2.list("ConfigMap")} == jax
    assert api2.current_rv == jrv == 4
    api2.close()


def test_lease_store_create_races_through_already_exists(tmp_path):
    leases = failover.FileLeaseStore(str(tmp_path))
    leases.create(new_resource("Lease", "x", "", spec={}))
    with pytest.raises(AlreadyExists):
        leases.create(new_resource("Lease", "x", "", spec={}))
    stale = leases.get("Lease", "x").thaw()
    leases.update(stale)
    with pytest.raises(Conflict):
        leases.update(stale)
    (tmp_path / "garbage.json").write_text("{not json")
    assert leases.read_spec("garbage") is None
