"""Active-passive apiserver failover over one durable state directory.

Counterpart of `kubeflow_tpu/testing/failover.py` (a module with no JAX
in it), whole. N facade processes boot over the same store directory,
but only the one holding the **apiserver lease** opens the store and
serves; the rest park in the standby acquire loop of
`controllers/leader.LeaderElector` (the controllers' elector, pointed at
another lease store):

- The lease cannot live inside the store it gates (the store is closed
  until the lease is won), so `FileLeaseStore` keeps it as a file beside
  the store directory, with the CAS surface the elector expects (get,
  create, update with resourceVersion preconditions) serialized under
  an OS file lock.
- On takeover the new active replays the WAL
  (`FakeApiServer._restore_locked`: snapshot plus WAL tail, torn-tail
  repair, the watch floor re-seeded at the durable rv so older bookmarks
  get 410 and relist), then `checkpoint()`s, which moves ``wal.log`` onto
  a new inode (both WAL backends truncate by replacement, the compiled
  one the store opens by default and `PyWal`): a deposed active still
  holding the old fd appends into an orphan no restart replays. JAX's
  takeover pins its store to the Python WAL, since its compiled WAL
  truncates in place; the port's needs no pin.
- The active's WAL is wrapped in `FencedWal`, which re-reads the lease
  before and after every append and snapshot. Once the term has moved,
  the next durable write raises `WalFenced`, the store fail-stops (every
  operation 503s), clients rotate to the new active through their
  endpoint list, and the deposed process exits. An acked write is
  therefore either in the WAL the successor replayed or was never acked.

Timing is the elector's: with `renew_deadline < lease_duration` a
partitioned active stops acking before a standby's takeover clock can
have expired.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    Conflict,
    FakeApiServer,
    NotFound,
)

log = logging.getLogger(__name__)

LEASE_KIND = "Lease"


class WalFenced(Exception):
    """A durable write was attempted after this process's term ended.
    Not an ApiError on purpose: `FakeApiServer._persist_locked` turns
    any other exception into a fail-stop (every later operation raises
    Unavailable), which is the posture a deposed active must take."""


class FileLeaseStore:
    """Lease CRUD over files in one directory: the get/create/update
    with resourceVersion preconditions that `LeaderElector` needs, for
    the lease that cannot live inside the store it gates. One JSON file
    per lease; every mutation runs under an `flock` on a sibling lock
    file and lands by write-tmp, fsync, rename, so candidates on one host
    serialize as store writers do under the commit lock."""

    def __init__(self, directory: str):
        self._dir = str(directory)
        os.makedirs(self._dir, mode=0o700, exist_ok=True)
        self._lock_path = os.path.join(self._dir, ".lock")
        self._local = threading.Lock()  # flock is per fd: serialize threads too

    def _path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"invalid lease name {name!r}")
        return os.path.join(self._dir, f"{name}.json")

    class _Flock:
        def __init__(self, path: str):
            self._path = path
            self._fd: int | None = None

        def __enter__(self):
            self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o600)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)

    def _read(self, name: str) -> dict | None:
        try:
            with open(self._path(name), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except ValueError:
            # tmp + rename makes a torn lease file unreachable, but a
            # garbage file must read as "no holder", not crash the loop.
            return None

    def _write(self, name: str, record: dict) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            data = json.dumps(record, separators=(",", ":")).encode()
            while data:
                data = data[os.write(fd, data):]
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, path)
        dir_fd = os.open(self._dir, os.O_RDONLY | os.O_DIRECTORY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    @staticmethod
    def _to_resource(name: str, record: dict) -> Resource:
        lease = new_resource(LEASE_KIND, name, "", spec=dict(record.get("spec", {})))
        lease.metadata.resource_version = int(record.get("rv", 0))
        return lease

    # -- the elector's CAS surface ------------------------------------------

    def get(self, kind: str, name: str, namespace: str = "") -> Resource:
        assert kind == LEASE_KIND, kind
        record = self._read(name)
        if record is None:
            raise NotFound(f"Lease {name!r} not found")
        return self._to_resource(name, record)

    def create(self, obj: Resource) -> Resource:
        assert obj.kind == LEASE_KIND, obj.kind
        name = obj.metadata.name
        with self._local, self._Flock(self._lock_path):
            if self._read(name) is not None:
                raise AlreadyExists(f"Lease {name!r} already exists")
            record = {"rv": 1, "spec": dict(obj.spec)}
            self._write(name, record)
        return self._to_resource(name, record)

    def update(self, obj: Resource) -> Resource:
        assert obj.kind == LEASE_KIND, obj.kind
        name = obj.metadata.name
        with self._local, self._Flock(self._lock_path):
            record = self._read(name)
            if record is None:
                raise NotFound(f"Lease {name!r} not found")
            rv = obj.metadata.resource_version
            if rv and rv != int(record["rv"]):
                raise Conflict(
                    f"Lease {name!r}: stale resourceVersion {rv} != {record['rv']}")
            record = {"rv": int(record["rv"]) + 1, "spec": dict(obj.spec)}
            self._write(name, record)
        return self._to_resource(name, record)

    # -- the fence's read surface -------------------------------------------

    def read_spec(self, name: str) -> dict | None:
        """The lease's spec now, or None: lock-free (the file is replaced
        atomically), cheap enough for every WAL append."""
        record = self._read(name)
        return dict(record.get("spec", {})) if record else None


class FencedWal:
    """Term fencing at the durability boundary: every append and snapshot
    checks that the lease still names this process's (holder,
    transitions), BEFORE the write (do not touch a successor's log once
    the term is known to have moved) and AFTER it, before the caller can
    ack. The check after is the one the zero-acked-loss contract rests
    on: with only the check before, the process could be descheduled
    between check and write while the standby wins the lease and replays
    the log, and the late append would be acked and never replayed. The
    successor moves the lease before it reads the log, so a term that
    moved during the write raises `WalFenced`: the write is unacked, and
    the client retries on the successor. Reads and close stay open."""

    def __init__(self, inner, verify):
        self._inner = inner
        self._verify = verify

    def append(self, line: str) -> None:
        self._verify()
        self._inner.append(line)
        self._verify()  # the ack barrier

    def snapshot(self, text: str) -> None:
        self._verify()
        self._inner.snapshot(text)
        self._verify()

    def read_snapshot(self) -> str:
        return self._inner.read_snapshot()

    def read_journal(self) -> str:
        return self._inner.read_journal()

    def close(self) -> None:
        self._inner.close()


def term_fence(leases: FileLeaseStore, name: str, holder: str, transitions: int):
    """A `wal_wrap` for `FakeApiServer` that binds the WAL to one term:
    pass it right after winning the lease."""

    def verify() -> None:
        spec = leases.read_spec(name)
        current = ((spec.get("holderIdentity"), int(spec.get("leaseTransitions", 0)))
                   if spec is not None else None)
        if current != (holder, int(transitions)):
            raise WalFenced(
                f"lease {name!r} is {current} but this store serves term "
                f"({holder!r}, {transitions}): a deposed active must not write "
                "into its successor's log")

    return lambda wal: FencedWal(wal, verify)


def open_active_store(persist_dir: str, leases: FileLeaseStore, lease_name: str,
                      holder: str, transitions: int, **api_kwargs) -> FakeApiServer:
    """The takeover, in order: open the durable store fenced to this term
    (construction replays snapshot and WAL and re-seeds the watch floor),
    then checkpoint, folding the replayed tail into a fresh snapshot and
    moving ``wal.log`` onto a new inode so the deposed predecessor's fd
    is orphaned. Returns the store, ready to serve."""
    api = FakeApiServer(persist_dir=persist_dir,
                        wal_wrap=term_fence(leases, lease_name, holder, transitions),
                        **api_kwargs)
    api.checkpoint()
    return api
