"""The control plane's durable store: a write-ahead log and a snapshot.

Counterpart of `kubeflow_tpu/testing/persist.py` (a module with no JAX
in it), with the same on-disk format, so a directory written by either
package restores in the other:

    <dir>/snapshot.json   full state {format, rv, objects}
    <dir>/wal.log         one JSON record {rv, event, object} per committed write

Two backends keep one crash-safety contract and write the same bytes:
the compiled WAL (`native/core.NativeWal`, the port's copy of
``wal.cc``), which `open_wal` opens by default, and `PyWal`, its Python
twin, chosen only by name (``backend="python"``). An append returns only
after fdatasync; a snapshot is tmp + fsync + rename + dirsync before the
WAL is truncated, and the truncate is by replacement (a fresh file
renamed over ``wal.log``, so the log moves to a new inode and a deposed
process still holding the old fd appends into an orphan no restart
replays). A crash between the snapshot and the truncate leaves stale
WAL records, which the reader skips by rv.

JAX's compiled WAL truncates ``wal.log`` in place, which would leave a
deposed active's fd on the live log, so the JAX package pins its HA
stores to its Python WAL; the port's copy does not, and its HA stores
run on the compiled WAL too (`testing/failover.py`). JAX's `open_wal`
falls back to the Python backend when the compiled one cannot be built;
the port's raises.
"""

from __future__ import annotations

import os

# Snapshot format: the store refuses a snapshot of another format
# rather than guess at a migration.
FORMAT = 1


def _write_all(fd: int, data: bytes) -> None:
    while data:
        data = data[os.write(fd, data):]


class PyWal:
    """The WAL and snapshot files of one store directory: the compiled
    WAL's Python twin."""

    def __init__(self, directory: str):
        self._dir = str(directory)
        os.makedirs(self._dir, mode=0o700, exist_ok=True)
        self._dir_fd = os.open(self._dir, os.O_RDONLY | os.O_DIRECTORY)
        self._fd = os.open(self._wal_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o600)
        # The wal.log entry itself must be durable from the start: an
        # append syncs the file's data only, and a file whose directory
        # entry was never synced can vanish in a crash with every acked
        # write in it.
        os.fsync(self._dir_fd)

    @property
    def _wal_path(self) -> str:
        return os.path.join(self._dir, "wal.log")

    @property
    def _snap_path(self) -> str:
        return os.path.join(self._dir, "snapshot.json")

    def close(self) -> None:
        for attr in ("_fd", "_dir_fd"):
            fd = getattr(self, attr, None)
            if fd is not None:
                os.close(fd)
                setattr(self, attr, None)

    def append(self, line: str) -> None:
        _write_all(self._fd, (line + "\n").encode())
        os.fdatasync(self._fd)

    def snapshot(self, text: str) -> None:
        tmp = self._snap_path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            _write_all(fd, text.encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, self._snap_path)
        os.fsync(self._dir_fd)
        # The snapshot is durable: now the WAL may shrink, by replacement
        # (see the module docstring). A crash between the two renames
        # leaves the pre-snapshot records, which replay skips by rv.
        wal_tmp = self._wal_path + ".tmp"
        fresh = os.open(wal_tmp, os.O_WRONLY | os.O_APPEND | os.O_CREAT | os.O_TRUNC, 0o600)
        os.rename(wal_tmp, self._wal_path)
        os.close(self._fd)
        self._fd = fresh
        os.fsync(self._dir_fd)

    @staticmethod
    def _read(path: str) -> str:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def read_snapshot(self) -> str:
        return self._read(self._snap_path)

    def read_journal(self) -> str:
        return self._read(self._wal_path)


BACKENDS = ("native", "python")


def open_wal(directory: str, backend: str = "native"):
    """Open a store directory on the compiled WAL (``native``, the
    default; raises if it cannot be built or loaded) or on `PyWal`
    (``python``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown wal backend {backend!r}; one of {BACKENDS}")
    if backend == "python":
        return PyWal(directory)
    from kubeflow_tpu_torch.native.core import NativeWal

    return NativeWal(directory)
