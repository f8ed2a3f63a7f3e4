"""ctypes bindings for the compiled control-plane core (libkftpu_core).

Counterpart of `kubeflow_tpu/native/core.py` (a module with no JAX in
it), over the port's own copy of the C++ sources
(``native/csrc/{json,workqueue,store,wal}.cc``, built by `native/build.py`
at first use):

- ``WorkQueue``: the rate-limited delaying work queue (workqueue.cc)
  every controller of the port rides (`controllers/runtime.make_workqueue`);
- ``NativeStore``: the JSON-object store with K8s storage semantics
  (store.cc): resourceVersion concurrency, spec/status surfaces, label
  selectors, finalizers, owner-ref cascade, namespace drain, the watch
  journal; `native/apiserver.NativeApiServer` serves it;
- ``NativeWal``: the durable WAL and snapshot directory (wal.cc) a
  durable store writes through by default (`testing/persist.open_wal`).
  The port's copy truncates the log by replacement, so a snapshot moves
  ``wal.log`` to a new inode; JAX's truncates it in place.

Blocking calls (``WorkQueue.get``) park in native code: ctypes releases
the GIL for the duration, so idle worker threads cost nothing.
"""

from __future__ import annotations

import ctypes
import json as _json
import os

from kubeflow_tpu_torch.native.build import load

# store.h status codes
STORE_OK = 0
STORE_NOT_FOUND = -1
STORE_ALREADY_EXISTS = -2
STORE_CONFLICT = -3
STORE_BAD_OBJECT = -4


def _configure(lib: ctypes.CDLL) -> None:
    P, S, I32, I64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                      ctypes.c_int64)
    lib.kftpu_wq_new.restype = P
    lib.kftpu_wq_new.argtypes = [I64, I64]
    lib.kftpu_wq_free.argtypes = [P]
    lib.kftpu_wq_add.argtypes = [P, S]
    lib.kftpu_wq_add_after.argtypes = [P, S, I64]
    lib.kftpu_wq_get.restype = I32
    lib.kftpu_wq_get.argtypes = [P, ctypes.c_char_p, I32, I64]
    lib.kftpu_wq_done.argtypes = [P, S]
    lib.kftpu_wq_requeue_error.restype = I64
    lib.kftpu_wq_requeue_error.argtypes = [P, S]
    lib.kftpu_wq_forget.argtypes = [P, S]
    lib.kftpu_wq_len.restype = I64
    lib.kftpu_wq_len.argtypes = [P]
    lib.kftpu_wq_next_ready_ms.restype = I64
    lib.kftpu_wq_next_ready_ms.argtypes = [P]
    lib.kftpu_wq_shutdown.argtypes = [P]

    lib.kftpu_store_new.restype = P
    lib.kftpu_store_free.argtypes = [P]
    lib.kftpu_store_create.restype = S
    lib.kftpu_store_create.argtypes = [P, S]
    lib.kftpu_store_get.restype = S
    lib.kftpu_store_get.argtypes = [P, S, S, S]
    lib.kftpu_store_update.restype = S
    lib.kftpu_store_update.argtypes = [P, S, I32]
    lib.kftpu_store_list.restype = S
    lib.kftpu_store_list.argtypes = [P, S, S, S]
    lib.kftpu_store_delete.restype = I32
    lib.kftpu_store_delete.argtypes = [P, S, S, S]
    lib.kftpu_store_events.restype = S
    lib.kftpu_store_events.argtypes = [P, I64, ctypes.POINTER(I64)]
    lib.kftpu_store_trim.argtypes = [P, I64]
    lib.kftpu_store_len.restype = I64
    lib.kftpu_store_len.argtypes = [P]
    lib.kftpu_store_status.restype = I32
    lib.kftpu_store_error.restype = S

    lib.kftpu_wal_open.restype = P
    lib.kftpu_wal_open.argtypes = [S]
    lib.kftpu_wal_free.argtypes = [P]
    lib.kftpu_wal_append.restype = I32
    lib.kftpu_wal_append.argtypes = [P, S]
    lib.kftpu_wal_snapshot.restype = I32
    lib.kftpu_wal_snapshot.argtypes = [P, S]
    lib.kftpu_wal_read_snapshot.restype = S
    lib.kftpu_wal_read_snapshot.argtypes = [P]
    lib.kftpu_wal_read_journal.restype = S
    lib.kftpu_wal_read_journal.argtypes = [P]
    lib.kftpu_wal_error.restype = S


def _lib() -> ctypes.CDLL:
    return load("kftpu_core", _configure)


def backend_of(obj) -> str:
    """``native`` for the compiled tier's classes (`WorkQueue`,
    `native/scheduler.GangScheduler`), ``python`` for their named twins,
    ``custom`` for anything else (a caller's wrapper): the label of a
    manager's work queues and of ``tpujob_gang_placements_total``."""
    return getattr(type(obj), "tier", "custom")


class WorkQueue:
    """Keyed, deduping, delaying, rate-limited workqueue (native)."""

    tier = "native"
    _KEY_BUF = 4096

    def __init__(self, base_backoff: float = 0.02, max_backoff: float = 30.0):
        self._lib = _lib()
        self._handle = self._lib.kftpu_wq_new(
            max(1, int(base_backoff * 1000)), max(1, int(max_backoff * 1000))
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kftpu_wq_free(handle)
            self._handle = None

    def add(self, key: str, *, after: float = 0.0) -> None:
        if after > 0:
            self._lib.kftpu_wq_add_after(
                self._handle, key.encode(), int(after * 1000)
            )
        else:
            self._lib.kftpu_wq_add(self._handle, key.encode())

    def get(self, timeout: float = 0.0) -> str | None:
        """Dequeue a ready key (None on timeout). timeout=0 polls. The
        caller must balance with done()."""
        buf = ctypes.create_string_buffer(self._KEY_BUF)
        rc = self._lib.kftpu_wq_get(
            self._handle, buf, len(buf), int(timeout * 1000)
        )
        if rc == 1:
            return buf.value.decode()
        if rc == -2:
            raise ValueError("key exceeds buffer")
        return None

    def done(self, key: str) -> None:
        self._lib.kftpu_wq_done(self._handle, key.encode())

    def requeue_error(self, key: str) -> float:
        """Schedule an exponential-backoff retry; returns the delay (s)."""
        return self._lib.kftpu_wq_requeue_error(
            self._handle, key.encode()
        ) / 1000.0

    def forget(self, key: str) -> None:
        self._lib.kftpu_wq_forget(self._handle, key.encode())

    def __len__(self) -> int:
        return int(self._lib.kftpu_wq_len(self._handle))

    def next_ready_in(self) -> float | None:
        """Seconds until the earliest pending key matures; None if empty."""
        ms = self._lib.kftpu_wq_next_ready_ms(self._handle)
        return None if ms < 0 else ms / 1000.0

    def shutdown(self) -> None:
        self._lib.kftpu_wq_shutdown(self._handle)


class StoreError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class NativeStore:
    """Low-level dict-in/dict-out wrapper over the C++ store."""

    def __init__(self):
        self._lib = _lib()
        self._handle = self._lib.kftpu_store_new()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kftpu_store_free(handle)
            self._handle = None

    def _raise(self) -> None:
        code = self._lib.kftpu_store_status()
        msg = (self._lib.kftpu_store_error() or b"").decode()
        raise StoreError(code, msg)

    def _ok(self, out: bytes | None) -> dict | list:
        if out is None:
            self._raise()
        return _json.loads(out.decode())

    def create(self, obj: dict) -> dict:
        return self._ok(
            self._lib.kftpu_store_create(
                self._handle, _json.dumps(obj).encode()
            )
        )

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._ok(
            self._lib.kftpu_store_get(
                self._handle, kind.encode(), namespace.encode(), name.encode()
            )
        )

    def update(self, obj: dict, *, status_only: bool = False) -> dict:
        return self._ok(
            self._lib.kftpu_store_update(
                self._handle, _json.dumps(obj).encode(), 1 if status_only else 0
            )
        )

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        return self._ok(
            self._lib.kftpu_store_list(
                self._handle,
                kind.encode(),
                # None = all namespaces (NULL at the ABI); "" = exactly
                # the cluster scope — the two must stay distinct or
                # list("Lease", namespace="") returns every tenant's
                # leases (FakeApiServer parity).
                None if namespace is None else namespace.encode(),
                _json.dumps(label_selector).encode() if label_selector else None,
            )
        )

    def delete(self, kind: str, namespace: str, name: str) -> None:
        rc = self._lib.kftpu_store_delete(
            self._handle, kind.encode(), namespace.encode(), name.encode()
        )
        if rc != STORE_OK:
            self._raise()

    def events(self, cursor: int) -> tuple[list[dict], int]:
        """Journal entries with seq > cursor, and the new cursor."""
        new_cursor = ctypes.c_int64(cursor)
        out = self._lib.kftpu_store_events(
            self._handle, cursor, ctypes.byref(new_cursor)
        )
        return self._ok(out), new_cursor.value

    def trim(self, cursor: int) -> None:
        self._lib.kftpu_store_trim(self._handle, cursor)

    def __len__(self) -> int:
        return int(self._lib.kftpu_store_len(self._handle))


class WalError(Exception):
    pass


class NativeWal:
    """Durable WAL+snapshot directory (wal.cc): fsync'd appends, atomic
    snapshot replacement, the log truncated by replacement (a new inode).
    The compiled persistence tier `FakeApiServer` stores through; the
    format is `testing/persist.PyWal`'s, byte for byte."""

    def __init__(self, directory: str):
        self._lib = _lib()
        # wal.cc creates the leaf directory only; deep paths are the
        # caller's concern — make them here so both backends accept them.
        os.makedirs(str(directory), mode=0o700, exist_ok=True)
        self._handle = self._lib.kftpu_wal_open(str(directory).encode())
        if not self._handle:
            raise WalError(
                (self._lib.kftpu_wal_error() or b"").decode()
                or f"cannot open wal dir {directory!r}"
            )

    def close(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kftpu_wal_free(handle)
            self._handle = None

    __del__ = close

    def _check(self, rc: int) -> None:
        if rc != 0:
            raise WalError((self._lib.kftpu_wal_error() or b"").decode())

    def append(self, line: str) -> None:
        self._check(self._lib.kftpu_wal_append(self._handle, line.encode()))

    def snapshot(self, text: str) -> None:
        self._check(self._lib.kftpu_wal_snapshot(self._handle, text.encode()))

    def read_snapshot(self) -> str:
        out = self._lib.kftpu_wal_read_snapshot(self._handle)
        if out is None:
            raise WalError((self._lib.kftpu_wal_error() or b"").decode())
        return out.decode()

    def read_journal(self) -> str:
        out = self._lib.kftpu_wal_read_journal(self._handle)
        if out is None:
            raise WalError((self._lib.kftpu_wal_error() or b"").decode())
        return out.decode()
