"""Build and load the port's host-side native libraries.

Each library in `LIBRARIES` is compiled from its sources in ``csrc/`` by
one call of the host's C++ compiler (``c++ -O2 -std=c++17 -shared -fPIC
-pthread``) into a shared library with a plain C interface, loaded with
`ctypes`:

- ``dataloader``: the record loader (``dataloader.cc``);
- ``kftpu_core``: the control plane's JSON, work queue, object store and
  write-ahead log (``json.cc``, ``workqueue.cc``, ``store.cc``,
  ``wal.cc``), as the JAX package's CMake target of that name;
- ``kftpu_sched``: the gang scheduler (``scheduler.cc``).

Libraries go to ``build/kubeflow_tpu_torch/`` at the repository root,
named by a hash of their sources, every header and the flags, so an
unchanged library is built once; no cmake or ninja. Each build writes a
file of its own (named by its pid) and moves it into place with one
atomic rename, so a process never loads a partial library; an exclusive
`flock` on ``lib<name>.lock`` there makes processes that start at the
same time (a test run's workers, a manager's first controllers) wait
for one compiler instead of each running its own. Nothing is built at import: only at a library's first
use. A missing compiler or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubeflow_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBRARIES = {
    "dataloader": ("dataloader.cc",),
    "kftpu_core": ("json.cc", "workqueue.cc", "store.cc", "wal.cc"),
    "kftpu_sched": ("scheduler.cc",),
}

_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no host C++ compiler (c++) on PATH; the port's native libraries are "
            "built from kubeflow_tpu_torch/native/csrc at first use"
        )
    return cxx


def sources(name: str) -> tuple[Path, ...]:
    return tuple(CSRC / src for src in LIBRARIES[name])


def source_digest(paths, flags=CXX_FLAGS) -> str:
    """A hash of `paths` (names and bytes), every header in ``csrc/`` and
    `flags`: what names a built file."""
    digest = hashlib.sha256()
    for src in paths:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def target(name: str) -> Path:
    """Where library `name` is built."""
    return BUILD_DIR / f"lib{name}-{source_digest(sources(name))}.so"


def build(name: str) -> Path:
    """Build library `name` unless it is built; returns its path."""
    out = target(name)
    with _build_lock:
        if out.exists():
            return out
        cxx = _cxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources(name))],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"c++ failed on lib{name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
    return out


def load(name: str, configure) -> ctypes.CDLL:
    """Library `name`, built first if need be and loaded once per process;
    `configure(lib)` declares its C ABI (argtypes/restypes) on first load.
    `ctypes.CDLL`, not `PyDLL`: every call releases the GIL."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build(name)
    with _build_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            configure(lib)
            _libs[name] = lib
        return _libs[name]
