"""Build and load the port's host-side native libraries.

Each ``csrc/<name>.cc`` is compiled by the host's C++ compiler
(``c++ -O2 -std=c++17 -shared -fPIC -pthread``) into its own shared
library with a plain C interface, loaded with `ctypes`. Libraries go to
``build/kubeflow_tpu_torch/`` at the repository root, named by a hash
of their source, headers and flags, so an unchanged source is built
once; no cmake or ninja. Each build writes a file of its own (named by
its pid) and moves it into place with one atomic rename, so processes
that build at the same time never load a partial library. Nothing is
built at import: only at a library's first use. A missing compiler or a
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubeflow_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no host C++ compiler (c++) on PATH; the port's record loader is "
            "built from kubeflow_tpu_torch/native/csrc at first use"
        )
    return cxx


def target(name: str) -> Path:
    """Where library `name` (``csrc/<name>.cc``) is built."""
    digest = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    for header in sorted(CSRC.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build ``csrc/<name>.cc`` unless it is built; returns the library."""
    out = target(name)
    with _build_lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cc")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"c++ failed on {name}.cc (exit {proc.returncode}):\n"
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
