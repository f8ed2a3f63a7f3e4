"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
its own shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/kubeflow_tpu_torch/`` at the repository root, named by a hash
of their source and flags: an unchanged source is built once. Each
``nvcc`` writes a file of its own (named by its pid) and moves it into
place with one atomic rename, so processes that build at the same time
can at worst compile the same source twice, never leave a partial
library; a launcher that builds before it spawns its workers (as
``chip_smoke.py`` does) spares them the compile. Nothing is
built when this module is imported — only when a kernel is first called
on a CUDA tensor, or when `build` is called — so the CPU tests, which
never launch a kernel, need no CUDA toolkit.

`launches` counts, per kernel, the launches its wrapper made; a run
resets it and reads it to show which path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubeflow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _entry(pointers: int, ints: int = 4):
    """`pointers` device pointers, then `ints` ints — (bh, s, d, dtype),
    or (bh, s_q, s_k, d, causal, dtype) for a rectangular kernel — then
    the stream; returns a cudaError_t."""
    return (
        [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p],
        ctypes.c_int,
    )


_ERROR_STRING = {"kftpu_error_string": ([ctypes.c_int], ctypes.c_char_p)}
# The C entry points of each library: name → (argtypes, restype).
_SIGNATURES = {
    "flash_fwd": {
        "kftpu_flash_fwd": _entry(5),
        "kftpu_flash_fwd_rect": _entry(5, 6),
        # (d, dtype) → the dynamic shared memory of one block, in bytes.
        "kftpu_flash_fwd_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_int),
        **_ERROR_STRING,
    },
    "flash_delta": {"kftpu_flash_delta": _entry(3), **_ERROR_STRING},
    "flash_bwd_dq": {
        "kftpu_flash_bwd_dq": _entry(7),
        "kftpu_flash_bwd_dq_rect": _entry(7, 6),
        # (d, dtype, tensor_cores) → the dynamic shared memory of one
        # block of that body, in bytes.
        "kftpu_flash_bwd_dq_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_int),
        **_ERROR_STRING,
    },
    "flash_bwd_dkv": {
        "kftpu_flash_bwd_dkv": _entry(8),
        "kftpu_flash_bwd_dkv_rect": _entry(8, 6),
        "kftpu_flash_bwd_fused": _entry(10),
        # (d, dtype, tensor_cores, fused) → the dynamic shared memory of
        # one block of that body, in bytes.
        "kftpu_flash_bwd_dkv_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_int),
        **_ERROR_STRING,
    },
}

launches: collections.Counter = collections.Counter()
_launch_lock = threading.Lock()
_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelLaunchError(RuntimeError):
    """A kernel launch the CUDA runtime refused or reported as failed."""


def count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (on PATH or under $CUDA_HOME/bin); the port's "
            "CUDA kernels are built from source at first use"
        )
    return nvcc


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Build the named kernels (default: every ``csrc/*.cu``), one ``nvcc``
    process per source, all started together. Returns, per kernel, the
    library path, whether it was already built (``cached``), the
    seconds the build took, and ptxas's resource report (kept beside the
    library, so a cached build reports it too)."""
    sources = sorted(CSRC.glob("*.cu"))
    if names is not None:
        sources = [s for s in sources if s.stem in set(names)]
        missing = set(names) - {s.stem for s in sources}
        if missing:
            raise ValueError(f"no CUDA source for kernels {sorted(missing)}")
    info: dict[str, dict] = {}
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        start = time.perf_counter()
        for src in sources:
            out = _target(src)
            if out.exists():
                log = out.with_suffix(".ptxas")
                info[src.stem] = {"path": str(out), "cached": True, "seconds": 0.0,
                                  "ptxas": log.read_text() if log.exists() else ""}
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            running.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in running:  # wait for every nvcc
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
                continue
            out.with_suffix(".ptxas").write_text(log)
            os.replace(tmp, out)
            info[src.stem] = {
                "path": str(out), "cached": False,
                "seconds": time.perf_counter() - start, "ptxas": log,
            }
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]["path"]
    with _build_lock:
        if name not in _libs:
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]
