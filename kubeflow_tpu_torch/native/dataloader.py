"""ctypes bindings for the port's record loader (``csrc/dataloader.cc``).

Counterpart of `kubeflow_tpu/native/dataloader.py`, over the port's own
copy of the C++: the same "KFTR" record files (fixed-size records after
a 24-byte header), the same round-robin shards and seeded per-epoch
buffered shuffle, hence the same batch sequence for the same
arguments, and the same API and errors. The blocking ``next`` call
parks in native code without the GIL (`ctypes.CDLL`), so host IO
overlaps device compute in the training loop.

One addition: `RecordLoader.next(out=...)` fills a caller-owned
``[batch_size, record_bytes]`` uint8 buffer, such as a numpy view of a
pinned host tensor bound for the GPU.
"""

from __future__ import annotations

import ctypes

import numpy as np

from kubeflow_tpu_torch.native.build import load


def _configure(lib: ctypes.CDLL) -> None:
    P, S, I32, I64, U64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                           ctypes.c_int64, ctypes.c_uint64)
    lib.kftpu_recwriter_open.restype = P
    lib.kftpu_recwriter_open.argtypes = [S, U64]
    lib.kftpu_recwriter_append.restype = I32
    lib.kftpu_recwriter_append.argtypes = [P, ctypes.c_void_p]
    lib.kftpu_recwriter_close.restype = I64
    lib.kftpu_recwriter_close.argtypes = [P]
    lib.kftpu_recfile_stat.restype = I32
    lib.kftpu_recfile_stat.argtypes = [S, ctypes.POINTER(U64), ctypes.POINTER(U64)]
    lib.kftpu_loader_new.restype = P
    lib.kftpu_loader_new.argtypes = [S, I64, I32, I32, I64, U64, I32, I32, I32, I32]
    lib.kftpu_loader_free.argtypes = [P]
    lib.kftpu_loader_record_bytes.restype = U64
    lib.kftpu_loader_record_bytes.argtypes = [P]
    lib.kftpu_loader_shard_records.restype = I64
    lib.kftpu_loader_shard_records.argtypes = [P]
    lib.kftpu_loader_next.restype = I64
    lib.kftpu_loader_next.argtypes = [P, ctypes.c_void_p]
    lib.kftpu_loader_batches.restype = I64
    lib.kftpu_loader_batches.argtypes = [P]


def _lib() -> ctypes.CDLL:
    return load("dataloader", _configure)


class RecordWriter:
    """Writes fixed-size records; finalizes the header on close."""

    def __init__(self, path: str, record_bytes: int):
        self._lib = _lib()
        self._handle = self._lib.kftpu_recwriter_open(str(path).encode(), record_bytes)
        if not self._handle:
            raise OSError(f"cannot create record file {path!r}")
        self.record_bytes = record_bytes
        self.count = 0

    def append(self, data: bytes | np.ndarray) -> None:
        buf = np.frombuffer(
            data.tobytes() if isinstance(data, np.ndarray) else data, dtype=np.uint8
        )
        if buf.nbytes != self.record_bytes:
            raise ValueError(f"record is {buf.nbytes} bytes, expected {self.record_bytes}")
        if self._lib.kftpu_recwriter_append(
            self._handle, buf.ctypes.data_as(ctypes.c_void_p)
        ) != 0:
            raise OSError("record append failed")
        self.count += 1

    def close(self) -> int:
        if self._handle:
            n = self._lib.kftpu_recwriter_close(self._handle)
            self._handle = None
            if n < 0:
                raise OSError("record file finalize failed")
            return int(n)
        return self.count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stat_record_file(path: str) -> tuple[int, int]:
    """(record_bytes, record_count) of a record file."""
    rb, rc = ctypes.c_uint64(), ctypes.c_uint64()
    if _lib().kftpu_recfile_stat(str(path).encode(), ctypes.byref(rb), ctypes.byref(rc)) != 0:
        raise OSError(f"not a record file: {path!r}")
    return int(rb.value), int(rc.value)


class RecordLoader:
    """Compiled prefetching loader over one or more record files.

    Yields (batch_bytes, n_records): raw uint8 arrays of shape
    [batch_size, record_bytes], of which the first n_records rows hold
    records (fewer than batch_size only for a final short batch with
    ``drop_remainder=False``); typed decoding lives a layer up
    (`kubeflow_tpu_torch.train.records`)."""

    def __init__(
        self,
        paths: list[str] | str,
        batch_size: int,
        *,
        shard_id: int = 0,
        shards: int = 1,
        shuffle_buffer: int = 0,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 2,
        drop_remainder: bool = True,
        epochs: int = 0,
    ):
        if isinstance(paths, str):
            paths = [paths]
        self._lib = _lib()
        self._handle = self._lib.kftpu_loader_new(
            ";".join(str(p) for p in paths).encode(),
            batch_size, shard_id, shards, shuffle_buffer, seed,
            num_threads, prefetch, 1 if drop_remainder else 0, epochs,
        )
        if not self._handle:
            raise ValueError(
                f"cannot open loader over {paths!r} (missing file, "
                "mismatched record sizes, or bad sharding args)"
            )
        self.batch_size = batch_size
        self.record_bytes = int(self._lib.kftpu_loader_record_bytes(self._handle))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kftpu_loader_free(handle)
            self._handle = None

    @property
    def shard_records(self) -> int:
        return int(self._lib.kftpu_loader_shard_records(self._handle))

    @property
    def batches_delivered(self) -> int:
        return int(self._lib.kftpu_loader_batches(self._handle))

    def next(self, out: np.ndarray | None = None) -> tuple[np.ndarray, int] | None:
        """One batch, or None at end of data. Blocks without the GIL.

        `out`, if given, is a C-contiguous uint8 array of shape
        [batch_size, record_bytes] that the batch is written into (and
        returned); by default a new array is allocated."""
        shape = (self.batch_size, self.record_bytes)
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        elif out.dtype != np.uint8 or out.shape != shape or not out.flags.c_contiguous:
            raise ValueError(
                f"out must be a C-contiguous uint8 array of shape {shape}, got "
                f"{out.dtype} {out.shape}"
            )
        n = self._lib.kftpu_loader_next(self._handle, out.ctypes.data_as(ctypes.c_void_p))
        if n < 0:
            raise OSError("native loader IO failure")
        if n == 0:
            return None
        return out, int(n)

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item
