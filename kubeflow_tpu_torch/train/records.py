"""Typed record datasets over the port's native loader.

Counterpart of `kubeflow_tpu/train/records.py`. A `RecordSpec` names
fixed-shape fields (fixed-size records are what makes the native
loader's random access O(1)); `RecordDataset` decodes the loader's raw
batches into per-field numpy arrays, as the JAX dataset does, and
`device_iter` delivers them as tensors on one device for the training
loop.

Sharding composes with the TpuJob gang contract: pass
``process_env=ProcessEnv.from_env()`` inside a gang and each process
reads only its shard.

`device_iter` on CUDA: a reader thread has the loader write each batch
into one of two pinned ``[batch, record_bytes]`` host buffers and
copies the buffer to the card in one non-blocking copy on a side
stream; the consumer's stream waits on that copy's event and splits the
fields on the device (byte-column slices viewed as each field's dtype:
uint8 images and int32 labels stay uint8 and int32). A pinned buffer is
refilled only after the event of its previous copy has completed. The
thread reads up to two batches ahead, so the resumable position is the
number of batches *yielded*, never the loader's count.

On a process mesh, ``device_iter(device, mesh=)`` gives each rank its
rows of every global batch (`parallel/sharding.batch_sharding`): a
dataset opened for one process (no ``process_env``) is read whole by
every rank, which keeps its rows, so the position, and the batch a step
gets, are those of one process; a dataset opened with the gang's
``process_env`` already reads each process's own records. ``rebind(mesh)``, the
elastic resize of a live stream, is not ported yet (ROADMAP Queue 1
item 12). Like JAX's, the dataset has no ``perturb``: a guarded run's
divergence rollback refuses it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.native.dataloader import RecordLoader, RecordWriter
from kubeflow_tpu_torch.parallel.distributed import ProcessEnv
from kubeflow_tpu_torch.parallel.sharding import local_batch


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    shape: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * np.prod(self.shape, initial=1))


@dataclasses.dataclass(frozen=True)
class RecordSpec:
    fields: tuple[Field, ...]

    @classmethod
    def of(cls, **fields: tuple[str, tuple[int, ...]]) -> "RecordSpec":
        """RecordSpec.of(image=("uint8", (224, 224, 3)), label=("int32", ()))"""
        return cls(tuple(Field(n, dt, tuple(sh)) for n, (dt, sh) in fields.items()))

    @property
    def record_bytes(self) -> int:
        return sum(f.nbytes for f in self.fields)

    def encode(self, example: Mapping[str, np.ndarray]) -> bytes:
        parts = []
        for f in self.fields:
            arr = np.asarray(example[f.name], dtype=f.dtype).reshape(f.shape)
            parts.append(arr.tobytes())
        return b"".join(parts)

    def decode_batch(self, raw: np.ndarray) -> dict[str, np.ndarray]:
        """[batch, record_bytes] uint8 -> dict of [batch, *shape] arrays
        (each field copied out contiguous)."""
        out: dict[str, np.ndarray] = {}
        offset = 0
        n = raw.shape[0]
        for f in self.fields:
            view = raw[:, offset:offset + f.nbytes]
            out[f.name] = np.ascontiguousarray(view).view(f.dtype).reshape((n, *f.shape))
            offset += f.nbytes
        return out

    def decode_tensor(self, raw: torch.Tensor) -> dict[str, torch.Tensor]:
        """`decode_batch` for a [batch, record_bytes] uint8 tensor, on its
        device: each field's byte columns made contiguous and viewed as
        its dtype."""
        out: dict[str, torch.Tensor] = {}
        offset = 0
        n = raw.shape[0]
        for f in self.fields:
            dtype = torch.from_numpy(np.empty(0, dtype=f.dtype)).dtype
            view = raw[:, offset:offset + f.nbytes].contiguous()
            out[f.name] = view.view(dtype).reshape(n, *f.shape)
            offset += f.nbytes
        return out


def write_records(
    path: str, spec: RecordSpec, examples: Iterator[Mapping[str, np.ndarray]]
) -> int:
    """Write examples to a record file; returns the count."""
    with RecordWriter(path, spec.record_bytes) as w:
        for ex in examples:
            w.append(spec.encode(ex))
        return w.count


class RecordDataset:
    """Decoded batches from record files, and their device iterator.

    Implements the resumable-data protocol: the native loader counts
    batches delivered, `state_dict()` snapshots that position, and
    `load_state_dict` reopens the loader (same paths, seed and shuffle
    args: the native shuffle is a pure function of them) and
    fast-forwards to the snapshot, so a resumed run continues the exact
    batch sequence. The fast-forward drains and discards `position`
    batches: O(position) IO, paid once per resume.
    """

    def __init__(
        self,
        paths: list[str] | str,
        spec: RecordSpec,
        batch_size: int,
        *,
        process_env: ProcessEnv | None = None,
        shuffle_buffer: int = 0,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 2,
        drop_remainder: bool = True,
        epochs: int = 0,
    ):
        env = process_env or ProcessEnv()
        if batch_size % env.num_processes != 0:
            raise ValueError(
                f"global batch {batch_size} must divide evenly over "
                f"{env.num_processes} processes"
            )
        self.spec = spec
        self.global_batch_size = batch_size
        self.local_batch_size = batch_size // env.num_processes
        self._loader_kwargs = dict(
            shard_id=env.process_id,
            shards=env.num_processes,
            shuffle_buffer=shuffle_buffer,
            seed=seed,
            num_threads=num_threads,
            prefetch=prefetch,
            drop_remainder=drop_remainder,
            epochs=epochs,
        )
        self._paths = paths
        self._loader = self._open()
        if self._loader.record_bytes != spec.record_bytes:
            raise ValueError(
                f"file records are {self._loader.record_bytes} bytes but the "
                f"spec decodes {spec.record_bytes}"
            )

    def _open(self) -> RecordLoader:
        return RecordLoader(self._paths, self.local_batch_size, **self._loader_kwargs)

    @property
    def shard_records(self) -> int:
        return self._loader.shard_records

    # -- resumable-data protocol -------------------------------------------

    def state_dict(self) -> dict:
        return {"batches_delivered": self._loader.batches_delivered}

    def load_state_dict(self, state: dict) -> None:
        """Reposition to `state`: reopen the (deterministically seeded)
        loader and fast-forward past the already-consumed batches."""
        target = int(state["batches_delivered"])
        if self._loader.batches_delivered > target:
            self._loader = self._open()
        while self._loader.batches_delivered < target:
            if self._loader.next() is None:
                raise ValueError(
                    f"cannot fast-forward to batch {target}: the stream "
                    f"ended at {self._loader.batches_delivered} (fewer "
                    "epochs than the checkpoint was trained with?)"
                )

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for raw, n in self._loader:
            yield self.spec.decode_batch(raw[:n])

    def device_iter(self, device=None, mesh=None) -> "DeviceIter":
        """Batches as tensors on `device` (CUDA unless the caller names
        another device; without a GPU and without a device it raises); on
        a process `mesh`, this rank's rows of each. The returned iterator
        forwards the resumable-data protocol, so it can be handed straight
        to `fit(..., checkpointer=...)`."""
        return DeviceIter(self, device, mesh)


class _PinnedReader:
    """The CUDA iterator's reader thread: the loader writes into two
    pinned host buffers in turn; each is copied to the card in one
    non-blocking copy on `stream`, and refilled only once that copy's
    event has completed. Up to `depth` copied batches wait in `queue`
    as (device bytes, records, copy event); None ends the stream and an
    exception is passed on."""

    def __init__(self, loader: RecordLoader, device: torch.device, depth: int = 2):
        self._loader = loader
        self._device = device
        shape = (loader.batch_size, loader.record_bytes)
        self._host = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._stream = torch.cuda.Stream(device)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="records-pinned-reader",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            slot = 0
            while not self._stop.is_set():
                if self._copied[slot] is not None:
                    # The previous copy out of this buffer must be done.
                    self._copied[slot].synchronize()
                got = self._loader.next(out=self._host[slot].numpy())
                if got is None:
                    self._put(None)
                    return
                n = got[1]
                with torch.cuda.stream(self._stream):
                    raw = self._host[slot][:n].to(self._device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._copied[slot] = event
                if not self._put((raw, n, event)):
                    return
                slot ^= 1
        except BaseException as e:  # handed to the consumer
            self._put(e)

    def get(self):
        while True:
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    if self._queue.empty():
                        return None
                continue
            if isinstance(item, BaseException):
                raise item
            return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        for event in self._copied:
            if event is not None:
                event.synchronize()


class DeviceIter:
    """A RecordDataset's batches as tensors on one device, with the
    dataset's resumable position reachable from the object the training
    loop holds. Iterable AND an iterator: `iter()` starts a pass at the
    position yielded so far; `next()` on the view itself keeps working.

    The position is the number of batches this view has yielded, which
    the CUDA reader thread's read-ahead never moves: a checkpoint at
    step k holds k."""

    def __init__(self, dataset: RecordDataset, device=None, mesh=None):
        self._dataset = dataset
        whole = dataset.local_batch_size == dataset.global_batch_size
        self.mesh = mesh if mesh is not None and mesh.multiprocess and whole else None
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._position = dataset.state_dict()["batches_delivered"]
        self._reader: _PinnedReader | None = None
        self._gen: Iterator[dict] | None = None

    def state_dict(self) -> dict:
        return {"batches_delivered": self._position}

    def load_state_dict(self, state: dict) -> None:
        self._stop_reader()
        self._dataset.load_state_dict(state)
        self._position = int(state["batches_delivered"])
        # Repositioning may have reopened the loader; a cached direct-
        # next() generator would keep draining the stale one.
        self._gen = None

    def rebind(self, mesh) -> "DeviceIter":
        raise NotImplementedError(
            "rebind(mesh) moves a live stream onto a resized mesh (elastic "
            "resize), which is not ported yet (ROADMAP Queue 1 item 12)"
        )

    def _mine(self, batch: dict) -> dict:
        return batch if self.mesh is None else local_batch(self.mesh, batch)

    def _stop_reader(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __next__(self) -> dict:
        if self._gen is None:
            self._gen = iter(self)
        return next(self._gen)

    def __iter__(self) -> Iterator[dict]:
        # A new pass: batches an earlier pass read ahead are dropped, and
        # the loader goes back to the position yielded so far.
        self._stop_reader()
        if self._dataset.state_dict()["batches_delivered"] != self._position:
            self._dataset.load_state_dict({"batches_delivered": self._position})
        spec = self._dataset.spec
        if self.device.type != "cuda":
            return self._host_pass(spec)
        self._reader = _PinnedReader(self._dataset._loader, self.device)
        return self._cuda_pass(self._reader, spec)

    def _host_pass(self, spec: RecordSpec) -> Iterator[dict]:
        for raw, n in self._dataset._loader:
            batch = spec.decode_tensor(torch.from_numpy(raw[:n]))
            batch = {k: v.to(self.device) for k, v in batch.items()}
            self._position += 1
            yield self._mine(batch)

    def _cuda_pass(self, reader: _PinnedReader, spec: RecordSpec) -> Iterator[dict]:
        try:
            while True:
                item = reader.get()
                if item is None:
                    return
                raw, _, event = item
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                raw.record_stream(stream)
                batch = spec.decode_tensor(raw)
                self._position += 1
                yield self._mine(batch)
        finally:
            reader.close()
