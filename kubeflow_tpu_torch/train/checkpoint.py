"""Checkpoint and auto-resume with crash-consistent, verified saves.

Counterpart of `kubeflow_tpu/train/checkpoint.py`, with orbax playing no
role: the state (`TrainState.state_dict()`, a tree of dicts of tensors)
goes to files in a numbered step directory, one `torch.save` file per
top-level entry (``step.pt``, ``params.pt``, ``opt_state.pt``,
``guard.pt``), written from CPU copies. The JAX module's durability
contract holds as written:

- **Asynchronous saves.** `save` copies the state off the device at the
  step boundary (the only part the step loop waits for) and hands the
  copy to one background thread, which writes the files into
  ``<step>.partial``, fsyncs them, renames the directory to ``<step>``
  (the commit) and then writes the manifest. Retention (``max_to_keep``)
  evicts the oldest steps after each commit.
- **Verification manifest.** ``kftpu_manifest.json`` in each step
  directory holds the size and sha256 of every other file there, plus
  the data iterator's `state_dict()` captured at the step boundary; it
  is written atomically (tmp + fsync + rename), so its presence
  certifies a complete, uncorrupted step. A step without one (a crash
  between commit and manifest) is garbage to restore.
- **Fallback restore.** `restore_latest` verifies the newest step
  against its manifest; a step that fails is quarantined (renamed
  ``corrupt-<step>``, out of the numeric namespace) and the next-newest
  is tried. Restored tensors are put on the template's device (the
  trainer's).
- **Single writer.** One process owns a directory's mutations; every
  other reader opens it ``read_only`` (saves refused, invalid steps
  skipped without renaming, the directory never created).

Out of scope: reading the orbax checkpoints that the JAX package writes.
"""

from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, NamedTuple

import torch

from kubeflow_tpu_torch.train.trainer import map_tensors
from kubeflow_tpu_torch.utils import threads

log = logging.getLogger(__name__)

# Inside each step dir, beside the state files; the checksums cover every
# file except the manifest itself.
MANIFEST_NAME = "kftpu_manifest.json"
# Non-numeric prefix: invisible to the step scan.
QUARANTINE_PREFIX = "corrupt-"
# A step being written; renamed to the bare step number when complete.
PARTIAL_SUFFIX = ".partial"


class Restored(NamedTuple):
    """`restore_latest`'s result: the state tree, the step it was saved
    at, and the data-iterator state captured at that boundary (None for
    checkpoints saved without one)."""

    state: Any
    step: int
    data_state: dict | None


def _file_digest(path: Path) -> tuple[int, str]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            size += len(chunk)
            h.update(chunk)
    return size, h.hexdigest()


def _digests(paths: list[Path]) -> list[tuple[int, str]]:
    """`_file_digest` of each path, hashed in parallel (hashlib releases
    the GIL on large buffers)."""
    if len(paths) < 2:
        return [_file_digest(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(min(8, len(paths))) as pool:
        return list(pool.map(_file_digest, paths))


def write_manifest(step_dir: Path, data_state: dict | None) -> dict:
    """Checksum every file under `step_dir` and write the manifest
    atomically. Returns the manifest dict."""
    paths = [
        p for p in sorted(step_dir.rglob("*"))
        # Skip the manifest and any leftover .tmp of a failed attempt.
        if p.is_file() and not p.name.startswith(MANIFEST_NAME)
    ]
    if not paths:
        # Nothing to certify (retention emptied the directory under us):
        # a vacuous manifest would verify and restore nothing.
        raise FileNotFoundError(f"no files to certify under {step_dir}")
    files = {
        str(p.relative_to(step_dir)): {"size": size, "sha256": digest}
        for p, (size, digest) in zip(paths, _digests(paths))
    }
    manifest = {"version": 1, "files": files, "data_state": data_state}
    _replace_manifest(step_dir, manifest)
    return manifest


def _replace_manifest(step_dir: Path, manifest: dict) -> None:
    tmp = step_dir / (MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # The rename is the commit point: a crash leaves no manifest (the step
    # is unverifiable, restore falls back) or a complete one.
    os.replace(tmp, step_dir / MANIFEST_NAME)


def verify_manifest(step_dir: Path) -> dict | None:
    """The manifest if `step_dir` is a complete, uncorrupted checkpoint;
    None for anything else (missing or garbled manifest, missing file,
    size or checksum mismatch)."""
    try:
        with open(step_dir / MANIFEST_NAME) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError, TypeError):
        return None
    if not isinstance(files, dict) or not files:
        # A manifest that certifies no file certifies nothing.
        return None
    if not all(isinstance(want, dict) for want in files.values()):
        return None
    try:
        got = _digests([step_dir / rel for rel in files])
    except OSError:
        return None
    for want, (size, digest) in zip(files.values(), got):
        if size != want.get("size") or digest != want.get("sha256"):
            return None
    return manifest


@functools.lru_cache(maxsize=256)
def _verified(step_dir: str, stamp: tuple) -> bool:
    return verify_manifest(Path(step_dir)) is not None


def holds_step(directory: str | Path, step: int) -> bool:
    """Whether `directory` holds `step` committed and verified against
    its manifest: the step `Checkpointer.restore_latest(prefer_step=)`
    restores. The verdict is cached per stamp of the step's files (name,
    inode, size, mtime), so asking again about an unchanged step costs a
    few stats instead of hashing the step."""
    step_dir = Path(directory) / str(step)
    try:
        stamp = tuple(sorted(
            (p.name, st.st_ino, st.st_size, st.st_mtime_ns)
            for p in step_dir.iterdir() for st in (p.stat(),)
        ))
    except OSError:
        return False
    return _verified(str(step_dir.absolute()), stamp)


def _conform(tree: Any, template: Any, where: str = "state") -> Any:
    """`tree` (as loaded, on the CPU) checked against `template`'s layout,
    shapes and dtypes, each tensor put on its spec's device."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            have = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(
                f"checkpoint {where} holds {have}, the template "
                f"{sorted(template)}"
            )
        return {k: _conform(tree[k], template[k], f"{where}/{k}") for k in template}
    if template is None:
        if tree is not None:
            raise ValueError(f"checkpoint {where} holds a value, the template None")
        return None
    if not isinstance(tree, torch.Tensor) or (
        tuple(tree.shape) != tuple(template.shape) or tree.dtype != template.dtype
    ):
        have = (f"{tuple(tree.shape)} {tree.dtype}" if isinstance(tree, torch.Tensor)
                else type(tree).__name__)
        raise ValueError(
            f"checkpoint {where} is {have}, the template "
            f"{tuple(template.shape)} {template.dtype}"
        )
    return tree.to(template.device)


class Checkpointer:
    """Numbered, verified, asynchronous saves of `TrainState` trees."""

    def __init__(
        self,
        directory: str | Path,
        *,
        save_interval_steps: int = 100,
        max_to_keep: int = 3,
        verify: bool = True,
        read_only: bool = False,
    ):
        """`read_only=True` marks a restore-only consumer (serving, an
        inspection job): `save()` is refused, the directory is never
        created, and invalid steps are skipped during restore instead of
        quarantined (renaming belongs to the directory's single writer)."""
        self.directory = Path(directory).absolute()
        self.verify = verify
        self.read_only = read_only
        if read_only:
            if not self.directory.is_dir():
                raise FileNotFoundError(
                    f"checkpoint directory {self.directory} does not exist "
                    "(read_only Checkpointer never creates it)"
                )
        else:
            self.directory.mkdir(parents=True, exist_ok=True)
            # A save cut off before its commit left only a partial dir.
            for stale in self.directory.glob("*" + PARTIAL_SUFFIX):
                shutil.rmtree(stale, ignore_errors=True)
        self._save_interval_steps = save_interval_steps
        self._max_to_keep = max_to_keep
        # One writer thread drains (step, host copy, data state) items:
        # the step loop never waits for the disk or the hashing.
        self._queue: queue.Queue = queue.Queue()
        self._errors: list[Exception] = []
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._pending: set[int] = set()

    # -- steps ---------------------------------------------------------------

    def _disk_steps(self) -> list[int]:
        return sorted(
            int(p.name) for p in self.directory.iterdir()
            if p.name.isdigit() and p.is_dir()
        ) if self.directory.is_dir() else []

    def all_steps(self) -> list[int]:
        """Committed steps and those whose save is still in flight."""
        with self._lock:
            pending = set(self._pending)
        return sorted(set(self._disk_steps()) | pending)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """Would `save(step)` write? (orbax's rule: a multiple of the
        interval, past the newest step.)"""
        if self.read_only or not self._save_interval_steps:
            return False
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self._save_interval_steps == 0

    # -- save ----------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        *,
        force: bool = False,
        data_state: dict | None = None,
    ) -> bool:
        """Maybe save (the interval rule unless `force`). `state` is a
        `TrainState` or a tree of dicts of tensors; it is copied off the
        device now and written in the background. `data_state` is the
        data iterator's `state_dict()` at this boundary; it rides in the
        manifest."""
        if self.read_only:
            raise RuntimeError(
                f"Checkpointer({self.directory}) is read_only: save() "
                "refused — only the directory's single writer may write"
            )
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists in {self.directory}")
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        host = map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)
        with self._lock:
            self._pending.add(step)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._write_loop, name="ckpt-writer", daemon=True)
            self._thread.start()
        self._queue.put((step, host, data_state))
        return True

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, host, data_state = item
                try:
                    self._write(step, host, data_state)
                except Exception as e:  # recorded; surfaced by wait()
                    log.exception("checkpoint save for step %s failed", step)
                    self._errors.append(e)
                finally:
                    with self._lock:
                        self._pending.discard(step)
            finally:
                self._queue.task_done()

    def _write(self, step: int, host: dict, data_state: dict | None) -> None:
        partial = self.directory / f"{step}{PARTIAL_SUFFIX}"
        shutil.rmtree(partial, ignore_errors=True)
        partial.mkdir()
        for key, value in host.items():
            with open(partial / f"{key}.pt", "wb") as f:
                torch.save(value, f)
                f.flush()
                os.fsync(f.fileno())
        step_dir = self.directory / str(step)
        os.rename(partial, step_dir)
        _fsync_dir(self.directory)
        write_manifest(step_dir, data_state)
        self._evict()

    def _evict(self) -> None:
        """Retention: remove the oldest committed steps beyond
        ``max_to_keep``."""
        if not self._max_to_keep:
            return
        steps = self._disk_steps()
        for old in steps[:max(0, len(steps) - self._max_to_keep)]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def update_data_state(self, step: int, data_state: dict | None) -> bool:
        """Atomically replace the data-iterator state in an existing
        step's manifest, files and checksums untouched (divergence
        rollback makes its perturbed salt durable with it). False when
        the step has no readable manifest."""
        if self.read_only:
            raise RuntimeError(
                f"Checkpointer({self.directory}) is read_only: "
                "update_data_state() refused"
            )
        step_dir = self.directory / str(step)
        try:
            with open(step_dir / MANIFEST_NAME) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        if not isinstance(manifest, dict):
            return False
        manifest["data_state"] = data_state
        _replace_manifest(step_dir, manifest)
        return True

    # -- restore -------------------------------------------------------------

    def _quarantine(self, step: int) -> None:
        """Move an invalid step out of the numeric namespace, so that a
        later save at the same number does not collide with it."""
        step_dir = self.directory / str(step)
        target = self.directory / f"{QUARANTINE_PREFIX}{step}"
        n = 0
        while target.exists():
            n += 1
            target = self.directory / f"{QUARANTINE_PREFIX}{step}.{n}"
        try:
            os.rename(step_dir, target)
            log.warning("quarantined invalid checkpoint step %d -> %s", step, target.name)
        except OSError:
            if step_dir.exists():
                raise  # can neither clear nor reuse the step
            log.warning("invalid checkpoint step %d disappeared", step)

    def _invalidate(self, step: int) -> None:
        if self.read_only:
            log.warning(
                "read-only restore skipping invalid checkpoint step %d "
                "(the writing process owns quarantine)", step,
            )
        else:
            self._quarantine(step)

    def restore_latest(
        self, template: Any, *, prefer_step: int | None = None
    ) -> Restored | None:
        """The newest valid checkpoint, conformed to `template` (the
        trainer's `abstract_state()`: the layout, with a `TensorSpec` for
        each tensor) and put on its devices; None when there is none.
        With `prefer_step`, that step is tried first (serving restores
        the version its spec names while the directory holds it).

        Every candidate is verified against its manifest first (unless
        ``verify=False``): a torn write, a flipped byte or a garbled
        manifest falls back to the next-newest step, which the writer
        quarantines and a read-only reader skips. A step that verifies
        but does not fit the template raises: the bytes are sound, the
        caller's template is not."""
        self.wait()  # in-flight saves must be on disk with their manifests
        steps = sorted(self._disk_steps(), reverse=True)
        if prefer_step in steps:
            steps.remove(prefer_step)
            steps.insert(0, prefer_step)
        for step in steps:
            step_dir = self.directory / str(step)
            if self.verify:
                manifest = verify_manifest(step_dir)
                if manifest is None:
                    log.warning(
                        "checkpoint step %d failed verification (corrupt, "
                        "torn, or written without a manifest); falling back "
                        "to the previous checkpoint", step,
                    )
                    self._invalidate(step)
                    continue
            else:
                try:
                    with open(step_dir / MANIFEST_NAME) as f:
                        manifest = json.load(f)
                    if not isinstance(manifest, dict):
                        manifest = {}
                except (OSError, ValueError):
                    manifest = {}
            try:
                state = {
                    key: torch.load(step_dir / f"{key}.pt", map_location="cpu",
                                    weights_only=True)
                    for key in template
                }
                state = _conform(state, template)
            except Exception:
                if (
                    self.verify
                    and step_dir.is_dir()
                    and verify_manifest(step_dir) is not None
                ):
                    raise
                log.exception("restore of checkpoint step %d failed; falling back", step)
                self._invalidate(step)
                continue
            log.info("restored checkpoint step=%d from %s", step, self.directory)
            return Restored(state, step, manifest.get("data_state"))
        return None

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> None:
        """Block until in-flight saves are committed with their manifests
        (before exit, so a preemption cannot lose the final save); raise
        what a save met. The wait is bounded (KFTPU_STUCK_TIMEOUT_S)."""
        threads.join_queue(self._queue, what="checkpoint writer queue")
        if self._errors:
            errors, self._errors = self._errors, []
            raise RuntimeError(f"checkpoint saves failed: {errors!r}") from errors[0]

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._thread is not None:
                self._queue.put(None)


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
