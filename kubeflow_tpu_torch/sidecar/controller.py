"""Gang-worker sidecar: the start gate, the termination watch and the
artifact upload.

Counterpart of `kubeflow_tpu/sidecar/controller.py`, whole, on CUDA:

- **start gate** (`wait_ready`): the device is up, the gang's
  torch.distributed rendezvous address accepts TCP connections, and the
  input dataset is staged; then the sidecar writes a `SIGCONT` file that
  the main container's entrypoint blocks on;
- **termination watch** (`wait_done`): poll the TpuJob through the API
  server every `poll_seconds`; when the job reaches a terminal phase,
  write `SIGTERM` so the worker exits even if its own process hangs (a
  hung collective holds the whole gang otherwise). A vanished job reads
  as Failed; a failed poll is retried;
- **artifact upload** (`upload_results`): stage the results directory
  out to the artifact store (a pluggable callable; `local_dir_uploader`
  copies into a directory);
- the device probe (`default_device_probe`) asks the CUDA driver for
  its devices through `cuInit` and `cuDeviceGetCount` and creates no
  CUDA context: a sidecar does no device work, and a context would hold
  memory on the card.

Everything is injectable, so the sequencing logic is testable without
pods or a GPU.
"""


from __future__ import annotations

import ctypes
import logging
import pathlib
import shutil
import socket
import time
from typing import Callable

from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

log = logging.getLogger(__name__)

# Signal files on the volume shared with the main container
# (`controller.py:10-14` constants).
SIGCONT_FILE = "SIGCONT"
SIGTERM_FILE = "SIGTERM"

TERMINAL_PHASES = ("Succeeded", "Failed")


def parse_hostport(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} must be host:port")
    return host, int(port)


def coordinator_reachable(address: str, timeout: float = 1.0) -> bool:
    """Is the gang's torch.distributed rendezvous address (host:port)
    accepting connections?"""
    host, port = parse_hostport(address)
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def driver_device_count() -> int:
    """The GPUs the CUDA driver reports: the driver API's `cuInit` and
    `cuDeviceGetCount` through ctypes, so no CUDA context is created and
    torch is not imported. 0 where the driver is missing or fails."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def default_device_probe() -> bool:
    """Is the CUDA driver up with at least one device? (the reference's
    `wait for nvidia driver`; `driver_device_count`)."""
    return driver_device_count() > 0


class SidecarController:
    def __init__(
        self,
        *,
        workdir: str | pathlib.Path,
        job_name: str,
        namespace: str = "default",
        # Anything with the FakeApiServer get() surface works — the
        # in-process store or an HttpApiClient pointed at its facade.
        api: FakeApiServer | None = None,
        coordinator: str | None = None,
        coordinator_probe: Callable[[], bool] | None = None,
        device_probe: Callable[[], bool] | None = None,
        download: Callable[[], None] | None = None,
        upload: Callable[[pathlib.Path], None] | None = None,
        poll_seconds: float = 10.0,
        timeout_seconds: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.workdir = pathlib.Path(workdir)
        self.job_name = job_name
        self.namespace = namespace
        self.api = api
        if coordinator_probe is not None:
            self.coordinator_probe = coordinator_probe
        elif coordinator:
            parse_hostport(coordinator)  # fail fast on a malformed flag
            self.coordinator_probe = lambda: coordinator_reachable(coordinator)
        else:
            self.coordinator_probe = lambda: True
        self.device_probe = device_probe or (lambda: True)
        self.download = download
        self.upload = upload
        self.poll_seconds = poll_seconds
        self.timeout_seconds = timeout_seconds
        self.clock = clock
        self.sleep = sleep

    # -- signal files ------------------------------------------------------

    def _signal(self, name: str) -> None:
        self.workdir.mkdir(parents=True, exist_ok=True)
        (self.workdir / name).touch()
        log.info("sidecar: wrote %s", name)

    def has_signal(self, name: str) -> bool:
        return (self.workdir / name).exists()

    # -- phases ------------------------------------------------------------

    def _wait_for(self, what: str, probe: Callable[[], bool]) -> None:
        deadline = self.clock() + self.timeout_seconds
        while not probe():
            if self.clock() >= deadline:
                raise TimeoutError(f"sidecar: timed out waiting for {what}")
            log.info("sidecar: waiting for %s", what)
            self.sleep(self.poll_seconds)

    def wait_ready(self) -> None:
        """Gate the worker: device up, coordinator up, data staged —
        then SIGCONT (`controller.py:53-57`)."""
        self._wait_for("cuda device", self.device_probe)
        self._wait_for("coordinator", self.coordinator_probe)
        if self.download is not None:
            self.download()
        self._signal(SIGCONT_FILE)

    def job_phase(self) -> str | None:
        if self.api is None:
            return None
        try:
            job = self.api.get("TpuJob", self.job_name, self.namespace)
        except NotFound:
            # Master object gone ⇒ treat as terminated (the reference
            # treats a vanished master pod as done, `controller.py:95-99`).
            return "Failed"
        except Exception as e:
            # Transient apiserver trouble (connection refused, 5xx during
            # a restart) must not kill the watch — a dead sidecar never
            # writes SIGTERM and the main container hangs forever. Treat
            # as "phase unknown"; the wait_done deadline still bounds us.
            log.warning("sidecar: job poll failed (%s); will retry", e)
            return None
        return job.status.get("phase")

    def wait_done(self) -> str:
        """Poll the gang's job object until terminal, then SIGTERM
        (`controller.py:77-103`). Returns the terminal phase."""
        deadline = self.clock() + self.timeout_seconds
        while True:
            phase = self.job_phase()
            if phase in TERMINAL_PHASES:
                break
            if self.clock() >= deadline:
                phase = "Failed"
                log.warning("sidecar: job watch timed out; forcing SIGTERM")
                break
            self.sleep(self.poll_seconds)
        self._signal(SIGTERM_FILE)
        return phase or "Failed"

    def upload_results(self, results_dir: str | pathlib.Path) -> None:
        """Ship artifacts out (`controller.py:110-118` S3 upload)."""
        if self.upload is not None:
            self.upload(pathlib.Path(results_dir))

    def run(self, results_dir: str | pathlib.Path | None = None) -> str:
        """Full sidecar lifecycle: gate → watch → signal → upload.

        With no API client the sidecar degenerates to a start gate only
        (no job watch is possible) and reports "Unknown"."""
        self.wait_ready()
        if self.api is None:
            log.warning("sidecar: no apiserver; start-gate only mode")
            phase = "Unknown"
        else:
            phase = self.wait_done()
        if results_dir is not None:
            self.upload_results(results_dir)
        return phase


def local_dir_uploader(dest: str | pathlib.Path) -> Callable[[pathlib.Path], None]:
    """Artifact store backed by a directory (the zero-egress stand-in for
    the reference's `aws s3 cp --recursive`)."""

    def upload(src: pathlib.Path) -> None:
        dest_path = pathlib.Path(dest)
        dest_path.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            shutil.copytree(src, dest_path, dirs_exist_ok=True)
        elif src.exists():
            shutil.copy2(src, dest_path / src.name)

    return upload
