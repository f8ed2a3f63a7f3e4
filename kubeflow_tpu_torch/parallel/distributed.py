"""Multi-process bootstrap: the TpuJob env contract.

Counterpart of `kubeflow_tpu/parallel/distributed.py`, with the same
flat env contract that the TpuJob operator injects into every pod of a
gang:

    TPUJOB_COORDINATOR    host:port of process 0 (the rendezvous)
    TPUJOB_NUM_PROCESSES  total processes in the gang
    TPUJOB_PROCESS_ID     this process's rank
    TPUJOB_NUM_SLICES     number of slices; default 1
    TPUJOB_SLICE_ID       which slice this process belongs to; default 0

Where the JAX package calls `jax.distributed.initialize`, this one calls
`torch.distributed.init_process_group` on ``tcp://<coordinator>``:
NCCL when the process runs on CUDA (one GPU per process), gloo on the
CPU. The slice fields are parsed and validated as in JAX; libtpu's
MEGASCALE_* variables have no counterpart here and are not exported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping


log = logging.getLogger(__name__)

ENV_COORDINATOR = "TPUJOB_COORDINATOR"
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
ENV_SLICE_ID = "TPUJOB_SLICE_ID"


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """Parsed gang membership for one process."""

    coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0
    num_slices: int = 1
    slice_id: int = 0

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "ProcessEnv":
        env = os.environ if env is None else env
        pe = cls(
            coordinator=env.get(ENV_COORDINATOR),
            num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(env.get(ENV_PROCESS_ID, "0")),
            num_slices=int(env.get(ENV_NUM_SLICES, "1")),
            slice_id=int(env.get(ENV_SLICE_ID, "0")),
        )
        pe.validate()
        return pe

    def validate(self) -> None:
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range [0, {self.num_processes})"
            )
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError(
                f"{ENV_COORDINATOR} is required when {ENV_NUM_PROCESSES} > 1"
            )
        if self.num_slices < 1 or not 0 <= self.slice_id < self.num_slices:
            raise ValueError(
                f"slice_id {self.slice_id} out of range [0, {self.num_slices})"
            )
        if self.num_processes % self.num_slices:
            raise ValueError(
                f"num_processes {self.num_processes} not divisible by "
                f"num_slices {self.num_slices}"
            )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def to_env(self) -> dict[str, str]:
        """The operator-side inverse of from_env: env to inject into a pod."""
        out = {
            ENV_NUM_PROCESSES: str(self.num_processes),
            ENV_PROCESS_ID: str(self.process_id),
            ENV_NUM_SLICES: str(self.num_slices),
            ENV_SLICE_ID: str(self.slice_id),
        }
        if self.coordinator:
            out[ENV_COORDINATOR] = self.coordinator
        return out


def initialize_from_env(
    env: Mapping[str, str] | None = None, *, device=None
) -> ProcessEnv:
    """Start `torch.distributed` from the TpuJob env contract.

    Single-process gangs (the default) skip initialization entirely, so
    this is safe to call unconditionally at start-up. A gang of more
    processes joins one process group at ``tcp://<coordinator>``:
    on CUDA (the default device, `_device.resolve_device`) with NCCL,
    each process on GPU ``process_id % device_count``; with
    ``device="cpu"`` with gloo."""
    pe = ProcessEnv.from_env(env)
    if pe.num_processes > 1:
        # Imported here: the operator builds ProcessEnv in control-plane
        # processes that never load torch.
        import torch
        import torch.distributed as dist

        from kubeflow_tpu_torch._device import resolve_device

        device = resolve_device(device)
        backend = "gloo"
        if device.type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(pe.process_id % torch.cuda.device_count())
        log.info(
            "torch.distributed.init_process_group backend=%s coordinator=%s "
            "rank=%d/%d slice=%d/%d", backend, pe.coordinator, pe.process_id,
            pe.num_processes, pe.slice_id, pe.num_slices,
        )
        dist.init_process_group(
            backend, init_method=f"tcp://{pe.coordinator}",
            world_size=pe.num_processes, rank=pe.process_id,
        )
    return pe
