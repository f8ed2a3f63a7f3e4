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
`torch.distributed.init_process_group` on ``tcp://<coordinator>``, with
a backend decided from the layout before the call (`choose_backend`):

- on the CPU, gloo;
- on CUDA, NCCL when every local rank has a card of its own;
- on CUDA, gloo when the gang's local ranks outnumber the visible cards
  (two workers of a gang on a one-card host). Each rank still computes on
  the card; the collectives go through host memory.

The rule is decided up front, never by catching an NCCL failure: a
collective that cannot run raises. The local ranks are the whole gang
when the coordinator is a loopback address (every worker on this host,
as the local pod runner places them), else one (a pod per host). Rank r
computes on card ``(r % local ranks) % visible cards``.

Every process group gets an explicit timeout (``KFTPU_GROUP_TIMEOUT_S``,
60 s by default, against gloo's 30 minutes), so that a dead peer fails
the survivors' next collective quickly and the operator's whole-gang
restart does not wait on a hung rank. A gang also gets a gloo group over
all its ranks on the host (`control_group`): the training loop agrees
on host flags (a preemption, a save) through it without touching the
card.

The slice fields are parsed and validated as in JAX; libtpu's
MEGASCALE_* variables have no counterpart here and are not exported.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import logging
import os
from typing import Mapping


log = logging.getLogger(__name__)

ENV_COORDINATOR = "TPUJOB_COORDINATOR"
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
ENV_SLICE_ID = "TPUJOB_SLICE_ID"
ENV_GROUP_TIMEOUT = "KFTPU_GROUP_TIMEOUT_S"
GROUP_TIMEOUT_S = 60.0

# What `initialize_from_env` decided: the backend, the card, the layout
# and the host-side control group.
_STARTED: dict = {}


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


def group_timeout(env: Mapping[str, str] | None = None) -> datetime.timedelta:
    """The timeout every process group of a gang gets: KFTPU_GROUP_TIMEOUT_S
    seconds (60 by default)."""
    env = os.environ if env is None else env
    return datetime.timedelta(seconds=float(env.get(ENV_GROUP_TIMEOUT, GROUP_TIMEOUT_S)))


def _is_loopback(host: str) -> bool:
    """Whether `host` names this host's loopback: "localhost" or a
    loopback address. A host name is never resolved here."""
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host.strip("[]")).is_loopback
    except ValueError:
        return False


def local_ranks(pe: ProcessEnv) -> int:
    """How many ranks of the gang run on this host: the whole gang when
    the coordinator is "localhost" or a loopback address, else one."""
    host = (pe.coordinator or "localhost").rsplit(":", 1)[0]
    return pe.num_processes if _is_loopback(host) else 1


def choose_backend(device_type: str, local: int, cards: int) -> str:
    """The backend rule: gloo on the CPU; on CUDA, NCCL when every one of
    the `local` ranks on this host has a card of its own among `cards`,
    and gloo (CUDA tensors, collectives through host memory) when they
    outnumber the cards."""
    if device_type != "cuda":
        return "gloo"
    if cards < 1:
        raise RuntimeError("a CUDA gang member sees no card")
    return "nccl" if local <= cards else "gloo"


def started() -> dict:
    """What `initialize_from_env` decided for this process: ``backend``,
    ``device`` (the card, or cpu), ``local_ranks``, ``cards`` and
    ``timeout_s``; empty for a gang of one."""
    return dict((k, v) for k, v in _STARTED.items() if k != "control")


def control_group():
    """A gloo group over every rank of the gang, for host tensors (the
    default group itself when that is gloo); None in a gang of one."""
    return _STARTED.get("control")


def initialize_from_env(
    env: Mapping[str, str] | None = None, *, device=None
) -> ProcessEnv:
    """Start `torch.distributed` from the TpuJob env contract.

    Single-process gangs (the default) skip initialization entirely, so
    this is safe to call unconditionally at start-up. A gang of more
    processes joins one process group at ``tcp://<coordinator>`` with the
    group timeout, on the backend `choose_backend` picks for the device
    (CUDA by default, `_device.resolve_device`; ``device="cpu"`` for
    gloo on the CPU), and makes its control group. `started()` reports
    the choice, which is also logged."""
    env = os.environ if env is None else env
    pe = ProcessEnv.from_env(env)
    if pe.num_processes > 1:
        # Imported here: the operator builds ProcessEnv in control-plane
        # processes that never load torch.
        import torch
        import torch.distributed as dist

        from kubeflow_tpu_torch._device import resolve_device

        device = resolve_device(device)
        local = local_ranks(pe)
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        backend = choose_backend(device.type, local, cards)
        if device.type == "cuda":
            device = torch.device("cuda", (pe.process_id % local) % cards)
            torch.cuda.set_device(device)
        timeout = group_timeout(env)
        log.warning(
            "torch.distributed.init_process_group backend=%s device=%s "
            "local_ranks=%d cards=%d timeout=%.0fs coordinator=%s rank=%d/%d "
            "slice=%d/%d", backend, device, local, cards, timeout.total_seconds(),
            pe.coordinator, pe.process_id, pe.num_processes, pe.slice_id, pe.num_slices,
        )
        dist.init_process_group(
            backend, init_method=f"tcp://{pe.coordinator}",
            world_size=pe.num_processes, rank=pe.process_id, timeout=timeout,
        )
        _STARTED.clear()
        _STARTED.update(
            backend=backend, device=str(device), local_ranks=local, cards=cards,
            timeout_s=timeout.total_seconds(),
            control=(dist.group.WORLD if backend == "gloo"
                     else dist.new_group(backend="gloo", timeout=timeout)),
        )
    return pe


def shutdown() -> None:
    """Leave the gang's process group, if this process joined one."""
    if _STARTED:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _STARTED.clear()
