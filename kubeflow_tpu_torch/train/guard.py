"""Per-step training anomaly guard, on the device: never persist a NaN.

Counterpart of `kubeflow_tpu/train/guard.py` with the same rules:

- Every step is screened on the device: the loss's and the gradient
  norm's finiteness (and the updated parameters'), plus an EWMA spike
  test. The verdict is a 0-d device bool that selects between the
  applied and the skipped state inside the train step with
  `torch.where`; nothing is read on the host per step. The host reads
  the counters only where it reads metrics anyway (log and save steps).
- A bad step is skipped, not fatal: parameters and optimizer state keep
  their values, and the step counter still advances so that checkpoint
  and data bookkeeping stay aligned.
- ``max_consecutive_skips`` rejected steps in a row set a sticky
  ``diverged`` flag; the loop (`train/loop.py`) then rolls back to the
  last checkpoint and perturbs the data.

The guard state is a dict of 0-d device tensors that rides inside
`TrainState`, so it is checkpointed and restored with the parameters.

On a process mesh the verdict is identical on every rank: the trainer
hands `apply` the global loss, the global gradient norm and the
finiteness of the update over the whole gang, each reduced across the
gang's processes before `torch.where` selects (`train/trainer.py`), and
every rank then advances the same guard state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Thresholds, as in JAX (kubeflow_tpu/train/guard.py:40-89).

    The spike tests compare a step's loss and gradient norm with EWMAs of
    the accepted steps only. The multiplicative test disarms on a
    non-positive baseline (signed objectives); ``spike_slack`` adds an
    additive margin for losses near 0."""

    ewma_alpha: float = 0.05
    # Spike tests are off until this many steps were accepted; finiteness
    # is screened from step 0.
    warmup_steps: int = 10
    loss_spike_factor: float = 2.0
    spike_slack: float = 0.0
    grad_spike_factor: float = 4.0
    max_consecutive_skips: int = 5

    def __post_init__(self) -> None:
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if self.loss_spike_factor <= 1.0 or self.grad_spike_factor <= 1.0:
            raise ValueError(
                "spike factors must be > 1 (a factor <= 1 would flag "
                f"ordinary steps): got loss={self.loss_spike_factor}, "
                f"grad={self.grad_spike_factor}"
            )
        if self.max_consecutive_skips < 1:
            raise ValueError(
                f"max_consecutive_skips must be >= 1, got "
                f"{self.max_consecutive_skips}"
            )


class AnomalyGuard:
    """Finiteness and EWMA spike screen, as device tensor arithmetic.

    `init_state(device)` makes the state; `apply(state, loss, grad_norm)`
    returns `(new_state, ok)` without a host sync. `diverged` and
    `skipped_total` read the state on the host: call them only where the
    host syncs anyway."""

    def __init__(self, config: GuardConfig | None = None):
        self.config = config or GuardConfig()

    # -- device side (inside the train step) ---------------------------------

    def init_state(self, device=None) -> dict[str, torch.Tensor]:
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "ewma_loss": torch.zeros((), **f32),
            "ewma_grad_norm": torch.zeros((), **f32),
            "accepted": torch.zeros((), **i32),
            "consecutive_skips": torch.zeros((), **i32),
            "skipped_total": torch.zeros((), **i32),
            "diverged": torch.zeros((), **i32),
        }

    def apply(
        self,
        gstate: dict,
        loss: torch.Tensor,
        grad_norm: torch.Tensor,
        update_finite: torch.Tensor | None = None,
    ) -> tuple[dict, torch.Tensor]:
        """One step's verdict: `(new_state, ok)`, `ok` a 0-d device bool
        (True: apply the update). `update_finite` is the finiteness of the
        updated parameters: a finite loss and gradient can still overflow
        a parameter, and an accepted overflow would reach every later
        checkpoint."""
        cfg = self.config
        loss = loss.float()
        grad_norm = grad_norm.float()
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        if update_finite is not None:
            finite = finite & update_finite
        warm = gstate["accepted"] >= cfg.warmup_steps
        ewma_loss, ewma_gnorm = gstate["ewma_loss"], gstate["ewma_grad_norm"]
        loss_spike = warm & (ewma_loss > 0) & (
            loss > cfg.loss_spike_factor * ewma_loss + cfg.spike_slack
        )
        grad_spike = warm & (ewma_gnorm > 0) & (
            grad_norm > cfg.grad_spike_factor * ewma_gnorm + cfg.spike_slack
        )
        ok = finite & ~loss_spike & ~grad_spike

        # The EWMAs advance on accepted steps only, seeded by the first
        # accepted observation. float32 throughout, as in JAX.
        a = torch.tensor(cfg.ewma_alpha, dtype=torch.float32).item()
        first = gstate["accepted"] == 0
        upd_loss = torch.where(first, loss, (1.0 - a) * ewma_loss + a * loss)
        upd_gnorm = torch.where(first, grad_norm, (1.0 - a) * ewma_gnorm + a * grad_norm)
        oki = ok.to(torch.int32)
        consecutive = torch.where(ok, 0, gstate["consecutive_skips"] + 1).to(torch.int32)
        new_state = {
            "ewma_loss": torch.where(ok, upd_loss, ewma_loss),
            "ewma_grad_norm": torch.where(ok, upd_gnorm, ewma_gnorm),
            "accepted": gstate["accepted"] + oki,
            "consecutive_skips": consecutive,
            "skipped_total": gstate["skipped_total"] + (1 - oki),
            # Sticky until a rollback restores an earlier guard state.
            "diverged": torch.maximum(
                gstate["diverged"],
                (consecutive >= cfg.max_consecutive_skips).to(torch.int32),
            ),
        }
        return new_state, ok

    def metrics(self, gstate: dict, ok: torch.Tensor, grad_norm: torch.Tensor) -> dict:
        """Device entries for the step's metrics dict."""
        return {
            "grad_norm": grad_norm,
            "guard_ok": ok.to(torch.int32),
            "guard_skipped_total": gstate["skipped_total"],
            "guard_consecutive_skips": gstate["consecutive_skips"],
            "guard_diverged": gstate["diverged"],
        }

    # -- host side (boundary reads only) --------------------------------------

    @staticmethod
    def diverged(gstate: Any) -> bool:
        """The sticky divergence flag, read on the host."""
        return bool(int(gstate["diverged"]))

    @staticmethod
    def skipped_total(gstate: Any) -> int:
        return int(gstate["skipped_total"])
