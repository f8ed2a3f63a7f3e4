"""The single-device train step.

Counterpart of `kubeflow_tpu/train/trainer.py` on one device: the same
`TrainConfig` and its checks, the optax optimizers written out in plain
PyTorch with optax's exact update rules (adamw keeps its first moment in
bf16 the way `optax.scale_by_adam(mu_dtype=bf16)` does, which stock
`torch.optim.AdamW` does not), the gather-form cross entropy, and a
`Trainer` whose train and eval steps take a batch dict and return device
metrics. A step makes no host sync: the step count, the learning rate
and the metrics stay tensors on the device.

Not ported yet: the mesh and its shardings, `resize`/`reshard_state`
(ROADMAP Queue 1 item 12), ``loss_in_model`` (the pipelined model, the
same item) and the anomaly ``guard`` (item 8); each raises
`NotImplementedError` where it would be asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX config's fields, defaults and checks
    (kubeflow_tpu/train/trainer.py:74-172). ``fsdp_params`` is accepted
    and has nothing to shard on one device."""

    batch_size: int = 256
    learning_rate: float = 0.4
    warmup_steps: int = 200
    total_steps: int = 10_000
    momentum: float = 0.9
    weight_decay: float = 1e-4
    label_smoothing: float = 0.1
    optimizer: str = "sgd"
    fsdp_params: bool = True
    # "full" also reports accuracy (an argmax over the logits); "loss"
    # reports the objective only.
    train_metrics: str = "full"
    adam_mu_dtype: str = "bfloat16"
    # None, or "full": recompute the whole forward in the backward.
    step_remat: str | None = None
    accum_steps: int = 1
    loss_in_model: bool = False

    def __post_init__(self) -> None:
        if self.train_metrics not in ("full", "loss"):
            raise ValueError(
                f"train_metrics must be 'full' or 'loss', got "
                f"{self.train_metrics!r}"
            )
        if self.optimizer not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.step_remat is not None and self.step_remat not in (
            "full", "dots", "attn", "flash"
        ):
            raise ValueError(
                f"step_remat must be None, 'full', 'dots', 'attn', or "
                f"'flash', got {self.step_remat!r}"
            )
        if self.adam_mu_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"adam_mu_dtype must be 'bfloat16' or 'float32', got "
                f"{self.adam_mu_dtype!r}"
            )
        if self.accum_steps < 1:
            raise ValueError(
                f"accum_steps must be >= 1, got {self.accum_steps}"
            )
        if self.batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size ({self.batch_size}) must divide into "
                f"{self.accum_steps} accumulation microbatches"
            )
        if self.loss_in_model:
            if self.train_metrics != "loss":
                raise ValueError(
                    "loss_in_model=True returns no logits; accuracy is "
                    "unavailable — set train_metrics='loss'"
                )
            if self.label_smoothing:
                raise ValueError(
                    "loss_in_model=True delegates the objective to the "
                    "model; TrainConfig.label_smoothing would be "
                    "silently ignored — set it to 0.0"
                )
            raise NotImplementedError(
                "loss_in_model drives the pipelined transformer's loss "
                "path, which is not ported yet (ROADMAP Queue 1 item 12)"
            )
        if self.step_remat in ("dots", "attn", "flash"):
            raise NotImplementedError(
                f"step_remat {self.step_remat!r} needs selective "
                "checkpointing, which is not ported yet (ROADMAP Queue 1 "
                "item 4); use None or 'full'"
            )


def decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """Weight decay applies to matrices only — never to 1-D params
    (norm scales, biases)."""
    return {name: p.dim() > 1 for name, p in params.items()}


def warmup_cosine_schedule(config: TrainConfig) -> Callable:
    """`optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))` on a device step count: linear from 0 to the peak over
    the warmup, then cosine down to 0, in float32. Step 0's rate is 0."""
    peak = config.learning_rate
    warmup = config.warmup_steps
    decay = max(config.total_steps, warmup + 1) - warmup

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.float()
        if warmup > 0:
            ramp = peak - peak * (1 - torch.clamp(count, 0, warmup) / warmup)
        else:
            ramp = torch.full_like(count, peak)
        t = torch.clamp(count - warmup, max=float(decay))
        cosine = peak * (0.5 * (1 + torch.cos(math.pi * t / decay)))
        return torch.where(count < warmup, ramp, cosine)

    return schedule


class AdamW:
    """`optax.adamw(schedule, weight_decay=wd, mu_dtype=...)` with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root).

    Per step, as the jitted `optax.scale_by_adam` computes it: the stored
    (bf16) first moment is read into float32 and times b1 — b1 rounded to
    the moment's dtype, as optax's weak-typed constant is (0.8984375 for
    bf16) — plus (1 - b1)·g, used in float32 for this step's update, and
    only then stored back in its dtype; the second moment is float32.
    Bias correction uses the incremented count. Weight decay is added to
    every parameter's update (no mask) before the learning rate scales
    it."""

    def __init__(self, schedule, *, weight_decay: float, mu_dtype=torch.bfloat16,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.mu_dtype, self.b1, self.b2, self.eps = mu_dtype, b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        first = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> dict:
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        b1_mu = torch.tensor(self.b1, dtype=self.mu_dtype).item()
        mu32 = torch._foreach_add(
            torch._foreach_mul(g, 1 - self.b1),
            [state["mu"][n].float().mul(b1_mu) for n in names],
        )
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count32 = count.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=count.device), count32)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=count.device), count32)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu32, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(update, p, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(p, update)
        return {
            "count": count,
            "mu": {n: m.to(self.mu_dtype) for n, m in zip(names, mu32)},
            "nu": dict(zip(names, nu)),
        }


class SGD:
    """`optax.chain(add_decayed_weights(wd, mask=decay_mask),
    sgd(schedule, momentum, nesterov=True))`: decay on matrices only,
    then the Nesterov trace (t = g + m·t; update = g + m·t), scaled by
    the negated learning rate."""

    def __init__(self, schedule, *, weight_decay: float, momentum: float):
        self.schedule, self.weight_decay, self.momentum = (
            schedule, weight_decay, momentum)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        first = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
            "trace": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> dict:
        mask = decay_mask(params)
        lr = self.schedule(state["count"])
        trace = {}
        for name, p in params.items():
            g = grads[name]
            if mask[name]:
                g = g + self.weight_decay * p
            t = g + self.momentum * state["trace"][name]
            p.add_((g + self.momentum * t) * -lr)
            trace[name] = t
        return {"count": state["count"] + 1, "trace": trace}


def make_optimizer(config: TrainConfig):
    """The optimizer `config` names, on the warmup-cosine schedule."""
    schedule = warmup_cosine_schedule(config)
    if config.optimizer == "sgd":
        return SGD(schedule, weight_decay=config.weight_decay,
                   momentum=config.momentum)
    mu_dtype = torch.bfloat16 if config.adam_mu_dtype == "bfloat16" else torch.float32
    return AdamW(schedule, weight_decay=config.weight_decay, mu_dtype=mu_dtype)


def softmax_cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Mean cross entropy in the gather form: logsumexp(logits) −
    logits[label], in float32; smoothing mixes in logsumexp −
    mean(logits), the uniform target's term."""
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)
    nll = log_z - logits.gather(-1, labels[..., None])[..., 0]
    if label_smoothing:
        uniform = log_z - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
    return nll.mean()


@dataclasses.dataclass
class TrainState:
    """The step count (a device tensor), the model that holds the
    parameters, and the optimizer's state. The train step updates the
    parameters and the optimizer's moments in place (JAX's step donates
    its state the same way): keep the returned state, not the old one."""

    step: torch.Tensor
    model: nn.Module
    opt_state: dict


class Trainer:
    """Binds (model, config) on one device into init/train/eval steps."""

    def __init__(
        self,
        model: nn.Module,
        config: TrainConfig,
        *,
        input_key: str = "image",
        label_key: str = "label",
        device=None,
        guard=None,
    ):
        if guard is not None:
            raise NotImplementedError(
                "the anomaly guard is not ported yet (ROADMAP Queue 1 item 8)"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.tx = make_optimizer(config)
        self.input_key = input_key
        self.label_key = label_key

    def init_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            model=self.model,
            opt_state=self.tx.init(params),
        )

    def make_train_step(self):
        """step(state, batch) → (state, metrics): the loss (and accuracy
        with ``train_metrics="full"``) of the batch, its gradient, one
        optimizer update. With ``accum_steps`` > 1 the batch is split into
        that many microbatches, run and differentiated one after another,
        and the loss is the mean of their means, as in JAX."""
        cfg = self.config
        has_acc = cfg.train_metrics == "full"
        input_key, label_key = self.input_key, self.label_key

        def forward_loss(model, mb):
            tokens = mb[input_key]
            if cfg.step_remat == "full":
                logits = checkpoint(model, tokens, use_reentrant=False)
            else:
                logits = model(tokens)
            loss = softmax_cross_entropy(logits, mb[label_key], cfg.label_smoothing)
            acc = None
            if has_acc:
                with torch.no_grad():
                    acc = (logits.argmax(-1) == mb[label_key]).float().mean()
            return loss, acc

        def train_step(state: TrainState, batch):
            model = state.model
            params = dict(model.named_parameters())
            for p in params.values():
                p.grad = None
            accum = cfg.accum_steps
            lead = next(iter(batch.values())).shape[0]
            if lead % accum:
                raise ValueError(
                    f"batch ({lead}) must divide into {accum} accumulation "
                    "microbatches"
                )
            size = lead // accum
            loss_sum = acc_sum = None
            for i in range(accum):
                mb = {key: x[i * size:(i + 1) * size] for key, x in batch.items()}
                loss, acc = forward_loss(model, mb)
                (loss / accum).backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if has_acc:
                    acc_sum = acc if acc_sum is None else acc_sum + acc
            grads = {
                n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()
            }
            opt_state = self.tx.step(params, grads, state.opt_state)
            for p in params.values():
                p.grad = None
            metrics = {"loss": loss_sum / accum}
            if has_acc:
                metrics["accuracy"] = acc_sum / accum
            return TrainState(step=state.step + 1, model=model,
                              opt_state=opt_state), metrics

        return train_step

    def make_eval_step(self):
        """eval(state, batch) → {"loss", "accuracy"}: unsmoothed cross
        entropy and argmax accuracy, no gradients."""
        input_key, label_key = self.input_key, self.label_key

        @torch.no_grad()
        def eval_step(state: TrainState, batch):
            logits = state.model(batch[input_key])
            return {
                "loss": softmax_cross_entropy(logits, batch[label_key]),
                "accuracy": (logits.argmax(-1) == batch[label_key]).float().mean(),
            }

        return eval_step
