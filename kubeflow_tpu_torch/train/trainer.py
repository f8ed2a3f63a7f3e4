"""The single-device train step.

Counterpart of `kubeflow_tpu/train/trainer.py` on one device: the same
`TrainConfig` and its checks, the optax optimizers written out in plain
PyTorch with optax's exact update rules (adamw keeps its first moment in
bf16 the way `optax.scale_by_adam(mu_dtype=bf16)` does, which stock
`torch.optim.AdamW` does not), the gather-form cross entropy, and a
`Trainer` whose train and eval steps take a batch dict and return device
metrics. A step makes no host sync: the step count, the learning rate
and the metrics stay tensors on the device.

The train step runs the model in training mode and the eval step in
eval mode. A model's buffers (a ResNet's BatchNorm running statistics)
are its ``batch_stats``: the forward moves them in place, each
accumulation microbatch reading what the one before it left, as JAX's
scan threads them.

A model on an in-process sp ring (`parallel/mesh.build_mesh` in one
process) trains here unchanged: its ring positions share one set of
parameters, so their gradients sum by themselves.

With an anomaly ``guard`` (`train/guard.py`) every step is screened on
the device: the parameters, optimizer state and batch statistics are
copied before the forward, the update is computed, and the applied or
the kept values are selected with `torch.where` on the guard's verdict
(the loss, the gradient norm, and the finiteness of the updated
parameters and statistics), still without a host sync. The step count
advances on a skip. `TrainState.state_dict`, `Trainer.abstract_state` and
`Trainer.load_state_dict` are what the checkpointer saves and restores.

With ``loss_in_model`` the model owns the objective: it is called as
``model(inputs, labels=labels)`` and returns the scalar loss (the RL
learner's `rl.policy.PolicyWithLoss`); accuracy is not reported.

Not ported yet: a model on a multi-process mesh, which needs a gradient
all-reduce over dp and sp, the shardings and `resize`/`reshard_state`
(ROADMAP Queue 1 item 12); it raises `NotImplementedError` where it
would be asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.transformer import checkpoint_policy


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
    # None, or a remat policy ("full", "dots", "attn", "flash") for one
    # checkpoint around the whole forward (`models.transformer.
    # checkpoint_policy`): the backward recomputes what it does not keep.
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
        # A Python base is rounded to float32 in the kernel, as a float32
        # tensor base would be, and needs no copy to the device.
        bc1 = 1 - torch.pow(self.b1, count32)
        bc2 = 1 - torch.pow(self.b2, count32)
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
    the negated learning rate. Every operation is a ``_foreach`` over all
    the parameters."""

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
        names = list(params)
        mask = decay_mask(params)
        lr = self.schedule(state["count"])
        g = [grads[n] for n in names]
        decayed = [i for i, n in enumerate(names) if mask[n]]
        if self.weight_decay and decayed:
            wd = torch._foreach_add([g[i] for i in decayed],
                                    [params[names[i]] for i in decayed],
                                    alpha=self.weight_decay)
            for i, d in zip(decayed, wd):
                g[i] = d
        trace = torch._foreach_add(g, [state["trace"][n] for n in names],
                                   alpha=self.momentum)
        update = torch._foreach_add(g, trace, alpha=self.momentum)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_([params[n] for n in names], update)
        return {"count": state["count"] + 1, "trace": dict(zip(names, trace))}


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


def global_norm(tensors) -> torch.Tensor:
    """`optax.global_norm`: the 2-norm of all the tensors together, a
    float32 device scalar (per-tensor norms, then their norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def map_tensors(fn, tree):
    """`fn` applied to every tensor of a tree of dicts (None stays): the
    layout of `TrainState.state_dict()`."""
    if isinstance(tree, dict):
        return {key: map_tensors(fn, value) for key, value in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, in order."""
    if isinstance(tree, dict):
        return [t for value in tree.values() for t in _leaves(value)]
    return [] if tree is None else [tree]


def batch_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's buffers by name (a ResNet's BatchNorm running mean and
    variance); empty for a model without any (the LM)."""
    return dict(model.named_buffers())


def _remat_forward(model: nn.Module):
    """``model`` for `torch.utils.checkpoint`, whose backward runs the
    forward a second time: that rerun puts the buffers back as it found
    them, so each forward moves the batch statistics once (JAX's
    rematerialised forward is pure)."""
    buffers = list(model.buffers())
    calls = 0

    def forward(*args, **kwargs):
        nonlocal calls
        calls += 1
        if calls == 1 or not buffers:
            return model(*args, **kwargs)
        saved = [b.clone() for b in buffers]
        try:
            return model(*args, **kwargs)
        finally:
            # Also when checkpoint stops the rerun early (by raising once
            # it has every tensor it needs).
            torch._foreach_copy_(buffers, saved)

    return forward


class TensorSpec(NamedTuple):
    """A tensor's shape, dtype and device, without storage: the leaves of
    `Trainer.abstract_state()` (JAX's `ShapeDtypeStruct` with a
    sharding)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


@dataclasses.dataclass
class TrainState:
    """The step count (a device tensor), the model that holds the
    parameters and the batch statistics, the optimizer's state, and the
    anomaly guard's state (None without a guard). The train step updates
    the parameters, the statistics and the optimizer's moments in place
    (JAX's step donates its state the same way): keep the returned
    state, not the old one."""

    step: torch.Tensor
    model: nn.Module
    opt_state: dict
    guard: dict | None = None

    def state_dict(self) -> dict:
        """Every tensor of the state, by name, as a tree of dicts: the
        step, the parameters (detached, not copies), the batch statistics
        (only for a model with buffers: an LM's state has no such key),
        the optimizer's state and the guard's. `Trainer.load_state_dict`
        takes it back."""
        tree = {
            "step": self.step,
            "params": {n: p.detach() for n, p in self.model.named_parameters()},
            "opt_state": self.opt_state,
            "guard": self.guard,
        }
        stats = batch_stats(self.model)
        if stats:
            tree["batch_stats"] = stats
        return tree


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
        if guard is not None and not callable(getattr(guard, "apply", None)):
            raise TypeError(
                f"guard must be an AnomalyGuard (train/guard.py), got "
                f"{type(guard).__name__}"
            )
        mesh = getattr(model, "mesh", None)
        if mesh is not None and mesh.multiprocess:
            raise NotImplementedError(
                "training on a multi-process mesh needs a gradient "
                "all-reduce over dp and sp, which is not ported yet (ROADMAP "
                "Queue 1 item 12); an in-process sp ring trains as is"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.tx = make_optimizer(config)
        self.input_key = input_key
        self.label_key = label_key
        # Optional AnomalyGuard: every train step screens its loss,
        # gradient norm and update on the device and skips a bad update.
        self.guard = guard
        # The guarded step's copies of the kept state (made at its first
        # call, reused by every later one).
        self._kept = None

    def init_state(self, rng: int | torch.Generator | None = None) -> TrainState:
        """Step 0: fresh optimizer and guard state. With `rng` (a seed or
        an explicit `torch.Generator`, never the global RNG) the model's
        parameters are drawn anew from it first (the model's
        ``reset_parameters``); without, they stay as they are."""
        if rng is not None:
            reset = getattr(self.model, "reset_parameters", None)
            if not callable(reset):
                raise TypeError(
                    f"{type(self.model).__name__} has no reset_parameters(rng); "
                    "call init_state() to keep its parameters"
                )
            reset(rng)
        params = dict(self.model.named_parameters())
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            model=self.model,
            opt_state=self.tx.init(params),
            guard=self.guard.init_state(self.device) if self.guard else None,
        )

    def abstract_state(self) -> dict:
        """The layout of `TrainState.state_dict()` with a `TensorSpec` for
        every tensor (on the trainer's device): the template a checkpoint
        is restored against. Allocates nothing."""
        meta = {n: torch.empty_like(p, device="meta")
                for n, p in self.model.named_parameters()}
        tree = {
            "step": torch.empty((), dtype=torch.int32, device="meta"),
            "params": meta,
            "opt_state": self.tx.init(meta),
            "guard": self.guard.init_state("meta") if self.guard else None,
        }
        stats = batch_stats(self.model)
        if stats:
            tree["batch_stats"] = stats
        return map_tensors(
            lambda t: TensorSpec(tuple(t.shape), t.dtype, self.device), tree)

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> TrainState:
        """A `TrainState` from `TrainState.state_dict()`'s layout: the
        parameters and batch statistics are copied into the trainer's
        model in place, every other tensor is put on the trainer's
        device."""
        for key, into in (("params", dict(self.model.named_parameters())),
                          ("batch_stats", batch_stats(self.model))):
            have = state.get(key, {})
            if set(have) != set(into):
                raise KeyError(
                    f"state's {key} {sorted(set(have) ^ set(into))} do not "
                    "match the model's"
                )
            for name, t in into.items():
                t.copy_(have[name])
        to = lambda t: t.to(self.device)
        return TrainState(
            step=to(state["step"]),
            model=self.model,
            opt_state=map_tensors(to, state["opt_state"]),
            guard=map_tensors(to, state.get("guard")) if self.guard else None,
        )

    def make_train_step(self):
        """step(state, batch) → (state, metrics): the loss (and accuracy
        with ``train_metrics="full"``) of the batch, its gradient, one
        optimizer update. With ``accum_steps`` > 1 the batch is split into
        that many microbatches, run and differentiated one after another,
        and the loss is the mean of their means, as in JAX. With
        ``loss_in_model`` the model's output is the loss. A model's own
        losses (``sows_losses``: a MoE LM's load balancing) are added to
        each (micro)batch's loss, as JAX's trainer adds its "losses"
        collection."""
        cfg = self.config
        has_acc = cfg.train_metrics == "full"
        input_key, label_key = self.input_key, self.label_key
        guard = self.guard

        def forward_loss(model, mb):
            inputs = mb[input_key]
            kwargs = {"labels": mb[label_key]} if cfg.loss_in_model else {}
            # A model with losses of its own (the MoE's load balancing,
            # JAX's "losses" collection) returns them beside its output.
            sows = getattr(model, "sows_losses", False)
            if sows:
                kwargs["with_losses"] = True
            if cfg.step_remat is not None:
                out = checkpoint(_remat_forward(model), inputs, use_reentrant=False,
                                 context_fn=checkpoint_policy(cfg.step_remat),
                                 **kwargs)
            else:
                out = model(inputs, **kwargs)
            aux_losses = ()
            if sows:
                out, aux_losses = out
            acc = None
            if cfg.loss_in_model:
                loss = out
            else:
                logits = out
                loss = softmax_cross_entropy(logits, mb[label_key], cfg.label_smoothing)
                if has_acc:
                    with torch.no_grad():
                        acc = (logits.argmax(-1) == mb[label_key]).float().mean()
            for aux in aux_losses:
                loss = loss + aux
            return loss, acc

        def train_step(state: TrainState, batch):
            model = state.model
            model.train()
            params = dict(model.named_parameters())
            stats = list(batch_stats(model).values())
            if guard is not None:
                keep(params, stats, state.opt_state)
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
            for p in params.values():
                p.grad = None
            metrics = {"loss": loss_sum / accum}
            if has_acc:
                metrics["accuracy"] = acc_sum / accum
            if guard is None:
                opt_state = self.tx.step(params, grads, state.opt_state)
                return TrainState(step=state.step + 1, model=model,
                                  opt_state=opt_state), metrics
            gstate, opt_state = guarded_update(params, stats, grads, state, metrics)
            return TrainState(step=state.step + 1, model=model,
                              opt_state=opt_state, guard=gstate), metrics

        @torch.no_grad()
        def keep(params, stats, opt_state):
            """Copy what a skipped step keeps, before the forward moves
            the batch statistics and the optimizer the parameters (and
            adamw its second moment) in place, into buffers made once."""
            if self._kept is None:
                self._kept = ([torch.empty_like(t) for t in (*params.values(), *stats)],
                              map_tensors(torch.empty_like, opt_state))
            kept_state, kept_opt = self._kept
            torch._foreach_copy_(kept_state, [*params.values(), *stats])
            torch._foreach_copy_(_leaves(kept_opt), _leaves(opt_state))

        @torch.no_grad()
        def guarded_update(params, stats, grads, state, metrics):
            """The update, then the guard's verdict on the loss, the
            gradient norm and the finiteness of the updated parameters
            and statistics, then the applied or the kept parameters,
            statistics and optimizer state, selected on the device in
            place."""
            grad_norm = global_norm(grads.values())
            live = [*params.values(), *stats]
            kept_state, kept_opt = self._kept
            opt_state = self.tx.step(params, grads, state.opt_state)
            update_finite = torch.stack([torch.isfinite(t).all() for t in live]).all()
            gstate, ok = guard.apply(state.guard, metrics["loss"], grad_norm,
                                     update_finite=update_finite)
            for t, kept in zip(live, kept_state):
                torch.where(ok, t, kept, out=t)
            for new, kept in zip(_leaves(opt_state), _leaves(kept_opt)):
                torch.where(ok, new, kept, out=new)
            metrics.update(guard.metrics(gstate, ok, grad_norm))
            return gstate, opt_state

        return train_step

    def make_eval_step(self):
        """eval(state, batch) → {"loss", "accuracy"}: unsmoothed cross
        entropy and argmax accuracy of the model in eval mode, no
        gradients. With ``loss_in_model``, {"loss"}: the model's own
        objective in eval mode."""
        input_key, label_key = self.input_key, self.label_key
        loss_in_model = self.config.loss_in_model

        @torch.no_grad()
        def eval_step(state: TrainState, batch):
            state.model.eval()
            if loss_in_model:
                return {"loss": state.model(batch[input_key], labels=batch[label_key])}
            logits = state.model(batch[input_key])
            return {
                "loss": softmax_cross_entropy(logits, batch[label_key]),
                "accuracy": (logits.argmax(-1) == batch[label_key]).float().mean(),
            }

        return eval_step
