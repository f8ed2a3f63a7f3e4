"""The RL policy: one set of weights, two faces.

Counterpart of `kubeflow_tpu/rl/policy.py`:

- **Serving face** (`make_policy_servable`): a tiny MLP `Servable` the
  actors query through the router and batcher. Its output carries one
  extra column, the model VERSION broadcast per row, so actors observe
  which weights actually served each request *in-band*: that makes
  `rl_policy_publish_to_actor_seconds` an end-to-end number (CR bump →
  controller drain-roll → batcher swap → first tagged response).
- **Learner face** (`PolicyWithLoss`): the same MLP under a
  ``loss_in_model`` module, so the REINFORCE objective rides the stock
  `Trainer`/`fit()` path. Labels are packed ``[action, return]``
  columns, as `Trajectory.transitions()` packs them.
- **Publication channel** (`PolicyCheckpointPublisher`): the serving
  controller's servable factory. It builds replicas from the learner's
  checkpoint directory (version = checkpoint step), so a modelVersion
  bump on the ServingDeployment pushes trained weights through the
  drain-roll.

The modules keep flax's names (``Dense_0``, ``Dense_1``; the learner's
under ``policy``), so `models.convert.policy_from_flax` maps a JAX
policy's params onto either face. Weights are drawn from a seed on a CPU
generator, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch._device import resolve_device


def _generator(seed: int | torch.Generator) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


class PolicyMLP(nn.Module):
    """Actor-side policy network: obs → action logits, Dense(hidden),
    ReLU, Dense(n_actions), in float32. The weights are drawn from
    `seed` (`reset_parameters`); `device` defaults to CUDA."""

    def __init__(self, obs_dim: int, n_actions: int = 4, hidden: int = 32, *,
                 seed: int | torch.Generator = 0, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden, device="meta")
        self.Dense_1 = nn.Linear(hidden, n_actions, device="meta")
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, rng: int | torch.Generator = 0) -> None:
        """flax's Dense init from `rng` (a seed or a `torch.Generator`):
        fan-in variance-scaling normal kernels, zero biases."""
        gen = _generator(rng)
        for dense in (self.Dense_0, self.Dense_1):
            fan_in = dense.weight.shape[1]
            dense.weight.copy_(torch.randn(dense.weight.shape, generator=gen,
                                           device=gen.device) * fan_in ** -0.5)
            dense.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x.float())))


class PolicyWithLoss(nn.Module):
    """Learner-side wrapper: the REINFORCE loss computed in the model,
    so the stock trainer drives it (``loss_in_model=True``: the scalar
    output IS the loss; it needs ``train_metrics="loss"`` and
    ``label_smoothing=0.0``). A batch-mean baseline and an entropy
    bonus; log-softmax and entropy in float32."""

    def __init__(self, obs_dim: int, n_actions: int = 4, hidden: int = 32,
                 entropy_bonus: float = 0.01, *, seed: int | torch.Generator = 0,
                 device=None):
        super().__init__()
        self.policy = PolicyMLP(obs_dim, n_actions, hidden, seed=seed, device=device)
        self.entropy_bonus = entropy_bonus

    def reset_parameters(self, rng: int | torch.Generator = 0) -> None:
        self.policy.reset_parameters(rng)

    def forward(self, obs: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        logits = self.policy(obs)
        if labels is None:
            # As JAX's shape-inference call: zeros for actions and returns.
            labels = torch.zeros((obs.shape[0], 2), dtype=torch.float32, device=obs.device)
        action = labels[:, 0].long()
        ret = labels[:, 1]
        logp = torch.log_softmax(logits.float(), dim=1)
        chosen = logp.gather(1, action[:, None])[:, 0]
        advantage = ret - ret.mean()
        pg_loss = -(chosen * advantage).mean()
        entropy = -(logp.exp() * logp).sum(dim=1).mean()
        return pg_loss - self.entropy_bonus * entropy


def init_policy_variables(obs_dim: int, n_actions: int, hidden: int,
                          seed: int | torch.Generator = 0, *, device=None) -> dict:
    """Fresh actor-face variables (the fleet before the first publish):
    `PolicyMLP`'s state dict on `device` (CUDA unless named)."""
    return PolicyMLP(obs_dim, n_actions, hidden, seed=seed, device=device).state_dict()


def extract_policy_variables(learner_params: dict) -> dict:
    """Project the learner's `PolicyWithLoss` parameters (a state dict,
    or a `TrainState.state_dict()` holding one under ``params``) down to
    the serving face: the wrapper adds one submodule level and no
    weights."""
    params = learner_params.get("params", learner_params)
    prefix = "policy."
    return {name[len(prefix):]: value for name, value in params.items()
            if name.startswith(prefix)}


def make_policy_servable(
    name: str,
    variables: dict,
    *,
    version: int,
    n_actions: int,
    hidden: int,
    max_batch: int = 64,
    device=None,
    obs_dim: int | None = None,
):
    """Build the version-tagged policy `Servable` (on CUDA unless
    `device` names another).

    Output shape is ``[B, n_actions + 1]``: logits, then the version
    broadcast down a trailing column in the logits' dtype;
    `split_predictions` undoes it. With `obs_dim`, every batch bucket is
    warmed before this returns."""
    from kubeflow_tpu_torch.serving.servable import Servable

    device = resolve_device(device)
    module = PolicyMLP(variables["Dense_0.weight"].shape[1], n_actions, hidden,
                       device=device)
    module.load_state_dict(variables)
    tag = float(int(version))

    def apply_fn(module, batch):
        logits = module(batch)
        return torch.cat([logits, logits.new_full((logits.shape[0], 1), tag)], dim=1)

    servable = Servable(name, apply_fn, module, version=int(version),
                        max_batch=max_batch, device=device)
    if obs_dim is not None:
        servable.warmup_with(np.zeros((obs_dim,), np.float32))
    return servable


def split_predictions(out: np.ndarray) -> tuple[np.ndarray, int]:
    """(logits, served version) from a version-tagged response."""
    return out[:, :-1], int(round(float(out[0, -1])))


class PolicyCheckpointPublisher:
    """Servable factory for `LocalReplicaRuntime`, reading weights back
    out of the learner's checkpoint directory, on CUDA unless `device`
    names another (without CUDA and without a device it raises).

    Before the first publish (rspec modelVersion 0, or no committed
    checkpoint yet) replicas serve a seeded fresh init at version 1: the
    fleet must be up and admitting before the learner has saved
    anything. After a publish, the factory restores the step the spec
    names while the directory holds it, else the newest committed step
    (`Checkpointer.restore_latest(prefer_step=)`), and serves it at
    version == step.

    One departure from the JAX publisher, which restores the newest step
    whatever the spec names: the learner saves at every publish, so a
    replica built or rolled between a save and its bump would serve a
    step past the spec, and roll again on every reconcile until the bump
    lands (the pattern of the serving controller's endless roll, ROADMAP
    Queue 3).
    """

    def __init__(
        self,
        ckpt_dir: str,
        abstract_state_fn,
        *,
        obs_dim: int,
        n_actions: int,
        hidden: int,
        init_seed: int = 0,
        device=None,
    ):
        self._ckpt_dir = ckpt_dir
        # Callable, not a state: the trainer may not exist yet when the
        # fleet first materializes.
        self._abstract_state_fn = abstract_state_fn
        self._obs_dim = obs_dim
        self._n_actions = n_actions
        self._hidden = hidden
        self._init_seed = init_seed
        self._device = resolve_device(device)

    def _restore(self, want: int):
        from kubeflow_tpu_torch.train.checkpoint import Checkpointer
        from kubeflow_tpu_torch.train.trainer import TensorSpec

        try:
            ckpt = Checkpointer(self._ckpt_dir, read_only=True)
        except FileNotFoundError:
            return None
        # Only the parameters, put on the fleet's device.
        template = {"params": {
            name: TensorSpec(spec.shape, spec.dtype, self._device)
            for name, spec in self._abstract_state_fn()["params"].items()}}
        try:
            return ckpt.restore_latest(template, prefer_step=want)
        finally:
            ckpt.close()

    def __call__(self, rspec: dict):
        want = int(rspec.get("modelVersion") or 0)
        restored = self._restore(want) if want > 0 else None
        if restored is None:
            variables = init_policy_variables(
                self._obs_dim, self._n_actions, self._hidden, self._init_seed,
                device=self._device,
            )
            version = 1
        else:
            variables = extract_policy_variables(restored.state["params"])
            version = max(int(restored.step), 1)
        return make_policy_servable(
            rspec.get("model", "policy"),
            variables,
            version=version,
            n_actions=self._n_actions,
            hidden=self._hidden,
            max_batch=int(rspec.get("maxBatch", 64)),
            device=self._device,
            obs_dim=self._obs_dim,
        )
