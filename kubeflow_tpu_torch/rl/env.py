"""Synthetic vectorized environment for the Podracer RL workload.

A copy of `kubeflow_tpu/rl/env.py` (a module with no JAX in it): the
port imports nothing of the JAX package.

A contextual-bandit-style task sized so the PLATFORM, not the task, is
what a run measures: each step the environment emits a batch of
observation vectors, a hidden linear map (drawn once from the env seed)
defines the best action per observation, and the reward is 1.0 for
choosing it (0.0 otherwise). A random policy earns ~horizon/n_actions
per episode; a converged one earns ~horizon — enough signal for the
study layer's early stopping to rank learning rates on real runs.

Determinism is the load-bearing property: every observation is a pure
function of ``(env seed, salt, trajectory index, step)`` and action
sampling is a pure function of the same tuple plus the policy's logits.
That is what lets the replay queue make the train/data resumability
promise (checkpoint-resume neither repeats nor drops trajectory
indices) and lets the chaos soak assert exact continuity across a
SIGKILLed learner.

The acting path is numpy-only by design — no torch, no device sync.
`tests/test_torch_rl.py` AST-scans `rollout` and `sample_actions` (and
the actor loop in `rl/loop.py`) to keep it that way: actors must spend
their time in the serving stack's batcher, not in host-side device
chatter.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Shape of the synthetic task (and of one actor rollout)."""

    obs_dim: int = 8
    n_actions: int = 4
    # Environments stepped in lockstep per rollout — one predict() call
    # per step carries n_envs observations through the batcher.
    n_envs: int = 8
    horizon: int = 8
    seed: int = 0

    @property
    def transitions_per_trajectory(self) -> int:
        return self.horizon * self.n_envs


@dataclasses.dataclass
class Trajectory:
    """One completed vectorized rollout (the replay queue's unit)."""

    index: int
    # The serving-side model version the actions were sampled from —
    # read in-band from the policy servable's version column, so it
    # reflects what the FLEET actually served, not what the learner
    # believes it published.
    policy_version: int
    obs: np.ndarray      # [horizon, n_envs, obs_dim]
    actions: np.ndarray  # [horizon, n_envs] int32
    rewards: np.ndarray  # [horizon, n_envs] float32

    @property
    def mean_return(self) -> float:
        """Mean per-env episode return."""
        return float(self.rewards.sum(axis=0).mean())

    def transitions(self) -> dict[str, np.ndarray]:
        """Flatten to one learner batch (the trainer's loss_in_model
        contract: obs under input_key, packed [action, return] labels
        under label_key)."""
        t, e, d = self.obs.shape
        obs = self.obs.reshape(t * e, d).astype(np.float32)
        target = np.stack(
            [
                self.actions.reshape(t * e).astype(np.float32),
                self.rewards.reshape(t * e).astype(np.float32),
            ],
            axis=1,
        )
        return {"obs": obs, "target": target}


class VectorEnv:
    """The seeded task. Stateless between calls: observations derive
    from (seed, salt, index, step), so two processes with the same
    config regenerate identical trajectories — the property the
    resumable replay protocol stands on."""

    def __init__(self, config: EnvConfig):
        self.config = config
        rng = np.random.default_rng(config.seed)
        # Hidden scoring map: argmax(obs @ w) is the optimal action.
        self._w = rng.standard_normal(
            (config.obs_dim, config.n_actions)
        ).astype(np.float32)

    def observe(self, index: int, step: int, salt: int = 0) -> np.ndarray:
        c = self.config
        rng = np.random.default_rng((c.seed, salt, index, step))
        return rng.standard_normal((c.n_envs, c.obs_dim)).astype(np.float32)

    def rewards(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        best = np.argmax(obs @ self._w, axis=1)
        return (actions == best).astype(np.float32)

    def optimal_actions(self, obs: np.ndarray) -> np.ndarray:
        return np.argmax(obs @ self._w, axis=1)


def sample_actions(
    logits: np.ndarray, config: EnvConfig, index: int, step: int, salt: int
) -> np.ndarray:
    """Sample from the softmax policy via the Gumbel trick with noise
    that is a pure function of the rollout coordinates — given the same
    logits, the same actions, on any host."""
    rng = np.random.default_rng((config.seed, salt, index, step, 1))
    gumbel = rng.gumbel(size=logits.shape).astype(np.float32)
    return np.argmax(logits + gumbel, axis=1).astype(np.int32)


def rollout(env: VectorEnv, predict_fn, index: int, *, salt: int = 0):
    """Run one vectorized episode through ``predict_fn`` (the serving
    router, in the real loop): obs -> (logits, served model version).

    Returns a `Trajectory`. Pure numpy on this side of predict_fn.
    """
    c = env.config
    obs_steps = []
    act_steps = []
    rew_steps = []
    version = 0
    for t in range(c.horizon):
        obs = env.observe(index, t, salt)
        logits, version = predict_fn(obs)
        actions = sample_actions(logits, c, index, t, salt)
        obs_steps.append(obs)
        act_steps.append(actions)
        rew_steps.append(env.rewards(obs, actions))
    return Trajectory(
        index=index,
        policy_version=int(version),
        obs=np.stack(obs_steps),
        actions=np.stack(act_steps),
        rewards=np.stack(rew_steps),
    )
