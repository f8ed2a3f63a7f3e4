"""Podracer-style RL workload: an actor–learner loop built ON the port's
serving, training, and control-plane primitives — actors do policy
inference through the ServingDeployment data plane, the learner is a
stock guarded `fit()`, and weight publication rides the CR modelVersion
drain-roll. Counterpart of `kubeflow_tpu/rl`, with the same names."""

from kubeflow_tpu_torch.rl.env import (
    EnvConfig,
    Trajectory,
    VectorEnv,
    rollout,
    sample_actions,
)
from kubeflow_tpu_torch.rl.loop import (
    PublishRecord,
    RLConfig,
    RLResult,
    build_learner,
    bump_model_version,
    run_actor_learner,
)
from kubeflow_tpu_torch.rl.policy import (
    PolicyCheckpointPublisher,
    PolicyMLP,
    PolicyWithLoss,
    extract_policy_variables,
    init_policy_variables,
    make_policy_servable,
    split_predictions,
)
from kubeflow_tpu_torch.rl.replay import ReplayQueue, ReplayStalled

__all__ = [
    "EnvConfig",
    "Trajectory",
    "VectorEnv",
    "rollout",
    "sample_actions",
    "PublishRecord",
    "RLConfig",
    "RLResult",
    "build_learner",
    "bump_model_version",
    "run_actor_learner",
    "PolicyCheckpointPublisher",
    "PolicyMLP",
    "PolicyWithLoss",
    "extract_policy_variables",
    "init_policy_variables",
    "make_policy_servable",
    "split_predictions",
    "ReplayQueue",
    "ReplayStalled",
]
