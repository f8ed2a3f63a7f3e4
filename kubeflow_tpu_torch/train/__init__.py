"""Training on one device: the train step and the synthetic streams."""

from kubeflow_tpu_torch.train.data import SyntheticTokens
from kubeflow_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    softmax_cross_entropy,
)

__all__ = [
    "SyntheticTokens",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "make_optimizer",
    "softmax_cross_entropy",
]
