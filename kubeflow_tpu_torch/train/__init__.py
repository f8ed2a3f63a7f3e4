"""Training on one device: the train step, the synthetic streams, the
anomaly guard, checkpoints, profiling and the `fit` loop."""

from kubeflow_tpu_torch.train.checkpoint import Checkpointer, Restored
from kubeflow_tpu_torch.train.data import SyntheticImages, SyntheticTokens
from kubeflow_tpu_torch.train.guard import AnomalyGuard, GuardConfig
from kubeflow_tpu_torch.train.loop import (
    ElasticResize,
    FitResult,
    Preempted,
    ResizeEvent,
    ResizeProposal,
    TrainingDiverged,
    fit,
)
from kubeflow_tpu_torch.train.profiling import (
    MetricsLogger,
    PhaseRoofline,
    PhaseStat,
    Profiler,
    ProfileSchedule,
    annotate,
    annotated_scope,
    time_phase,
)
from kubeflow_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    softmax_cross_entropy,
)

__all__ = [
    "AnomalyGuard",
    "Checkpointer",
    "ElasticResize",
    "FitResult",
    "GuardConfig",
    "MetricsLogger",
    "PhaseRoofline",
    "PhaseStat",
    "Preempted",
    "ProfileSchedule",
    "Profiler",
    "ResizeEvent",
    "ResizeProposal",
    "Restored",
    "SyntheticImages",
    "SyntheticTokens",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "TrainingDiverged",
    "annotate",
    "annotated_scope",
    "fit",
    "make_optimizer",
    "softmax_cross_entropy",
    "time_phase",
]
