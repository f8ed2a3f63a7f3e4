"""The worker-pod launcher (`launcher/launcher.py`): ``python -m
kubeflow_tpu_torch.launcher``."""

from kubeflow_tpu_torch.launcher.launcher import (
    main,
    report_metrics,
    report_observation,
    run_and_stream,
)

__all__ = ["main", "report_metrics", "report_observation", "run_and_stream"]
