"""Worker sidecar for gang-scheduled jobs.

Counterpart of `kubeflow_tpu/sidecar/`: a per-worker sidecar that
sequences the main container against the rest of the gang."""

from kubeflow_tpu_torch.sidecar.controller import (
    SIGCONT_FILE,
    SIGTERM_FILE,
    SidecarController,
)

__all__ = ["SIGCONT_FILE", "SIGTERM_FILE", "SidecarController"]
