"""A TpuJob worker that trains a tiny ResNet over a dp mesh of its gang.

Counterpart of the JAX package's ``tests/e2e/train_worker.py``: the
process joins the gang through the TPUJOB_* contract, then every rank
takes six SGD steps of one `Trainer` on a dp mesh over the gang's
processes, on its rows of `SyntheticImages`' global batch (4 examples a
rank, 32 x 32, 10 classes); batch norm takes the global batch's moments
and the gradients are all-reduced. The loss must fall. Rank 0 reports
``{"loss", "first_loss"}`` as the TpuJob's observation when
KFTPU_APISERVER is set (KFTPU_TOKEN and KFTPU_CA as the facade needs).

    python -m kubeflow_tpu_torch.testing.workers.train_worker
"""

from __future__ import annotations

import math
import os
import sys


def main() -> int:
    from kubeflow_tpu_torch.launcher import report_observation
    from kubeflow_tpu_torch.models.resnet import tiny_resnet
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env
    from kubeflow_tpu_torch.parallel import distributed
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.train import SyntheticImages, TrainConfig, Trainer

    pe = initialize_from_env(device=os.environ.get("KFTPU_DEVICE") or None)
    device = distributed.started().get("device") or os.environ.get("KFTPU_DEVICE") or "cuda"
    mesh = build_mesh(MeshSpec(dp=-1))
    config = TrainConfig(batch_size=4 * pe.num_processes, learning_rate=0.05,
                         warmup_steps=1, total_steps=6, fsdp_params=False)
    trainer = Trainer(tiny_resnet(device=device, mesh=mesh), config, device=device)
    state = trainer.init_state(0)
    data = SyntheticImages(config.batch_size, image_size=32, num_classes=10,
                           device=device, mesh=mesh)
    step = trainer.make_train_step()
    losses = []
    for batch in data:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if len(losses) >= config.total_steps:
            break
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses  # it actually learned
    print(f"rank {pe.process_id}: losses {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    if pe.process_id == 0 and os.environ.get("KFTPU_APISERVER"):
        report_observation(
            HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"])),
            os.environ["TPUJOB_NAME"], os.environ["TPUJOB_NAMESPACE"],
            {"loss": losses[-1], "first_loss": losses[0]},
        )
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
