"""A TpuJob worker that trains ResNet-50 through `fit()` from record files.

The pattern of `lm_job.py`: the TpuJob's command is

    python -m kubeflow_tpu_torch.launcher \
        --module kubeflow_tpu_torch.testing.workers.resnet_records_job:main

and each incarnation of the gang runs `fit()` with an `AnomalyGuard` and
a `Checkpointer` on ResNet-50 as `bench.py`'s default run trains it
(1000 classes, bf16 compute over f32 params, SGD-Nesterov lr 0.4,
batch 256 at 224), its batches read from disk by
`RecordDataset(...).device_iter()` (uint8 images, int32 labels; the
shuffle seeded, so a resumed run repositions onto the same sequence).
cuDNN is pinned to deterministic algorithms and TF32 is off, so a step
repeated from a restored checkpoint repeats bitwise.

Env (besides the operator's TPUJOB_*):

- ``KFTPU_APISERVER``: the apiserver facade (one URL or an endpoint list;
  ``KFTPU_CA`` pins the CA of https ones); every step's loss goes to
  the TpuJob's ``status.metrics``, and the run that finishes reports
  its observation: the final loss, ``resumed_from``, ``steps_done``, the
  median step ms, the peak device memory, the restore and fast-forward
  seconds and each flash kernel's launches (none are expected).
- ``KFTPU_RECORDS``: the record files, separated by ``os.pathsep``;
  ``KFTPU_SHUFFLE_BUFFER`` (0) and ``KFTPU_DATA_SEED`` (0).
- ``KFTPU_CKPT_DIR``, ``KFTPU_TOTAL_STEPS`` (12), ``KFTPU_SAVE_EVERY`` (4).
- ``KFTPU_STEP_SLEEP_S`` (0): seconds slept after each step's report, to
  pace a run that a test interrupts mid-run whatever the host's load.
- ``KFTPU_RESNET_SIZE``: JSON overrides of ``model`` (``resnet50`` or
  ``tiny_resnet``), ``classes``, ``image``, ``batch`` and ``lr`` (the
  CPU tests take tiny_resnet at 32 x 32).
- ``KFTPU_SIGNAL_DIR``: the volume shared with the sidecar
  (`kubeflow_tpu_torch.sidecar`); when set, the worker waits for its
  ``SIGCONT`` file there before it touches the device.
- ``KFTPU_RESULTS_DIR``: the finished run writes its observation there
  (``observation.json``), for the sidecar to upload.
- ``KFTPU_DEVICE``: ``cpu`` runs it on the CPU (the tests); unset, CUDA,
  and without a GPU it raises.

Every step prints one JSON line (``{"event": "step", ...}``) with the
incarnation, the process id, the loss, the dataset's
``batches_delivered`` and the wall-clock time; so do the start (with
``torch.get_num_threads()``), the gate and the restore.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

from kubeflow_tpu_torch.testing.workers.lm_job import say

FULL_WIDTH = dict(model="resnet50", classes=1000, image=224, batch=256, lr=0.4)


def wait_for_gate(signal_dir: str, timeout: float = 600.0) -> float:
    """Block until the sidecar's SIGCONT file exists; returns the seconds
    waited."""
    from kubeflow_tpu_torch.sidecar import SIGCONT_FILE

    path = os.path.join(signal_dir, SIGCONT_FILE)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def main() -> int:
    import torch

    from kubeflow_tpu_torch._device import resolve_device
    from kubeflow_tpu_torch.launcher import report_metrics, report_observation
    from kubeflow_tpu_torch.models import resnet
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.train import AnomalyGuard, Checkpointer, Preempted, TrainConfig, Trainer, fit
    from kubeflow_tpu_torch.train.records import RecordDataset, RecordSpec

    api = HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"]))
    name, ns = os.environ["TPUJOB_NAME"], os.environ["TPUJOB_NAMESPACE"]
    incarnation = int(api.get("TpuJob", name, ns).status.get("restarts", 0) or 0)
    total = int(os.environ.get("KFTPU_TOTAL_STEPS", "12"))
    save_every = int(os.environ.get("KFTPU_SAVE_EVERY", "4"))
    step_sleep = float(os.environ.get("KFTPU_STEP_SLEEP_S", "0"))
    size = {**FULL_WIDTH, **json.loads(os.environ.get("KFTPU_RESNET_SIZE", "{}"))}
    say("start", incarnation=incarnation, time=time.time(),
        num_threads=torch.get_num_threads())
    signal_dir = os.environ.get("KFTPU_SIGNAL_DIR")
    if signal_dir:
        waited = wait_for_gate(signal_dir)
        say("gate", incarnation=incarnation, waited_s=waited, time=time.time())

    device = resolve_device(os.environ.get("KFTPU_DEVICE") or None)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build = getattr(resnet, size["model"])
    dtype = torch.bfloat16 if size["model"] == "resnet50" else torch.float32
    trainer = Trainer(
        build(size["classes"], dtype=dtype, device=device, seed=0),
        TrainConfig(batch_size=size["batch"], learning_rate=size["lr"], total_steps=10_000,
                    fsdp_params=False),
        device=device, guard=AnomalyGuard())
    spec = RecordSpec.of(image=("uint8", (size["image"], size["image"], 3)),
                         label=("int32", ()))
    dataset = RecordDataset(
        os.environ["KFTPU_RECORDS"].split(os.pathsep), spec, size["batch"],
        shuffle_buffer=int(os.environ.get("KFTPU_SHUFFLE_BUFFER", "0")),
        seed=int(os.environ.get("KFTPU_DATA_SEED", "0")), epochs=0)
    data = dataset.device_iter(device)
    ckpt = Checkpointer(os.environ["KFTPU_CKPT_DIR"], save_interval_steps=save_every)
    seconds = {"restore_s": 0.0, "fast_forward_s": 0.0}
    restore, reposition = ckpt.restore_latest, data.load_state_dict

    def timed_restore(template, **kwargs):
        t0 = time.perf_counter()
        restored = restore(template, **kwargs)
        seconds["restore_s"] = time.perf_counter() - t0
        if restored is not None:
            say("restored", incarnation=incarnation, step=restored.step,
                data_state=restored.data_state, restore_s=seconds["restore_s"],
                time=time.time())
        return restored

    def timed_reposition(state):
        t0 = time.perf_counter()
        reposition(state)
        seconds["fast_forward_s"] = time.perf_counter() - t0
        say("fast_forward", incarnation=incarnation, to=state["batches_delivered"],
            seconds=seconds["fast_forward_s"], time=time.time())

    ckpt.restore_latest, data.load_state_dict = timed_restore, timed_reposition
    _kernels.launches.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # A step's time runs from the end of the previous step's report (and
    # its pacing sleep) to this step's report: the batch, the step, its
    # sync and any save. The first step of an incarnation carries its
    # start-up and is left out of the median.
    step_ms, last = [], {"t": None}

    def on_metrics(step: int, rec: dict) -> None:
        now = time.perf_counter()
        if last["t"] is not None:
            step_ms.append((now - last["t"]) * 1e3)
        say("step", incarnation=incarnation, step=step, loss=rec["loss"],
            batches_delivered=data.state_dict()["batches_delivered"],
            step_ms=step_ms[-1] if last["t"] is not None else None, time=time.time())
        report_metrics(api, name, ns, step, {"loss": rec["loss"]})
        if step_sleep:
            time.sleep(step_sleep)
        last["t"] = time.perf_counter()

    try:
        result = fit(trainer, data, total, rng=0, checkpointer=ckpt, log_every=1,
                     on_metrics=on_metrics)
    finally:
        ckpt.close()
    launches = dict(_kernels.launches)
    if isinstance(result, Preempted):
        say("preempted", incarnation=incarnation, step=int(result.state.step),
            steps_done=result.steps_done, signum=result.signum, time=time.time())
        api.close()
        return 0
    observation = {
        "loss": result.history[-1]["loss"],
        "resumed_from": float(result.resumed_from or 0),
        "steps_done": float(result.steps_done),
        "step_ms": statistics.median(step_ms) if step_ms else float("nan"),
        "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if device.type == "cuda" else 0.0),
        **seconds,
        **{f"launches_{k}": float(v) for k, v in sorted(launches.items())},
    }
    report_observation(api, name, ns, observation)
    results_dir = os.environ.get("KFTPU_RESULTS_DIR")
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "observation.json"), "w") as f:
            json.dump({"incarnation": incarnation, **observation}, f)
    say("done", incarnation=incarnation, time=time.time(), **observation)
    api.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
