"""A TpuJob worker that trains the TransformerLM through `fit()`.

The pattern of the JAX package's `tests/e2e/resume_worker.py`, at the
bench's full width: the TpuJob's command is

    python -m kubeflow_tpu_torch.launcher \
        --module kubeflow_tpu_torch.testing.workers.lm_job:main

and each incarnation of the gang runs `fit()` with a `Checkpointer` on
the LM (`bench.py --workload lm`'s: vocab 32000, d_model 1024, 16
layers, 8 x 128 heads, d_ff 4096, bf16 compute over f32 params; adamw
with a bf16 first moment, an `AnomalyGuard`, `SyntheticTokens` at 8 x
2048 varying per step), on the default dispatch: on CUDA the flash
forward, delta and fused backward kernels.

Env (besides the operator's TPUJOB_*):

- ``KFTPU_APISERVER``: the apiserver facade, one URL or an endpoint list
  (``KFTPU_CA`` pins the CA of https ones); every step's loss goes to
  the TpuJob's ``status.metrics`` (`report_metrics`), and the run that
  finishes reports its observation (`report_observation`): the final
  loss, ``resumed_from``, ``steps_done``, the median step ms, the peak
  device memory and each kernel's launches (``launches_<kernel>``). A
  call the control plane cannot answer (no endpoint serving, as while a
  standby takes over) is retried every 0.2 s for up to
  ``API_OUTAGE_S``; each acked step report prints an ``acked`` line.
- ``KFTPU_CKPT_DIR``, ``KFTPU_TOTAL_STEPS`` (8), ``KFTPU_SAVE_EVERY`` (4),
  ``KFTPU_KILL_AT_STEP`` (0 = never), ``KFTPU_KILL_RANK`` (0): that rank
  of the first incarnation (the job's ``status.restarts`` is 0)
  SIGKILLs itself after that step, once the newest save at or below it
  is committed on disk, so the operator's whole-gang restart resumes it
  from there.
- ``KFTPU_MESH``: a JSON `MeshSpec` for a gang of several workers
  (``replicas`` > 1), ``{"dp": -1}`` by default, as JAX's
  ``tests/e2e/train_worker.py``; ``{"fsdp": -1}`` shards the parameters
  and the adamw state over the gang (ZeRO-3). The batch is the global
  batch: each rank trains on its rows of it.
- ``KFTPU_STEP_SLEEP_S`` (0): seconds slept after each step's report, to
  pace a run that a test preempts mid-run whatever the host's load.
- ``KFTPU_LM_SIZE``: JSON overrides of the model's widths, ``batch``,
  ``seq``, ``dtype`` and ``lr`` (the CPU tests shrink it).
- ``KFTPU_DEVICE``: ``cpu`` runs it on the CPU (the tests); unset, CUDA,
  and without a GPU it raises. On CUDA a run that launched none of the
  flash kernels fails.
- ``KFTPU_TRACE_DIR`` (unset): a `train/profiling.Profiler` traces two
  steps of the run (the second and third of this process) into that
  directory, where TensorBoard's PyTorch profiler plugin reads it (a
  Tensorboard CR's `logspath`), and the worker prints one ``trace``
  line (``written``, the files) once the trace is on disk.
- ``KFTPU_DIGESTS`` (0): 1 logs sha256 digests of the state each save
  writes and each restore reads (parameters and optimizer state apart)
  and of every step's batch, so two incarnations' logs show which of
  them moved when a resumed step differs. Off by default: at full width
  a state digest copies 3 GB to the host.

A gang of several workers trains one model: the launcher joined the
process group (`parallel/distributed.initialize_from_env`, whose
backend the ``start`` line names), the LM and its stream sit on the
`MeshSpec`'s process mesh, and `fit()` reduces the gradients across the
ranks. Rank 0 writes the checkpoints (every other rank opens the
directory ``read_only`` and restores its piece of the step rank 0
took), reports the metrics and the observation; every rank prints its
own lines and, on CUDA, fails unless it launched the flash kernels. A
rank whose `fit()` raises (a peer died: its collectives fail within
the group timeout) prints a ``failed`` line and exits non-zero, so the
operator restarts the gang whole.

Every step prints one JSON line (``{"event": "step", ...}``, with the
incarnation, the rank, the process id, the loss, the step's seconds in
collectives and the wall-clock time), as do
the start (once torch is imported and the job read, with
``torch.get_num_threads()``) and the kill, so the pod log holds each
incarnation's curve. A preemption spends no restart,
so two runs of one incarnation are told apart by their process ids.

Preemption: the operator deletes the pod and the runner sends SIGTERM;
`fit()` saves at the next step boundary, waits for the save's write and
returns `Preempted`. The worker then prints ``{"event": "preempted",
"step": ...}`` (with its launch counts, steps done and when fit()
returned) and exits 0 WITHOUT reporting an observation: the run is not finished, and the
job's status must not read a victim's half-run as its result. The pod
was deleted, so no runner reads that exit as the job's success; the
next placement resumes from the preemption's save.

A drain (the job's namespace deleted, a Profile's teardown) removes the
TpuJob with its pod: a step report that finds the job gone prints one
``job_gone`` line and is dropped, so `fit()` runs on to the SIGTERM's
step boundary, saves and returns `Preempted` as above.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import sys
import time

FULL_WIDTH = dict(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8, head_dim=128,
                  d_ff=4096, batch=8, seq=2048, dtype="bfloat16", lr=3e-4)
# The kernels the default dispatch runs in a train step on CUDA.
STEP_KERNELS = ("flash_fwd", "flash_delta", "flash_bwd_fused")
# How long a call rides out a control plane that answers nothing.
API_OUTAGE_S = 60.0


def say(event: str, **fields) -> None:
    print(json.dumps({"event": event, "pid": os.getpid(), **fields}), flush=True)


def until_acked(call):
    """`call()`, retried while the control plane cannot answer it (every
    endpoint refusing, or 503 while a store fail-stops), as a CLI writer
    rides out a failover; raises once API_OUTAGE_S has passed."""
    import http.client

    from kubeflow_tpu_torch.testing.fake_apiserver import Unavailable

    deadline = time.monotonic() + API_OUTAGE_S
    while True:
        try:
            return call()
        except (Unavailable, http.client.HTTPException, OSError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def tree_digest(tree) -> str:
    """sha256 over every tensor of a tree of dicts (None stays), by path
    in sorted order: dtype, shape and bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(node, path: str) -> None:
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}")
        elif isinstance(node, torch.Tensor):
            t = node.detach().to("cpu").contiguous()
            h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif node is not None:
            h.update(f"{path}={node!r}".encode())

    walk(tree, "")
    return h.hexdigest()[:16]


def state_digests(tree: dict) -> dict:
    """Digests of a `TrainState.state_dict()` tree: the parameters (with
    the batch statistics, where the model has them), the optimizer
    state, and the rest."""
    return {
        "params": tree_digest({k: tree.get(k) for k in ("params", "batch_stats")}),
        "opt_state": tree_digest(tree["opt_state"]),
        "rest": tree_digest({k: tree.get(k) for k in ("step", "guard")}),
    }


class DigestedStream:
    """A resumable stream that remembers the digest of each batch it
    yields (`last`); the protocol (state_dict, load_state_dict,
    perturb) goes to the stream it wraps."""

    def __init__(self, data):
        self.data = data
        self.last: str | None = None
        if getattr(data, "perturb", None) is None:
            self.perturb = None

    def state_dict(self) -> dict:
        return self.data.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.data.load_state_dict(state)

    def perturb(self, salt: int) -> None:
        self.data.perturb(salt)

    def __iter__(self):
        for batch in self.data:
            self.last = tree_digest(batch)
            yield batch


def log_digests(ckpt, incarnation: int) -> None:
    """Log the digests of what each of `ckpt`'s saves and restores hold."""
    save, restore = ckpt.save, ckpt.restore_latest

    def logged_save(step, state, **kwargs):
        saved = save(step, state, **kwargs)
        if saved:
            say("saved", incarnation=incarnation, step=step,
                **state_digests(state.state_dict() if hasattr(state, "state_dict") else state))
        return saved

    def logged_restore(template, **kwargs):
        restored = restore(template, **kwargs)
        if restored is not None:
            say("restored", incarnation=incarnation, step=restored.step,
                data_state=restored.data_state, **state_digests(restored.state))
        return restored

    ckpt.save, ckpt.restore_latest = logged_save, logged_restore


def wait_committed(directory: str, step: int, timeout: float = 120.0) -> None:
    """Block until rank 0's save of `step` is committed and verified in
    `directory` (a rank that does not write waits for the writer)."""
    from pathlib import Path

    from kubeflow_tpu_torch.train.checkpoint import MANIFEST_NAME, holds_step

    deadline = time.monotonic() + timeout
    while not ((Path(directory) / str(step) / MANIFEST_NAME).exists()
               and holds_step(directory, step)):
        if time.monotonic() > deadline:
            raise RuntimeError(f"step {step}'s save was not committed in {timeout} s")
        time.sleep(0.1)


def main() -> int:
    import torch

    from kubeflow_tpu_torch._device import resolve_device
    from kubeflow_tpu_torch.launcher import report_metrics, report_observation
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.parallel import MeshSpec, ProcessEnv, build_mesh
    from kubeflow_tpu_torch.parallel import distributed
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.testing.fake_apiserver import NotFound
    from kubeflow_tpu_torch.train import (
        AnomalyGuard, Checkpointer, Preempted, SyntheticTokens, TrainConfig, Trainer, fit)
    from kubeflow_tpu_torch.train.profiling import Profiler, ProfileSchedule

    device = resolve_device(os.environ.get("KFTPU_DEVICE") or None)
    api = HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"]))
    name, ns = os.environ["TPUJOB_NAME"], os.environ["TPUJOB_NAMESPACE"]
    incarnation = int(until_acked(lambda: api.get("TpuJob", name, ns)).status.get(
        "restarts", 0) or 0)
    total = int(os.environ.get("KFTPU_TOTAL_STEPS", "8"))
    save_every = int(os.environ.get("KFTPU_SAVE_EVERY", "4"))
    kill_at = int(os.environ.get("KFTPU_KILL_AT_STEP", "0"))
    kill_rank = int(os.environ.get("KFTPU_KILL_RANK", "0"))
    step_sleep = float(os.environ.get("KFTPU_STEP_SLEEP_S", "0"))
    size = {**FULL_WIDTH, **json.loads(os.environ.get("KFTPU_LM_SIZE", "{}"))}
    digests = os.environ.get("KFTPU_DIGESTS", "0") == "1"
    trace_dir = os.environ.get("KFTPU_TRACE_DIR")
    profiler = (Profiler(trace_dir, ProfileSchedule(start_step=1, num_steps=2))
                if trace_dir else None)
    seen: dict = {}  # the trace line printed; the step that found the job gone
    pe = ProcessEnv.from_env()
    rank, mesh = pe.process_id, None
    if pe.num_processes > 1:
        mesh = build_mesh(MeshSpec(**json.loads(os.environ.get("KFTPU_MESH") or '{"dp": -1}')))
        if device.type == "cuda":  # the card initialize_from_env set
            device = torch.device("cuda", torch.cuda.current_device())
    say("start", incarnation=incarnation, rank=rank, time=time.time(), device=str(device),
        num_threads=torch.get_num_threads(), gang=distributed.started(),
        mesh={a: n for a, n in mesh.shape.items() if n > 1} if mesh else None)

    widths = {k: size[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads",
                                   "head_dim", "d_ff")}
    cfg = TransformerConfig(**widths, dtype=getattr(torch, size["dtype"]),
                            remat_policy="none")
    trainer = Trainer(
        TransformerLM(cfg, device=device, seed=0, mesh=mesh),
        TrainConfig(batch_size=size["batch"], learning_rate=size["lr"], total_steps=10_000,
                    optimizer="adamw", adam_mu_dtype="bfloat16", label_smoothing=0.0,
                    fsdp_params=bool(mesh and mesh.shape["fsdp"] > 1),
                    train_metrics="loss"),
        input_key="tokens", label_key="labels", device=device, guard=AnomalyGuard())
    data = SyntheticTokens(size["batch"], size["seq"], size["vocab_size"], seed=0,
                           vary_per_step=True, device=device, mesh=mesh)
    ckpt_dir = os.environ["KFTPU_CKPT_DIR"]
    if trainer.is_writer:
        ckpt = Checkpointer(ckpt_dir, save_interval_steps=save_every)
    else:
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt = Checkpointer(ckpt_dir, save_interval_steps=save_every, read_only=True)
    if digests:
        data = DigestedStream(data)
        log_digests(ckpt, incarnation)
    _kernels.launches.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def on_metrics(step: int, rec: dict) -> None:
        say("step", incarnation=incarnation, rank=rank, step=step, loss=rec["loss"],
            step_ms=size["batch"] / rec["examples_per_sec"] * 1e3,
            collective_ms=trainer.collective_seconds() * 1e3, time=time.time(),
            **({"batch": data.last} if digests else {}))
        if incarnation == 0 and step == kill_at and rank == kill_rank and rank != 0:
            # Not the writer: wait for rank 0's save to be on disk.
            committed = step - step % save_every
            wait_committed(ckpt_dir, committed)
            say("kill", incarnation=incarnation, rank=rank, step=step, committed=committed,
                time=time.time())
            os.kill(os.getpid(), signal.SIGKILL)
        if not trainer.is_writer:
            return
        if profiler is not None and profiler.trace_written and "trace" not in seen:
            seen["trace"] = step
            say("trace", step=step, written=True, dir=trace_dir,
                files=sorted(os.listdir(trace_dir)), time=time.time())
        if "gone" in seen:
            return
        try:
            until_acked(lambda: report_metrics(api, name, ns, step, {"loss": rec["loss"]}))
        except NotFound:
            # Drained with its namespace: the SIGTERM for its pod follows.
            seen["gone"] = step
            say("job_gone", incarnation=incarnation, step=step, time=time.time())
            return
        say("acked", incarnation=incarnation, step=step, time=time.time(),
            failovers=api.failovers)
        if step_sleep:
            time.sleep(step_sleep)
        if incarnation == 0 and step == kill_at and rank == kill_rank:
            # A kill while the newest save is still being written would
            # leave it partial and the resume would start from scratch.
            ckpt.wait()
            committed = ckpt.latest_step()
            if committed != step - step % save_every:
                raise RuntimeError(f"step {step}: newest committed save is {committed}")
            say("kill", incarnation=incarnation, step=step, committed=committed,
                time=time.time())
            os.kill(os.getpid(), signal.SIGKILL)

    try:
        result = fit(trainer, data, total, rng=0, checkpointer=ckpt, log_every=1,
                     on_metrics=on_metrics, profiler=profiler)
        fit_returned = time.time()
    except Exception as err:
        # A gang's survivor of a dead peer ends here: its collective failed.
        say("failed", incarnation=incarnation, rank=rank, time=time.time(),
            error=f"{type(err).__name__}: {err}"[:500])
        raise
    finally:
        ckpt.close()
    launches = dict(_kernels.launches)
    if device.type == "cuda":
        missing = [k for k in STEP_KERNELS if not launches.get(k)]
        if missing:
            raise RuntimeError(f"the train steps launched none of {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
    if not trainer.is_writer:
        say("done", incarnation=incarnation, rank=rank, time=time.time(),
            steps_done=result.steps_done, peak_memory_gib=peak,
            **{f"launches_{k}": v for k, v in sorted(launches.items())})
        api.close()
        return 0
    if isinstance(result, Preempted):
        say("preempted", incarnation=incarnation, step=int(result.state.step),
            steps_done=result.steps_done, signum=result.signum, fit_returned=fit_returned,
            time=time.time(), **{f"launches_{k}": v for k, v in sorted(launches.items())})
        api.close()
        return 0
    # The first step of an incarnation carries its start-up.
    step_ms = [size["batch"] / rec["examples_per_sec"] * 1e3 for rec in result.history[1:]]
    observation = {
        "loss": result.history[-1]["loss"],
        "resumed_from": float(result.resumed_from or 0),
        "steps_done": float(result.steps_done),
        "step_ms": statistics.median(step_ms) if step_ms else float("nan"),
        "peak_memory_gib": peak,
        **{f"launches_{k}": float(v) for k, v in sorted(launches.items())},
    }
    until_acked(lambda: report_observation(api, name, ns, observation))
    say("done", incarnation=incarnation, rank=rank, time=time.time(), failovers=api.failovers,
        handshakes=api.handshakes, **observation)
    api.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
