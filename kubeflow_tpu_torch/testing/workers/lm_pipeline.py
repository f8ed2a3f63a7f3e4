"""The pod steps of the nightly LM pipeline: eval, serve and teardown.

A Workflow (`api/workflow.py`) trains the LM as a TpuJob slice step
(`testing/workers/lm_job.py` through the launcher), then runs these
modes as pod steps, each ``python -m
kubeflow_tpu_torch.testing.workers.lm_pipeline <mode> ...`` with its
arguments rendered from the Workflow's parameters and step outputs:

- ``eval --ckpt-dir D --steps N --max-eval-loss L --observation JSON``:
  opens D read-only (`serving.servable.restore_module`, as
  `Servable.from_checkpoint` does) and restores its newest valid step
  into the LM. JSON is the train step's output, the TpuJob's observation
  (`${steps.train.output}`). The step restored must equal N and the
  observation's ``resumed_from + steps_done`` (the run that reports
  counts only its own steps). It computes the mean cross entropy on a
  held-out `SyntheticTokens` batch (the LM's batch and sequence, seed 1;
  training's stream is seed 0) on the default dispatch, and the same for
  the fresh init (seed 0) as a printed reference only. Output:
  ``promote`` when the step matches and the loss is finite and <= L,
  else ``hold``. The tokens are uniform, so a trained loss stays near
  ln(vocab): the gate catches a diverged or mismatched run, it does not
  measure learning.
- ``serve --ckpt-dir D --steps N``: `Servable.from_checkpoint` (next-token
  logits at the last position, max batch 4, every bucket warmed) ->
  `ModelRepository` -> `ModelServerApp` on a free localhost port, in
  this process; the requests of ``KFTPU_REQUESTS`` (JSON list of
  [format, batch, seq]; default: JSON 1 x 2048, JSON 3 x 2048, binary
  2 x 1001) go over HTTP with the launch counters zeroed just before and
  read just after. Each answer must equal, bitwise, the restored
  module's forward on the padded batch the server ran; the version the
  server reports must equal the checkpoint's step and N; on CUDA the
  requests must have made 16 flash_fwd launches a forward (one a layer)
  and nothing else. Output: ``{"version": V, "answered": K}``.
- ``teardown --ckpt-dir D``: removes D, whatever the DAG's outcome (the
  Workflow's ``onExit``). Output: ``clean``.

Env: ``KFTPU_APISERVER`` (the pod runner's), ``POD_NAME`` and
``POD_NAMESPACE`` (the Workflow controller's), through which the output
is reported (`controllers.workflow.report_step_output`);
``KFTPU_LM_SIZE`` as `lm_job` takes it; ``KFTPU_DEVICE=cpu`` runs on the
CPU (the tests), unset CUDA, and without a GPU it raises. On CUDA a run
that launched no flash kernel fails; nothing falls back to the CPU or to
the plain attention.

`pipeline_spec` builds the Workflow spec of the whole pipeline (train,
eval, serve, teardown) around a TpuJob spec that runs `lm_job`.

Every mode prints JSON lines (``{"event": ...}``) to its pod log: the
start (before any device work), the mode's numbers, and ``done`` with
the output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time

from kubeflow_tpu_torch.testing.workers.lm_job import FULL_WIDTH, say

REQUESTS = [("json", 1, 2048), ("json", 3, 2048), ("binary", 2, 1001)]
MAX_BATCH = 4
HELD_OUT_SEED = 1


def pipeline_spec(train_job: dict, *, steps: int, max_eval_loss: float, ckpt_dir: str,
                  save_every: int, kill_at: int, lm_size: dict,
                  requests=REQUESTS) -> dict:
    """The nightly pipeline as a Workflow spec dict. Parameters: `steps`,
    `max_eval_loss`, `ckpt_dir`, the LM's size and the serve requests,
    as JSON. Steps:

    - ``train``: a slice step, `train_job` (a TpuJob spec running
      `lm_job`) with its env's KFTPU_CKPT_DIR, KFTPU_TOTAL_STEPS and
      KFTPU_LM_SIZE templated from the parameters and KFTPU_SAVE_EVERY,
      KFTPU_KILL_AT_STEP set to `save_every`, `kill_at`;
    - ``eval`` after it, with ``${steps.train.output}`` (the job's
      observation) in its argv;
    - ``serve`` after eval, when ``${steps.eval.output} == promote``;
    - ``teardown``, the exit handler.
    """
    param = "${{workflow.parameters.{}}}".format
    env = {e["name"]: e["value"] for e in train_job.get("env") or ()}
    env.update({
        "KFTPU_CKPT_DIR": param("ckpt_dir"), "KFTPU_TOTAL_STEPS": param("steps"),
        "KFTPU_SAVE_EVERY": str(save_every), "KFTPU_KILL_AT_STEP": str(kill_at),
        "KFTPU_LM_SIZE": param("lm_size"),
    })
    job = {**train_job, "env": [{"name": k, "value": v} for k, v in env.items()]}

    def pod_step(mode: str, *args: str, **fields) -> dict:
        return {"name": mode,
                "command": [sys.executable, "-m", "kubeflow_tpu_torch.testing.workers."
                            "lm_pipeline", mode],
                "args": ["--ckpt-dir", param("ckpt_dir"), *args],
                "env": [{"name": "KFTPU_LM_SIZE", "value": param("lm_size")},
                        {"name": "KFTPU_REQUESTS", "value": param("requests")}],
                **fields}

    return {
        "parameters": {"steps": str(steps), "max_eval_loss": repr(float(max_eval_loss)),
                       "ckpt_dir": ckpt_dir, "lm_size": json.dumps(lm_size),
                       "requests": json.dumps([list(r) for r in requests])},
        "steps": [
            {"name": "train", "tpuJob": job},
            pod_step("eval", "--steps", param("steps"), "--max-eval-loss",
                     param("max_eval_loss"), "--observation", "${steps.train.output}",
                     dependencies=["train"]),
            pod_step("serve", "--steps", param("steps"), dependencies=["eval"],
                     when="${steps.eval.output} == promote"),
        ],
        "onExit": pod_step("teardown"),
    }


def last_logits(model, tokens):
    """The servable's function: next-token logits [n, V] (f32) at the
    last position."""
    from kubeflow_tpu_torch.models.transformer import lm_head

    h = model.features(tokens)[:, -1:]
    return lm_head(h, model.embedding, dtype=model.config.dtype)[:, 0]


def _report(output: str) -> None:
    from kubeflow_tpu_torch.controllers.workflow import report_step_output
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env

    api = HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"]))
    try:
        report_step_output(api, os.environ["POD_NAME"], os.environ["POD_NAMESPACE"], output)
    finally:
        api.close()


def _model(torch, device):
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM

    size = {**FULL_WIDTH, **json.loads(os.environ.get("KFTPU_LM_SIZE", "{}"))}
    widths = {k: size[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads",
                                   "head_dim", "d_ff")}
    cfg = TransformerConfig(**widths, dtype=getattr(torch, size["dtype"]),
                            remat_policy="none")
    return TransformerLM(cfg, device=device, seed=0), size


def _peak_gib(torch, device) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0


def _mean_loss(torch, model, batch) -> float:
    from kubeflow_tpu_torch.train.trainer import softmax_cross_entropy

    with torch.inference_mode():
        return float(softmax_cross_entropy(model(batch["tokens"]), batch["labels"]))


def run_eval(torch, device, args) -> str:
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving.servable import restore_module
    from kubeflow_tpu_torch.train import SyntheticTokens

    observation = json.loads(args.observation)
    model, size = _model(torch, device)
    batch = next(iter(SyntheticTokens(size["batch"], size["seq"], size["vocab_size"],
                                      seed=HELD_OUT_SEED, device=device)))
    _kernels.launches.clear()
    t0 = time.perf_counter()
    fresh_loss = _mean_loss(torch, model, batch)
    fresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = restore_module(model, args.ckpt_dir)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = _mean_loss(torch, model, batch)
    eval_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    if device.type == "cuda" and not launches.get("flash_fwd"):
        raise RuntimeError(f"the eval forwards launched no flash kernel: {launches}")
    observed = int(observation.get("resumed_from", 0) + observation.get("steps_done", 0))
    step_ok = step == args.steps == observed
    promote = step_ok and math.isfinite(loss) and loss <= args.max_eval_loss
    decision = "promote" if promote else "hold"
    say("eval", step=step, want_step=args.steps, observation_step=observed, loss=loss,
        fresh_init_loss=fresh_loss, max_eval_loss=args.max_eval_loss, decision=decision,
        held_out={"batch": size["batch"], "seq": size["seq"], "seed": HELD_OUT_SEED},
        restore_s=restore_s, eval_forward_s=eval_s, fresh_forward_s=fresh_s,
        launches=launches, peak_memory_gib=_peak_gib(torch, device), time=time.time())
    return decision


def _post(url: str, body: bytes, content_type: str):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type,
                                          "Accept": content_type})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read()


def run_serve(torch, device, args) -> str:
    import urllib.request

    import numpy as np

    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving import ModelRepository, ModelServerApp, Servable, wire
    from kubeflow_tpu_torch.web import serve

    requests = json.loads(os.environ.get("KFTPU_REQUESTS") or json.dumps(REQUESTS))
    model, size = _model(torch, device)
    rng = np.random.default_rng(HELD_OUT_SEED)
    t0 = time.perf_counter()
    servable = Servable.from_checkpoint(
        "lm", model, args.ckpt_dir, rng.integers(0, size["vocab_size"], (1, size["seq"])),
        max_batch=MAX_BATCH, device=device, apply_fn=last_logits)
    load_s = time.perf_counter() - t0
    server, thread = serve(ModelServerApp(ModelRepository([servable])), host="127.0.0.1",
                           port=0)
    base = f"http://127.0.0.1:{server.server_port}/v1/models/lm"
    batches = [rng.integers(0, size["vocab_size"], (n, s)) for _, n, s in requests]
    rows, answers = [], []
    try:
        with urllib.request.urlopen(base, timeout=60) as resp:
            status = json.loads(resp.read())["model_version_status"]
        versions = [int(v["version"]) for v in status]
        _kernels.launches.clear()
        for (fmt, n, s), tokens in zip(requests, batches):
            t0 = time.perf_counter()
            if fmt == "json":
                code, raw = _post(f"{base}:predict",
                                  json.dumps({"instances": tokens.tolist()}).encode(),
                                  "application/json")
                pred = np.asarray(json.loads(raw)["predictions"], np.float32)
            else:
                code, raw = _post(f"{base}:predict",
                                  wire.encode_tensor(tokens.astype(np.int32)),
                                  wire.TENSOR_CONTENT_TYPE)
                pred = wire.decode_tensor(raw)
            rows.append({"format": fmt, "batch": n, "seq": s, "status": code,
                         "latency_s": time.perf_counter() - t0})
            answers.append(pred)
        launches = dict(_kernels.launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    with torch.inference_mode():
        for row, tokens, pred in zip(rows, batches, answers):
            padded = np.zeros((servable._bucket_for(len(tokens)), tokens.shape[1]),
                              tokens.dtype)
            padded[:len(tokens)] = tokens
            direct = last_logits(servable.variables, torch.tensor(padded, device=device))
            direct = direct[:len(tokens)].float().cpu().numpy()
            row.update({"bucket": len(padded), "shape": list(pred.shape),
                        "bitwise": pred.shape == direct.shape and bool((pred == direct).all())})
    want_launches = ({"flash_fwd": size["n_layers"] * len(requests)}
                     if device.type == "cuda" else {})
    checks = {
        "answered": all(r["status"] == 200 for r in rows),
        "bitwise": all(r["bitwise"] for r in rows),
        "version": versions == [servable.version] == [args.steps],
        "launches": launches == want_launches,
    }
    say("serve", version=servable.version, versions=versions, load_s=load_s,
        requests=rows, launches=launches, want_launches=want_launches, checks=checks,
        peak_memory_gib=_peak_gib(torch, device), time=time.time())
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"serve checks failed: {failed}")
    return json.dumps({"version": servable.version, "answered": len(rows)})


def run_teardown(args) -> str:
    existed = os.path.isdir(args.ckpt_dir)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    if os.path.exists(args.ckpt_dir):
        raise RuntimeError(f"{args.ckpt_dir} is still there")
    say("teardown", removed=args.ckpt_dir, existed=existed, time=time.time())
    return "clean"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="lm_pipeline")
    parser.add_argument("mode", choices=("eval", "serve", "teardown"))
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--max-eval-loss", type=float, default=0.0)
    parser.add_argument("--observation", default="{}")
    args = parser.parse_args(argv)
    say("start", mode=args.mode, pod=os.environ.get("POD_NAME"), time=time.time())
    if args.mode == "teardown":
        output = run_teardown(args)
    else:
        import torch

        from kubeflow_tpu_torch._device import resolve_device

        device = resolve_device(os.environ.get("KFTPU_DEVICE") or None)
        run = run_eval if args.mode == "eval" else run_serve
        output = run(torch, device, args)
    _report(output)
    say("done", mode=args.mode, output=output, time=time.time())
    return 0


if __name__ == "__main__":
    sys.exit(main())
