"""`fit()` on a gang of two gloo processes: ZeRO-3 state through a
preemption, one writer, dp- and fsdp-polymorphic restores, records on
the mesh, and a dead rank.

The gang (started through the TPUJOB_* contract, `testing/gang.
run_gang`) trains the tiny LM (f32, adamw, the anomaly guard) on its
rows of `SyntheticTokens`' global batch. On an fsdp = 2 mesh rank 1
alone is sent SIGTERM while it reports step 3: both ranks stop at the
next boundary, step 4, with `Preempted`, and rank 0 alone writes the
checkpoints (steps 2 and 4), in the one-process format. Then the same
ranks resume on a dp = 2 mesh (parameters replicated) to step 5: the
fsdp gang's checkpoint restores
on dp (JAX's tests/test_data_to_train_e2e.py:74 and
tests/test_trainer_resize.py's resize without the live reshard), and a
one-process trainer restores the gang's step-5 checkpoint as well. Every
step's loss equals an uninterrupted one-process run's at atol = rtol =
5e-5 (f32, sums in another order). `RecordDataset.device_iter` on the
mesh gives each rank its rows of the one-process batch (JAX's
tests/test_records.py:121). A rank SIGKILLed after its step 2 fails its
peer's next collective within the group timeout (KFTPU_GROUP_TIMEOUT_S
= 10): the survivor exits non-zero long before its 60 s deadline."""

import json
import os
import sys

import numpy as np
import torch

from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.testing.gang import run_gang
from kubeflow_tpu_torch.train import (
    AnomalyGuard, Checkpointer, SyntheticTokens, TrainConfig, Trainer, fit)
from kubeflow_tpu_torch.train import records as t_records

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64, remat_policy="none")
TCFG = dict(batch_size=4, learning_rate=1e-2, warmup_steps=1, total_steps=10,
            optimizer="adamw", label_smoothing=0.0, fsdp_params=True, train_metrics="loss")
SEQ = 64
TOL = dict(atol=5e-5, rtol=5e-5)
SPEC = t_records.RecordSpec.of(image=("uint8", (4, 4, 3)), label=("int32", ()))
ENV = dict(os.environ, OMP_NUM_THREADS="1", KFTPU_GROUP_TIMEOUT_S="10")

_COMMON = r"""
import json, os, signal, sys, time
import torch
from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, distributed, initialize_from_env
from kubeflow_tpu_torch.train import (
    AnomalyGuard, Checkpointer, Preempted, SyntheticTokens, TrainConfig, Trainer, fit)

ckpt_dir, out, lm, tcfg, seq = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5])
pe = initialize_from_env(device="cpu")


def run(spec, total, on_step=None):
    mesh = build_mesh(MeshSpec(**spec))
    model = TransformerLM(TransformerConfig(**json.loads(lm), dtype=torch.float32,
                                            attention_impl="flash"), mesh=mesh, device="cpu")
    trainer = Trainer(model, TrainConfig(**json.loads(tcfg)), input_key="tokens",
                      label_key="labels", device="cpu", guard=AnomalyGuard())
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = Checkpointer(ckpt_dir, save_interval_steps=2, read_only=not trainer.is_writer)
    data = SyntheticTokens(trainer.config.batch_size, seq, model.config.vocab_size, seed=0,
                           vary_per_step=True, device="cpu", mesh=mesh)
    losses = {}

    def on_metrics(step, rec):
        losses[step] = rec["loss"]
        if on_step:
            on_step(step)

    try:
        result = fit(trainer, data, total, rng=0, checkpointer=ckpt, log_every=1,
                     on_metrics=on_metrics)
    finally:
        ckpt.close()
    return mesh, trainer, result, losses
"""

_FIT = _COMMON + r"""
def sigterm_rank1(step):
    if step == 3 and pe.process_id == 1:
        os.kill(os.getpid(), signal.SIGTERM)

_, trainer, first, losses1 = run({"fsdp": 2}, 5, sigterm_rank1)
mesh, _, second, losses2 = run({"dp": 2}, 5)
from kubeflow_tpu_torch.train import records
ds = records.RecordDataset(sys.argv[6], records.RecordSpec.of(
    image=("uint8", (4, 4, 3)), label=("int32", ())), batch_size=8)
labels = next(iter(ds.device_iter("cpu", mesh)))["label"]
json.dump({
    "first": [type(first).__name__, int(first.state.step), first.resumed_from,
              getattr(first, "signum", None)],
    "second": [type(second).__name__, int(second.state.step), second.resumed_from,
               second.steps_done],
    "losses": {**losses1, **losses2}, "labels": labels.tolist(),
    "writer": trainer.is_writer,
    "shards": {n: list(t.shape) for n, t in first.state.state_dict()["params"].items()},
}, open(f"{out}.{pe.process_id}", "w"))
distributed.shutdown()
"""

_DEAD = _COMMON + r"""
def die(step):
    if step == 2 and pe.process_id == 1:
        os.kill(os.getpid(), signal.SIGKILL)

t0 = time.monotonic()
try:
    run({"dp": 2}, 50, die)
except Exception as err:
    print(json.dumps({"failed_after_s": time.monotonic() - t0, "error": repr(err)[:300]}),
          flush=True)
    sys.exit(3)
"""


def _one_process_losses(total: int) -> dict:
    model = TransformerLM(TransformerConfig(**TINY, dtype=torch.float32,
                                            attention_impl="flash"), device="cpu")
    trainer = Trainer(model, TrainConfig(**TCFG), input_key="tokens", label_key="labels",
                      device="cpu", guard=AnomalyGuard())
    data = SyntheticTokens(TCFG["batch_size"], SEQ, TINY["vocab_size"], seed=0,
                           vary_per_step=True, device="cpu")
    losses = {}
    fit(trainer, data, total, rng=0, log_every=1,
        on_metrics=lambda step, rec: losses.setdefault(step, rec["loss"]))
    return losses, trainer


def test_gang_fit_preempts_together_and_restores_across_layouts(tmp_path):
    records_path = str(tmp_path / "a.rec")
    rng = np.random.default_rng(0)
    t_records.write_records(records_path, SPEC, [
        {"image": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), "label": np.int32(i)}
        for i in range(16)])
    ckpt_dir = tmp_path / "ckpt"
    runs = run_gang([sys.executable, "-c", _FIT, str(ckpt_dir), str(tmp_path / "out"),
                     json.dumps(TINY), json.dumps(TCFG), str(SEQ), records_path], 2,
                    timeout=120, env=ENV)
    assert all(rc == 0 for rc, _ in runs), "\n".join(text for _, text in runs)
    got = [json.load(open(tmp_path / f"out.{r}")) for r in range(2)]
    want, trainer = _one_process_losses(5)
    for rank, g in enumerate(got):
        # Rank 1 alone was signalled; both stopped at the next boundary.
        assert g["first"][:3] == ["Preempted", 4, None], (rank, g["first"])
        assert g["second"] == ["FitResult", 5, 4, 1], (rank, g["second"])
        assert sorted(int(s) for s in g["losses"]) == [1, 2, 3, 4, 5]
        np.testing.assert_allclose([g["losses"][str(s)] for s in range(1, 6)],
                                   [want[s] for s in range(1, 6)], **TOL)
        assert g["labels"] == list(range(4 * rank, 4 * rank + 4)), g["labels"]
        assert g["writer"] == (rank == 0)
        # ZeRO-3: half the embedding's d_model on each fsdp rank.
        assert g["shards"]["embedding"] == [TINY["vocab_size"], TINY["d_model"] // 2]
    assert got[0]["first"][3] == got[1]["first"][3] != 0  # the agreed signal
    # One writer, the one-process format: steps 2 and 4, then 5.
    ckpt = Checkpointer(ckpt_dir, read_only=True)
    assert ckpt.all_steps() == [2, 4, 5]
    restored = ckpt.restore_latest(trainer.abstract_state())
    assert restored.step == 5
    assert restored.state["params"]["embedding"].shape == (TINY["vocab_size"], TINY["d_model"])
    state = trainer.load_state_dict(restored.state)
    assert int(state.step) == 5


def test_dead_rank_fails_its_peer_within_the_group_timeout(tmp_path):
    runs = run_gang([sys.executable, "-c", _DEAD, str(tmp_path / "ckpt"), str(tmp_path / "o"),
                     json.dumps(TINY), json.dumps(TCFG), str(SEQ)], 2, timeout=60, env=ENV)
    (rc0, out0), (rc1, _) = runs
    assert rc1 == -9, runs
    assert rc0 == 3, out0
    line = json.loads([x for x in out0.splitlines() if x.startswith('{"failed_after_s"')][0])
    # The survivor's collective failed on the closed connection or at the
    # 10 s group timeout, never at gloo's 30 minutes.
    assert line["failed_after_s"] < 30, line
