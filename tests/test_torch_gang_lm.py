"""A gang of two gloo processes trains the tiny LM as one model, against
the JAX package's one-device `Trainer` on the same numpy batch.

Both sides start from the same JAX-initialised parameters (converted,
`convert.from_flax`); the JAX side runs flash attention in Pallas
interpret mode on a one-device mesh, as its own CPU tests do. The port's
two ranks are started through the TPUJOB_* contract (`testing/gang.
run_gang`, 120 s) and take, on each of three process meshes (dp = 2,
fsdp = 2 with ZeRO-3, and dp x sp = 1 x 2 around the process ring), the
gradient of their rows of the batch (their sp chunk of it) and one adamw
step. Each rank's global loss and its gradients (ZeRO-3 shards gathered)
are held to JAX's at atol = rtol = 5e-5 in f32, the reference's own
flash gate; the parameters after the step at JAX's test_torch_trainer
bound (adam turns a gradient near 0 into a step of about ±lr whatever
its rounding: atol 2·lr, and a median under 1e-6). The fsdp ranks keep
exactly the shards JAX's `state_shardings` gives the same model on an
fsdp = 2 mesh, and report them so (`state_shardings`, `abstract_state`);
between steps their model holds none of those parameters whole, and the
eval step (which gathers them) gives JAX's loss.
"""

import json
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.parallel import build_mesh as jax_build_mesh
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.convert import _flatten, _torch_key
from kubeflow_tpu_torch.testing.gang import run_gang

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64, remat_policy="none")
SEQ, BATCH = 128, 4
TOL = dict(atol=5e-5, rtol=5e-5)
TCFG = dict(batch_size=BATCH, learning_rate=1e-2, warmup_steps=1, total_steps=10,
            optimizer="adamw", label_smoothing=0.0, fsdp_params=True,
            train_metrics="loss")
MESHES = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}, "dp1xsp2": {"dp": 1, "sp": 2}}

_WORKER = r"""
import json, sys
import torch
from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, distributed, initialize_from_env
from kubeflow_tpu_torch.parallel.sharding import local_batch
from kubeflow_tpu_torch.train import TrainConfig, Trainer

inp, out, lm, tcfg, meshes = sys.argv[1:6]
pe = initialize_from_env(device="cpu")
given = torch.load(inp, weights_only=True)
result = {}
for name, spec in json.loads(meshes).items():
    mesh = build_mesh(MeshSpec(**spec))
    model = TransformerLM(TransformerConfig(**json.loads(lm), dtype=torch.float32,
                                            attention_impl="flash"), mesh=mesh, device="cpu")
    model.load_state_dict(given["params"])
    trainer = Trainer(model, TrainConfig(**json.loads(tcfg)), input_key="tokens",
                      label_key="labels", device="cpu")
    state = trainer.init_state()
    batch = local_batch(mesh, given["batch"], seq_keys=("tokens", "labels"))
    eval_loss = trainer.make_eval_step()(state, batch)["loss"]
    metrics, grads = trainer.make_grad_step()(state, batch)
    grads = trainer.gather_params(grads)
    state, _ = trainer.make_train_step()(state, batch)
    shardings = trainer.state_shardings()
    result[name] = {
        "loss": metrics["loss"], "grads": grads, "eval_loss": eval_loss,
        # What the model holds between steps (ZeRO-3: no whole sharded
        # parameter), and the parameters it keeps whole.
        "model_numel": {n: torch.tensor(p.numel()) for n, p in model.named_parameters()},
        "sharded": sorted(trainer.sharded),
        "params": trainer.gather_state(state)["params"],
        "shapes": {n: torch.tensor(t.shape) for n, t in state.state_dict()["params"].items()},
        "rows": torch.tensor([len(batch["tokens"]), batch["tokens"].shape[1]]),
        # state_shardings' split of each parameter and of its adamw moments,
        # and abstract_state's shape of each rank's piece.
        "dims": {n: torch.tensor([-1 if pl.dim is None else pl.dim for pl in (
            shardings["params"][n], shardings["opt_state"]["mu"][n],
            shardings["opt_state"]["nu"][n])]) for n in shardings["params"]},
        "local_shapes": {n: torch.tensor(spec.local_shape)
                         for n, spec in trainer.abstract_state()["params"].items()},
    }
torch.save(result, f"{out}.{pe.process_id}")
distributed.shutdown()
"""


def _unbox(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _jax_trainer(devices, spec):
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    mesh = jax_build_mesh(spec, devices=devices)
    return jtrainer.Trainer(
        jtf.TransformerLM(cfg, mesh=mesh), jtrainer.TrainConfig(**TCFG), mesh,
        example_input_shape=(2, SEQ), example_input_dtype=jnp.int32,
        input_key="tokens", label_key="labels",
    )


@pytest.fixture(scope="module")
def jax_step():
    """JAX's one-device step: the initial params, the batch, its loss and
    gradients, and the params after one adamw step."""
    trainer = _jax_trainer(jax.devices()[:1], JaxMeshSpec(dp=-1))
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, TINY["vocab_size"], (BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(params):
        logits = state.apply_fn({"params": params}, jnp.asarray(batch["tokens"]))
        return jtrainer.softmax_cross_entropy(logits, jnp.asarray(batch["labels"]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    init = _unbox(state.params)
    state, _ = trainer.make_train_step()(
        state, jax.tree.map(lambda x: jnp.asarray(x, jnp.int32), batch))
    return init, batch, float(loss), _unbox(grads), _unbox(state.params)


@pytest.fixture(scope="module")
def gang(jax_step, tmp_path_factory):
    """Each rank's results on each mesh (one gang runs all three)."""
    init, batch, *_ = jax_step
    tmp = tmp_path_factory.mktemp("gang_lm")
    torch.save({"params": convert.from_flax(init),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}, tmp / "in.pt")
    lm = {k: v for k, v in TINY.items()}
    runs = run_gang([sys.executable, "-c", _WORKER, str(tmp / "in.pt"), str(tmp / "out.pt"),
                     json.dumps(lm), json.dumps(TCFG), json.dumps(MESHES)], 2, timeout=120,
                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert all(rc == 0 for rc, _ in runs), "\n".join(text for _, text in runs)
    return [torch.load(tmp / f"out.pt.{r}", weights_only=True) for r in range(2)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gang_step_matches_jax_one_device_step(jax_step, gang, mesh):
    _, _, jloss, jgrads, jafter = jax_step
    want_grads, want_after = convert.from_flax(jgrads), convert.from_flax(jafter)
    sp = MESHES[mesh].get("sp", 1)
    for rank, ranks in enumerate(gang):
        got = ranks[mesh]
        # Each rank held its rows (its chunk of the sequence) only.
        assert got["rows"].tolist() == [BATCH * sp // 2, SEQ // sp], (rank, got["rows"])
        np.testing.assert_allclose(float(got["loss"]), jloss, **TOL)
        assert set(got["grads"]) == set(want_grads)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                       err_msg=f"rank {rank} {name}", **TOL)
        diffs = []
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want_after[name].numpy(),
                                       atol=2 * TCFG["learning_rate"], rtol=0,
                                       err_msg=f"rank {rank} {name}")
            diffs.append(np.abs(p.numpy() - want_after[name].numpy()).ravel())
        assert np.median(np.concatenate(diffs)) < 1e-6
    # Replicated or gathered, every rank holds the same model.
    for name, p in gang[0][mesh]["params"].items():
        assert torch.equal(p, gang[1][mesh]["params"][name]), name


def test_fsdp_ranks_keep_the_shards_jax_state_shardings_gives(devices, gang):
    """The dims JAX's `state_shardings` puts on fsdp (fsdp = 2 mesh of two
    virtual devices, fsdp_params) are the dims the port's ZeRO-3 ranks
    halve; every other parameter is whole on both ranks."""
    trainer = _jax_trainer(devices[:2], JaxMeshSpec(fsdp=2))
    # convert's flax-path -> state-dict naming; the LM keeps flax's
    # layouts, so a spec's dims are the port's.
    specs = {_torch_key(path): tuple(sharding.spec)
             for path, sharding in _flatten(trainer.state_shardings().params)}
    assert any("fsdp" in spec for spec in specs.values())
    for rank in range(2):
        shapes = gang[rank]["fsdp2"]["shapes"]
        whole = {n: tuple(p.shape) for n, p in gang[rank]["fsdp2"]["params"].items()}
        assert set(specs) == set(whole)
        for name, spec in specs.items():
            spec = spec + (None,) * (len(whole[name]) - len(spec))
            want = tuple(d // 2 if s == "fsdp" else d for d, s in zip(whole[name], spec))
            assert tuple(shapes[name].tolist()) == want, (rank, name, spec)
            # The port's own report: `state_shardings` splits the dim JAX
            # puts on fsdp, for the parameter and both adamw moments, and
            # `abstract_state` gives each rank that piece's shape.
            dim = spec.index("fsdp") if "fsdp" in spec else -1
            assert gang[rank]["fsdp2"]["dims"][name].tolist() == [dim] * 3, (rank, name)
            assert tuple(gang[rank]["fsdp2"]["local_shapes"][name].tolist()) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero3_ranks_hold_only_shards_between_steps(jax_step, gang, mesh):
    """After init_state and after each step a ZeRO-3 rank's model holds
    no storage for its sharded parameters (fsdp = 2 shards some, the
    others none); the replicated ones stay whole. The eval step before
    the first update gathers them and gives JAX's loss on the batch."""
    _, _, jloss, *_ = jax_step
    whole = {n: p.numel() for n, p in convert.from_flax(jax_step[0]).items()}
    for rank, ranks in enumerate(gang):
        got = ranks[mesh]
        assert bool(got["sharded"]) == (mesh == "fsdp2"), (rank, got["sharded"])
        for name, numel in got["model_numel"].items():
            want = 0 if name in got["sharded"] else whole[name]
            assert int(numel) == want, (rank, name)
        np.testing.assert_allclose(float(got["eval_loss"]), jloss, **TOL)
