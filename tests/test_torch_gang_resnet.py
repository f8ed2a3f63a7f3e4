"""A gang of two gloo processes trains tiny_resnet as one model, with
batch norm over the global batch, against the JAX package's one-device
`Trainer` on the same numpy batch.

The weights are tests/test_torch_resnet.py's `flax_weights` (batch-norm
scales and statistics perturbed), converted for the port; the batch is
8 images of 32 x 32. The two ranks (started through the TPUJOB_*
contract, 120 s) hold 4 rows each and take one SGD-Nesterov step (the
bench's optimizer, label smoothing 0.1) on a dp = 2 mesh and on an
fsdp = 2 mesh with ZeRO-3 (each conv's output channels and the Dense's
input split over fsdp). Flax's `BatchNorm` under one jit over a sharded
batch normalises by the global batch's moments; the port's ranks sum
theirs over the batch group. Loss, parameters, momentum trace (the
step's gradient plus weight decay) and running statistics are held to
JAX's at atol = rtol = 1e-4, the tolerance of tests/
test_torch_resnet_train.py, on both ranks; the fsdp ranks keep the
shards JAX's `state_shardings` gives on an fsdp = 2 mesh
(tests/test_resnet_train.py:56).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_resnet import flax_weights  # noqa: E402

from kubeflow_tpu.models import resnet as jr  # noqa: E402
from kubeflow_tpu.parallel import MeshSpec, build_mesh  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch.models import convert  # noqa: E402
from kubeflow_tpu_torch.models.convert import _flatten  # noqa: E402
from kubeflow_tpu_torch.testing.gang import run_gang  # noqa: E402

BATCH, SIDE, CLASSES = 8, 32, 10
TOL = dict(atol=1e-4, rtol=1e-4)
TCFG = dict(batch_size=BATCH, learning_rate=0.1, warmup_steps=1, total_steps=20,
            fsdp_params=True)
MESHES = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}}

_WORKER = r"""
import json, sys
import torch
from kubeflow_tpu_torch.models.resnet import tiny_resnet
from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, distributed, initialize_from_env
from kubeflow_tpu_torch.parallel.sharding import local_batch
from kubeflow_tpu_torch.train import TrainConfig, Trainer
from kubeflow_tpu_torch.train.trainer import batch_stats

inp, out, tcfg, meshes = sys.argv[1:5]
pe = initialize_from_env(device="cpu")
given = torch.load(inp, weights_only=True)
result = {}
for name, spec in json.loads(meshes).items():
    mesh = build_mesh(MeshSpec(**spec))
    model = tiny_resnet(device="cpu", mesh=mesh)
    model.load_state_dict(given["weights"])
    trainer = Trainer(model, TrainConfig(**json.loads(tcfg)), device="cpu")
    state, metrics = trainer.make_train_step()(trainer.init_state(),
                                               local_batch(mesh, given["batch"]))
    tree = trainer.gather_state(state)
    result[name] = {
        "loss": metrics["loss"], "params": tree["params"],
        "trace": tree["opt_state"]["trace"], "stats": tree["batch_stats"],
        "shapes": {n: torch.tensor(t.shape) for n, t in state.state_dict()["params"].items()},
    }
torch.save(result, f"{out}.{pe.process_id}")
distributed.shutdown()
"""


def _jax_trainer(devices, spec):
    return jtrainer.Trainer(jr.tiny_resnet(), jtrainer.TrainConfig(**TCFG),
                            build_mesh(spec, devices=devices),
                            example_input_shape=(2, SIDE, SIDE, 3))


@pytest.fixture(scope="module")
def weights():
    return flax_weights(jr.tiny_resnet(), SIDE)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return {"image": rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, BATCH)}


@pytest.fixture(scope="module")
def jax_step(weights, batch):
    trainer = _jax_trainer(jax.devices()[:1], MeshSpec(dp=-1))
    state = trainer.init_state(jax.random.PRNGKey(0))
    params, stats = weights
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    state, metrics = trainer.make_train_step()(state, {
        "image": jnp.asarray(batch["image"]),
        "label": jnp.asarray(batch["label"], jnp.int32)})
    unbox = lambda tree: jax.tree.map(np.asarray, tree)
    return float(metrics["loss"]), {
        "params": convert.resnet_from_flax(unbox(state.params)),
        "trace": convert.resnet_from_flax(unbox(state.opt_state[1][0].trace)),
        "stats": convert.resnet_from_flax({}, unbox(state.batch_stats)),
    }


@pytest.fixture(scope="module")
def gang(weights, batch, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang_resnet")
    torch.save({"weights": convert.resnet_from_flax(*weights),
                "batch": {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}},
               tmp / "in.pt")
    runs = run_gang([sys.executable, "-c", _WORKER, str(tmp / "in.pt"), str(tmp / "out.pt"),
                     json.dumps(TCFG), json.dumps(MESHES)], 2, timeout=120,
                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert all(rc == 0 for rc, _ in runs), "\n".join(text for _, text in runs)
    return [torch.load(tmp / f"out.pt.{r}", weights_only=True) for r in range(2)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resnet_gang_step_matches_jax_global_batch_norm(jax_step, gang, mesh):
    jloss, want = jax_step
    for rank in range(2):
        got = gang[rank][mesh]
        np.testing.assert_allclose(float(got["loss"]), jloss, **TOL)
        for group, tensors in want.items():
            assert set(got[group]) == set(tensors), group
            for name, value in tensors.items():
                np.testing.assert_allclose(got[group][name].numpy(), value.numpy(),
                                           err_msg=f"rank {rank} {group} {name}", **TOL)
    # Global moments: the running statistics move identically on both ranks.
    for name, value in gang[0][mesh]["stats"].items():
        assert torch.equal(value, gang[1][mesh]["stats"][name]), name


def test_fsdp_resnet_state_is_sharded_as_jax(devices, gang):
    """The stem conv and every other conv keep half their output channels
    on each fsdp rank, as JAX's `state_shardings` puts conv_out on fsdp;
    the Dense keeps half its input features; norms stay whole."""
    trainer = _jax_trainer(devices[:2], MeshSpec(fsdp=2))
    shardings = dict(_flatten(trainer.state_shardings().params))
    whole = dict(_flatten(jax.eval_shape(trainer._init_boxed, jax.random.PRNGKey(0)).params))
    for path, sharding in shardings.items():
        shape = whole[path].value.shape if hasattr(whole[path], "value") else whole[path].shape
        spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
        local = [d // 2 if s == "fsdp" else d for d, s in zip(shape, spec)]
        if len(local) == 4:  # HWIO -> OIHW
            local = [local[3], local[2], local[0], local[1]]
        elif len(local) == 2:  # Dense (in, out) -> (out, in)
            local = local[::-1]
        name = convert.resnet_from_flax({path[0]: {path[-1]: np.zeros(shape)}}
                                        if len(path) == 2 else
                                        {path[0]: {path[1]: {path[2]: np.zeros(shape)}}})
        (port_name,) = name
        for rank in range(2):
            got = tuple(gang[rank]["fsdp2"]["shapes"][port_name].tolist())
            assert got == tuple(local), (rank, port_name, spec)
    stem = tuple(shardings[("conv_stem", "kernel")].spec)
    assert "fsdp" in stem, stem
