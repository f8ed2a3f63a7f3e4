"""The port's ResNet against the JAX package's, on the CPU.

The weights are numpy arrays drawn from a seed in flax's layout (the
shapes from ``jax.eval_shape`` of the JAX model's init): convs and the
Dense from their initializers' distributions, and every BatchNorm's
scale, bias and running statistics perturbed away from 1/0/0/1, so that
no block is the identity that a zero-initialised scale makes it and the
eval forward reads real statistics. JAX runs them as they are; the port
gets them through `convert.resnet_from_flax`.

Tolerances (atol = rtol, f32): 1e-4 for logits and running statistics,
except ResNet-50's training-mode forward at 64x64 and batch 2, held at
1e-3: its last stage normalises over 2x2x2 = 8 positions, which
amplifies float32 rounding, and on these weights JAX's own f32 forward
lies up to 6.6e-4 (logits) and 1.9e-4 + 1.9e-4·|x| (statistics) from a
float64 run of the same model. bf16: the port's logits lie within twice
JAX's own bf16-vs-f32 distance of JAX's bf16 logits.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import resnet as jr
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import resnet as tr

TOL = dict(atol=1e-4, rtol=1e-4)
# ResNet-50's training-mode forward at 64x64, batch 2 (module docstring).
R50_TRAIN_TOL = dict(atol=1e-3, rtol=1e-3)


def flax_weights(module, side: int, seed: int = 1):
    """(params, batch_stats) for a JAX ResNet, numpy float32, drawn from
    `seed` as the module docstring says."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3))))
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value)
                continue
            shape = value.shape
            if key == "kernel" and len(shape) == 4:  # HWIO, fan-out normal
                draw = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[-1] * shape[0] * shape[1]))
            elif key == "kernel":  # Dense (in, out), fan-in
                draw = rng.standard_normal(shape) / np.sqrt(shape[0])
            elif key == "scale":
                draw = 1 + 0.2 * rng.standard_normal(shape)
            elif key in ("bias", "mean"):
                draw = 0.1 * rng.standard_normal(shape)
            else:  # var
                draw = 1 + 0.5 * rng.random(shape)
            out[key] = draw.astype(np.float32)
        return out

    return fill(fnn.meta.unbox(shapes["params"])), fill(shapes["batch_stats"])


def port_model(factory, params, stats, dtype=torch.float32, **kw):
    model = factory(dtype=dtype, device="cpu", **kw)
    model.load_state_dict(convert.resnet_from_flax(params, stats))
    return model


def images(n, side, seed=0):
    return np.random.default_rng(seed).standard_normal((n, side, side, 3)).astype(np.float32)


CASES = {  # name → (JAX factory, port factory, side, batch, train-mode tol)
    "tiny_resnet": (jr.tiny_resnet, tr.tiny_resnet, 32, 4, TOL),
    "resnet50": (lambda dtype: jr.resnet50(dtype=dtype), tr.resnet50, 64, 2, R50_TRAIN_TOL),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jfactory, tfactory, side, n, train_tol = CASES[request.param]
    jmodel = jfactory(dtype=jnp.float32)
    params, stats = flax_weights(jmodel, side)
    x = images(n, side)
    variables = {"params": params, "batch_stats": stats}
    train = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    logits, new = train(variables, x)
    evals = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    return dict(
        name=request.param, tfactory=tfactory, params=params, stats=stats, x=x,
        train_logits=np.asarray(logits), eval_logits=np.asarray(evals),
        new_stats=jax.tree.map(np.asarray, new["batch_stats"]), train_tol=train_tol,
    )


def test_training_forward_and_running_stats_match_flax(case):
    model = port_model(case["tfactory"], case["params"], case["stats"])
    model.train()
    got = model(torch.from_numpy(case["x"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), case["train_logits"], **case["train_tol"])
    want = convert.resnet_from_flax({}, case["new_stats"])
    state = model.state_dict()
    assert len(want) == 2 * sum(isinstance(m, tr.BatchNorm) for m in model.modules())
    for key, value in want.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), err_msg=key,
                                   **case["train_tol"])


def test_eval_forward_matches_flax_and_leaves_stats(case):
    model = port_model(case["tfactory"], case["params"], case["stats"])
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"])).numpy()
    np.testing.assert_allclose(got, case["eval_logits"], **TOL)
    before = convert.resnet_from_flax({}, case["stats"])
    for key, value in before.items():
        assert torch.equal(model.state_dict()[key], value), key


def test_biased_variance_not_torch_batchnorm2d():
    """The running variance moves toward the biased batch variance (8/7
    off nn.BatchNorm2d's over 2x2x2 positions), by flax's momentum."""
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn = tr.BatchNorm(3)
    bn.train()
    y = bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    ref = torch.nn.BatchNorm2d(3, momentum=0.1, eps=1e-5)
    torch.testing.assert_close(y, ref(x))
    assert not torch.allclose(ref.running_var, bn.running_var)
    assert "num_batches_tracked" not in bn.state_dict()


def test_bf16_within_jax_bf16_vs_f32_distance():
    params, stats = flax_weights(jr.tiny_resnet(), 32)
    x = images(4, 32, seed=3)
    variables = {"params": params, "batch_stats": stats}
    jax32 = np.asarray(jr.tiny_resnet().apply(variables, x))
    jax16 = np.asarray(jr.tiny_resnet(dtype=jnp.bfloat16).apply(variables, x))
    gap = np.abs(jax16 - jax32).max()
    assert gap > 0
    model = port_model(tr.tiny_resnet, params, stats, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - jax16).max() <= 2 * gap


def test_resnet50_param_count_and_names():
    model = tr.resnet50(device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert 25_500_000 < n < 25_620_000, f"param count {n}"
    shapes = jax.eval_shape(
        lambda: jr.resnet50().init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         (fnn.meta.unbox(shapes["params"]), shapes["batch_stats"]))
    want = {k: tuple(v.shape) for k, v in convert.resnet_from_flax(*zeros).items()}
    assert want == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert model.block_names == tuple(f"BottleneckBlock_{i}" for i in range(16))


def test_init_follows_flax_initializers():
    model = tr.resnet50(device="cpu", seed=3).requires_grad_(False)
    stem = model.conv_stem.weight  # (64, 3, 7, 7): fan_out 64*49
    assert abs(float(stem.std()) - (2.0 / (64 * 49)) ** 0.5) < 0.02 * (2.0 / (64 * 49)) ** 0.5
    dense = model.Dense_0.weight  # (1000, 2048), truncated at 2 std
    std = (1.0 / 2048) ** 0.5 / 0.87962566103423978
    assert float(dense.abs().max()) <= 2 * std
    assert abs(float(dense.std()) - (1.0 / 2048) ** 0.5) < 0.01 * (1.0 / 2048) ** 0.5
    last = [getattr(model, name).BatchNorm_2.weight for name in model.block_names]
    assert all(float(w.abs().max()) == 0.0 for w in last)
    assert float(model.BatchNorm_0.weight.min()) == 1.0
    again = tr.resnet50(device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    model.reset_parameters(4)
    assert not torch.equal(model.conv_stem.weight, again.conv_stem.weight)


def test_nhwc_input_is_viewed_as_nchw():
    """On the CPU the stem sees contiguous NCHW (the CUDA path keeps the
    channels_last view: tests/test_torch_cuda_kernels.py)."""
    model = tr.tiny_resnet(device="cpu")
    seen = []
    model.conv_stem.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    x = torch.randn(4, 32, 32, 3)
    model(x).sum().backward()  # batch 4: where oneDNN's channels_last backward aborts
    assert seen[0].shape == (4, 3, 32, 32) and seen[0].is_contiguous()
    torch.testing.assert_close(seen[0], x.permute(0, 3, 1, 2))
