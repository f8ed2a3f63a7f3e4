"""The port's TransformerLM and its pieces against the JAX package's.

Both sides get the same numbers: inputs from numpy, and the port's
weights converted from the JAX model's init (`convert.from_flax`). The
JAX side runs attention_impl="flash" in Pallas interpret mode, as its
own CPU tests do. In f32 the models agree to 1e-5; in bf16 the port's
flash path must stay within twice JAX's own flash-vs-dense gap, which
the test measures (the two frameworks round bf16 at other places).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
            d_ff=128, flash_block_q=64, flash_block_k=64)


def _jax_cfg(dtype, impl="flash"):
    return jtf.TransformerConfig(**TINY, dtype=dtype, attention_impl=impl)


def _torch_cfg(dtype, impl="flash"):
    return ttf.TransformerConfig(**TINY, dtype=dtype, attention_impl=impl)


def _numpy_params(variables):
    return jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))


@pytest.fixture(scope="module")
def jax_params():
    model = jtf.TransformerLM(_jax_cfg(jnp.float32))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return variables


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s))


def _port_model(jax_variables, dtype, impl="flash"):
    model = ttf.TransformerLM(_torch_cfg(dtype, impl), device="cpu")
    model.load_state_dict(convert.from_flax(_numpy_params(jax_variables)))
    return model.eval()


def _jax_logits(variables, tokens, dtype, impl="flash"):
    return np.asarray(
        jtf.TransformerLM(_jax_cfg(dtype, impl)).apply(variables, jnp.asarray(tokens))
    )


def _port_logits(model, tokens):
    with torch.inference_mode():
        return model(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize("s", [128, 201])
def test_lm_f32_matches_jax_flash(jax_params, s):
    tokens = _tokens(s, 2, s)
    want = _jax_logits(jax_params, tokens, jnp.float32)
    got = _port_logits(_port_model(jax_params, torch.float32), tokens)
    assert got.shape == (2, s, TINY["vocab_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [128, 201])
def test_lm_bf16_within_jax_flash_vs_dense_gap(jax_params, s):
    tokens = _tokens(s + 1, 2, s)
    jax_flash = _jax_logits(jax_params, tokens, jnp.bfloat16)
    jax_dense = _jax_logits(jax_params, tokens, jnp.bfloat16, impl="dense")
    gap = np.abs(jax_flash - jax_dense).max()
    assert gap > 0
    got = _port_logits(_port_model(jax_params, torch.bfloat16), tokens)
    assert got.dtype == np.float32
    assert np.abs(got - jax_flash).max() <= 2 * gap


def test_lm_dense_impl_matches_jax_dense(jax_params):
    tokens = _tokens(3, 2, 40)
    want = _jax_logits(jax_params, tokens, jnp.float32, impl="dense")
    got = _port_logits(_port_model(jax_params, torch.float32, "dense"), tokens)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_from_flax_maps_every_param(jax_params):
    params = _numpy_params(jax_params)
    state = convert.from_flax(params)
    shapes = convert.param_shapes(_torch_cfg(torch.float32))
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes
    np.testing.assert_array_equal(
        state["layers.1.attn.wo"].numpy(), params["layer_1"]["attn"]["wo"]["kernel"]
    )
    np.testing.assert_array_equal(
        state["layers.0.mlp.wi_up"].numpy(), params["layer_0"]["mlp"]["wi_up"]["kernel"]
    )


def test_init_params_follow_flax_distributions(jax_params):
    """Same keys and shapes as the converted JAX init, and per tensor the
    same distribution: std within 10% of flax's draw (ones for norms)."""
    params = convert.from_flax(_numpy_params(jax_params))
    fresh = convert.init_params(_torch_cfg(torch.float32), seed=0, device="cpu")
    assert fresh.keys() == params.keys()
    for key, value in fresh.items():
        assert value.shape == params[key].shape, key
        if key.endswith(".scale"):
            assert torch.equal(value, params[key]), key
        else:
            want = params[key].std().item()
            assert abs(value.std().item() - want) <= 0.1 * want, key
            assert abs(value.mean().item()) <= 0.1 * want, key
    again = convert.init_params(_torch_cfg(torch.float32), seed=0, device="cpu")
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jtf.rms_norm(jnp.asarray(x), jnp.asarray(scale), dtype=jdt),
                          np.float32)
        got = ttf.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), dtype=tdt)
        assert got.dtype == tdt
        # bf16: one rounding step of the same f32 value.
        tol = 1e-6 if tdt == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=tol)


def test_rope_is_half_split_and_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 33, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33, dtype=np.int32), (2, 33))
    want = np.asarray(jtf.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = ttf.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # Position 0 rotates nothing; position 1 pairs element 0 with element d/2.
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0], atol=1e-7)
    ang = 1.0
    np.testing.assert_allclose(
        got[0, 1, 0, 0].item(),
        x[0, 1, 0, 0] * np.cos(ang) - x[0, 1, 0, 8] * np.sin(ang), rtol=1e-5,
    )


def test_swiglu_matches_jax():
    cfg = _jax_cfg(jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(np.float32)
    mod = jtf.SwiGLU(cfg)
    variables = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = ttf.SwiGLU(_torch_cfg(torch.float32))
    p = _numpy_params(variables)
    port.load_state_dict(
        {k: torch.from_numpy(np.array(p[k]["kernel"])) for k in ("wi_gate", "wi_up", "wo")}
    )
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_lm_head_is_f32_accumulation_of_bf16_operands():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    emb = rng.standard_normal((256, 64)).astype(np.float32)
    want = np.asarray(jtf.lm_head(jnp.asarray(x), jnp.asarray(emb), dtype=jnp.bfloat16))
    got = ttf.lm_head(torch.from_numpy(x), torch.from_numpy(emb), dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_config_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        ttf.TransformerConfig(num_experts=4)
    with pytest.raises(ValueError):
        ttf.TransformerConfig(attention_impl="ring")
    # The remat fields are accepted (and unused at inference).
    cfg = ttf.TransformerConfig(remat=False, remat_policy="flash")
    assert dataclasses.replace(cfg, d_model=64).remat_policy == "flash"


def _grads(model, tokens):
    labels = torch.from_numpy(np.roll(tokens, -1, axis=1))
    logits = model(torch.from_numpy(tokens))
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
    ).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_policies_give_equal_grads(jax_params):
    """"none", "full" and "mlp" recompute or save activations, never
    change the function: gradients agree to f32 summation order."""
    tokens = _tokens(9, 2, 64)
    want = None
    for remat, policy in ((False, "flash"), (True, "none"), (True, "full"),
                          (True, "mlp")):
        cfg = dataclasses.replace(_torch_cfg(torch.float32), remat=remat,
                                  remat_policy=policy)
        model = ttf.TransformerLM(cfg, device="cpu")
        model.load_state_dict(convert.from_flax(_numpy_params(jax_params)))
        grads = _grads(model, tokens)
        if want is None:
            want = grads
            continue
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=(policy, name))


@pytest.mark.parametrize("policy", ["dots", "attn", "flash"])
def test_unported_remat_policies_raise_when_differentiated(jax_params, policy):
    cfg = dataclasses.replace(_torch_cfg(torch.float32), remat_policy=policy)
    model = ttf.TransformerLM(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(1, 1, 16))
    with torch.inference_mode():  # serving is unaffected
        assert model(tokens).shape == (1, 16, TINY["vocab_size"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(tokens)
    with pytest.raises(ValueError):
        ttf.TransformerConfig(remat_policy="everything")


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("impl", ["auto", "flash", "dense"])
def test_use_flash_decides_by_head_dim_on_cuda(impl, head_dim):
    """`_attend`'s choice off the ring. On CUDA, "auto" takes the flash
    kernels only at the head dims they take (64, 128) and dense attention
    elsewhere; "flash" always takes flash (the kernels then refuse a head
    dim they lack); "dense" never. On the CPU the plain versions take
    every head dim, so "auto" stays on flash."""
    for dtype in (torch.bfloat16, torch.float32):
        on_cuda = ttf.use_flash(impl, cuda=True, head_dim=head_dim, dtype=dtype)
        on_cpu = ttf.use_flash(impl, cuda=False, head_dim=head_dim, dtype=dtype)
        if impl == "auto":
            assert on_cuda == (head_dim in (64, 128))
        else:
            assert on_cuda == (impl == "flash")
        assert on_cpu == (impl != "dense")
    assert not ttf.use_flash("auto", cuda=True, head_dim=128, dtype=torch.float16)


@pytest.mark.parametrize("impl,want", [("auto", "flash"), ("flash", "flash"),
                                       ("dense", "dense")])
def test_attend_runs_the_path_use_flash_picks(monkeypatch, impl, want):
    """`_attend` off the ring calls flash_attention or dense_attention as
    `use_flash` says (here on the CPU, at a head dim the kernels lack)."""
    calls = []
    monkeypatch.setattr(ttf, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    monkeypatch.setattr(ttf, "dense_attention",
                        lambda *a, **k: calls.append("dense") or a[0])
    q = torch.zeros(1, 8, 2, 32)
    cfg = ttf.TransformerConfig(**{**TINY, "head_dim": 32}, attention_impl=impl)
    ttf._attend(q, q, q, None, cfg)
    assert calls == [want]
