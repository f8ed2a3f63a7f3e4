"""The port's switch MoE against the JAX package's.

Both sides get the same numbers: inputs from numpy, and the port's
weights converted from the JAX model's init (`convert.from_flax`). The
JAX side runs attention_impl="flash" in Pallas interpret mode, as its
own CPU tests do. Tolerance: f32 atol = rtol = 5e-5, the reference's own
flash gate, for sums taken in another order.

Routing compares an argmax of router probabilities, and a near tie
there would turn an ulp of difference into another expert. The tests
do not pick seeds around that: each asserts (and prints) that the
smallest gap between a token's first and second probability is far
above float32 rounding (`MIN_MARGIN`).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.parallel import MeshSpec, build_mesh
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh as tbuild_mesh
from kubeflow_tpu_torch.serving import Servable
from kubeflow_tpu_torch.train import trainer as ttrainer

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
            d_ff=32, num_experts=4, flash_block_q=64, flash_block_k=64,
            remat_policy="none")
TOL = dict(atol=5e-5, rtol=5e-5)
# Float32 probabilities of O(0.3) round at ~3e-8.
MIN_MARGIN = 1e-6


def _cfgs(**changes):
    jcfg = jtf.TransformerConfig(**{**TINY, **changes}, dtype=jnp.float32,
                                 attention_impl="flash")
    tcfg = ttf.TransformerConfig(**{**TINY, **changes}, dtype=torch.float32,
                                 attention_impl="flash")
    return jcfg, tcfg


def _unbox(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _margin(probs) -> float:
    top2 = np.sort(np.asarray(probs).reshape(-1, np.shape(probs)[-1]), -1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _assert_margin(probs, what):
    margin = _margin(probs)
    print(f"{what}: smallest top-1/top-2 router margin {margin:.3g}")
    assert margin > MIN_MARGIN, (what, margin)


@pytest.fixture(scope="module")
def lm_params():
    jcfg, _ = _cfgs()
    variables = jtf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))
    return _unbox(variables["params"])


def _port_lm(params, **changes):
    _, tcfg = _cfgs(**changes)
    model = ttf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.from_flax(params))
    return model


def _tokens(seed, b, s):
    toks = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


# -- the module -------------------------------------------------------------------


def test_group_size_matches_jax():
    for n in (1, 7, 128, 4096, 4097, 4608, 6000, 8192, 12288, 16384):
        assert ttf.group_size(n) == jtf.SwitchMoE._group_size(n), n


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("b,s,groups", [(2, 64, 1), (2, 2304, 2)])
def test_switch_moe_matches_jax(capacity_factor, b, s, groups):
    """Output, load-balancing loss, routing and dropped tokens, with one
    group and with two (4608 tokens: groups of 2304)."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    x = np.random.default_rng(s).standard_normal((b, s, TINY["d_model"]))
    x = x.astype(np.float32)
    module = jtf.SwitchMoE(jcfg)
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, sown = module.apply({"params": variables["params"]}, jnp.asarray(x),
                              mutable=["losses"])
    want = np.asarray(want)
    (want_aux,) = jax.tree.leaves(sown["losses"])
    params = _unbox(variables["params"])

    port = ttf.SwitchMoE(tcfg)
    port.load_state_dict({
        "router": torch.tensor(params["router"]["kernel"]),
        "w_in": torch.tensor(params["w_in"]),
        "w_out": torch.tensor(params["w_out"]),
    })
    with torch.no_grad():
        got, aux = port(torch.from_numpy(x))
        routing = port.route(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)

    # JAX's router: a float32 Dense and a softmax over the experts.
    g = s * b // groups
    jprobs = np.asarray(jax.nn.softmax(
        jnp.asarray(x).reshape(groups, g, -1) @ params["router"]["kernel"], -1))
    _assert_margin(jprobs, f"SwitchMoE {b}x{s}")
    assert routing.probs.shape == (groups, g, TINY["num_experts"])
    np.testing.assert_allclose(routing.probs.numpy(), jprobs, **TOL)
    np.testing.assert_array_equal(routing.expert.numpy(), jprobs.argmax(-1))
    assert routing.capacity == max(1, int(capacity_factor * g / TINY["num_experts"]))
    # A token JAX drops comes out as 0; every other one does not.
    dropped = (want == 0).all(-1).reshape(groups, g)
    np.testing.assert_array_equal(~routing.keep.numpy(), dropped)
    if capacity_factor < 1:
        assert dropped.sum() >= b * s * (1 - capacity_factor)
    assert (got.numpy()[dropped.reshape(b, s)] == 0).all()


# -- the LM -----------------------------------------------------------------------


def _router_inputs(model, tokens):
    """Each MoE layer's routing on the input it got in a forward."""
    routings, hooks = [], []
    for layer in model.layers:
        hooks.append(layer.moe.register_forward_pre_hook(
            lambda mod, args: routings.append(mod.route(args[0]))))
    try:
        with torch.no_grad():
            model(torch.from_numpy(tokens))
    finally:
        for hook in hooks:
            hook.remove()
    return routings


def test_moe_lm_matches_jax(lm_params):
    """Logits, and the per-layer losses JAX sows into "losses"; a plain
    forward returns logits alone, as an eval or a server calls it."""
    tokens, _ = _tokens(0, 2, 128)
    jcfg, _ = _cfgs()
    want, sown = jtf.TransformerLM(jcfg).apply(
        {"params": lm_params}, jnp.asarray(tokens), mutable=["losses"])
    model = _port_lm(lm_params)
    for i, routing in enumerate(_router_inputs(model, tokens)):
        _assert_margin(routing.probs.numpy(), f"layer {i}")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
        again, losses = model(torch.from_numpy(tokens), with_losses=True)
    assert isinstance(logits, torch.Tensor) and model.sows_losses
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert torch.equal(again, logits)
    want_losses = [float(a) for a in jax.tree.leaves(sown["losses"])]
    assert len(losses) == len(want_losses) == TINY["n_layers"]
    np.testing.assert_allclose([a.item() for a in losses], want_losses, **TOL)


def test_moe_lm_on_an_in_process_ring_routes_the_whole_batch(lm_params):
    """On an in-process sp ring the model holds the whole sequence, so it
    routes as the flat model does: the same logits and losses."""
    tokens, _ = _tokens(5, 2, 128)
    flat = _port_lm(lm_params)
    _, tcfg = _cfgs()
    ring = ttf.TransformerLM(tcfg, mesh=tbuild_mesh(TMeshSpec(sp=2)), device="cpu")
    ring.load_state_dict(flat.state_dict())
    with torch.no_grad():
        want, want_losses = flat(torch.from_numpy(tokens), with_losses=True)
        got, losses = ring(torch.from_numpy(tokens), with_losses=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose([a.item() for a in losses],
                               [a.item() for a in want_losses], **TOL)


def _jax_loss_grads(params, tokens, labels, **changes):
    jcfg, _ = _cfgs(**changes)
    model = jtf.TransformerLM(jcfg)

    def loss_fn(p):
        logits, sown = model.apply({"params": p}, jnp.asarray(tokens),
                                   mutable=["losses"])
        loss = jtrainer.softmax_cross_entropy(logits, jnp.asarray(labels))
        for aux in jax.tree.leaves(sown["losses"]):
            loss = loss + aux
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), convert.from_flax(_unbox(grads))


def _port_loss_grads(model, tokens, labels):
    logits, losses = model(torch.from_numpy(tokens), with_losses=True)
    loss = ttrainer.softmax_cross_entropy(logits, torch.from_numpy(labels))
    for aux in losses:
        loss = loss + aux
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.mark.parametrize("policy", ["none", "full", "mlp", "flash"])
def test_moe_loss_and_grads_match_jax(lm_params, policy):
    """CE plus the load-balancing losses and every gradient, router's
    included, under each remat policy against JAX's under the same one:
    a loss counted twice when a region recomputes would show in both."""
    tokens, labels = _tokens(1, 2, 128)
    want_loss, want = _jax_loss_grads(lm_params, tokens, labels,
                                      remat_policy=policy)
    loss, grads = _port_loss_grads(_port_lm(lm_params, remat_policy=policy),
                                   tokens, labels)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)
    assert np.abs(grads["layers.0.moe.router"].numpy()).max() > 0


# -- the trainer ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps(lm_params):
    """One adamw step of JAX's Trainer on the MoE LM at accum_steps 1 and
    2, from the converted params: the loss and the updated params."""
    jcfg, _ = _cfgs()
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    out = {}
    for accum in (1, 2):
        tcfg = jtrainer.TrainConfig(
            batch_size=4, learning_rate=1e-2, warmup_steps=1, total_steps=10,
            optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
            train_metrics="loss", accum_steps=accum,
        )
        trainer = jtrainer.Trainer(
            jtf.TransformerLM(jcfg, mesh=mesh), tcfg, mesh,
            example_input_shape=(2, 128), example_input_dtype=jnp.int32,
            input_key="tokens", label_key="labels",
        )
        state = trainer.init_state(jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree.map(
            lambda p, v: jnp.asarray(v, p.dtype), state.params,
            _boxed_like(state.params, lm_params)))
        tokens, labels = _tokens(2, 4, 128)
        # Step 0's rate is 0 (warmup), so take two steps on the batch.
        step = trainer.make_train_step()
        batch = {"tokens": jnp.asarray(tokens, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32)}
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out[accum] = (losses, _unbox(state.params), tcfg)
    return out


def _boxed_like(boxed, values):
    """`values` (a plain tree) in the structure of flax's boxed params."""
    leaves = jax.tree.leaves(values)
    return jax.tree.unflatten(jax.tree.structure(fnn.meta.unbox(boxed)), leaves)


def _port_steps(lm_params, tcfg, n=2, **changes):
    model_changes = {k: v for k, v in changes.items() if k == "remat_policy"}
    model = _port_lm(lm_params, **model_changes)
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    fields.update({k: v for k, v in changes.items() if k != "remat_policy"})
    trainer = ttrainer.Trainer(model, ttrainer.TrainConfig(**fields),
                               input_key="tokens", label_key="labels", device="cpu")
    tokens, labels = _tokens(2, 4, 128)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    state, step, losses = trainer.init_state(), trainer.make_train_step(), []
    for _ in range(n):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    return losses, {k: p.detach() for k, p in state.model.named_parameters()}


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_steps_match_jax_trainer(lm_params, jax_steps, accum):
    """The loss with the load-balancing terms (once per microbatch) and
    the params after two adamw steps; params held at 2·lr·steps, as
    test_torch_trainer.py holds the flat LM's."""
    want_losses, want_params, tcfg = jax_steps[accum]
    losses, params = _port_steps(lm_params, tcfg)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    final = convert.from_flax(want_params)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=2 * tcfg.learning_rate * 2, rtol=0, err_msg=name)
    diffs = np.concatenate([np.abs(p.numpy() - final[n].numpy()).ravel()
                            for n, p in params.items()])
    assert np.median(diffs) < 1e-6


@pytest.mark.parametrize("changes", [
    dict(remat_policy="full"), dict(remat_policy="mlp"), dict(remat_policy="flash"),
    dict(step_remat="full"), dict(step_remat="flash"),
], ids=["full", "mlp", "flash", "step_full", "step_flash"])
def test_moe_loss_counted_once_under_remat(lm_params, jax_steps, changes):
    """A recomputed region reruns the MoE, and the trainer's loss and
    update stay those of the step without remat."""
    tcfg = jax_steps[1][2]
    want_losses, want = _port_steps(lm_params, tcfg)
    losses, params = _port_steps(lm_params, tcfg, **changes)
    np.testing.assert_allclose(losses, want_losses, atol=1e-6, rtol=1e-6)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_moe_eval_collects_no_losses(lm_params, jax_steps):
    """The eval step's loss is the cross entropy alone, as JAX's."""
    tcfg = jax_steps[1][2]
    jcfg, _ = _cfgs()
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(
        jtf.TransformerLM(jcfg, mesh=mesh), tcfg, mesh,
        example_input_shape=(2, 128), example_input_dtype=jnp.int32,
        input_key="tokens", label_key="labels",
    )
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(
        lambda p, v: jnp.asarray(v, p.dtype), jstate.params,
        _boxed_like(jstate.params, lm_params)))
    tokens, labels = _tokens(3, 4, 128)
    want = jtr.make_eval_step()(jstate, {"tokens": jnp.asarray(tokens, jnp.int32),
                                         "labels": jnp.asarray(labels, jnp.int32)})
    model = _port_lm(lm_params)
    trainer = ttrainer.Trainer(model, ttrainer.TrainConfig(**{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}),
        input_key="tokens", label_key="labels", device="cpu")
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    got = trainer.make_eval_step()(trainer.init_state(), batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **TOL)
    with torch.no_grad():
        ce = ttrainer.softmax_cross_entropy(model(batch["tokens"]), batch["labels"])
    assert got["loss"].item() == ce.item()


# -- weights and serving ------------------------------------------------------------


def test_from_flax_and_init_params_cover_the_experts(lm_params):
    state = convert.from_flax(lm_params)
    _, tcfg = _cfgs()
    shapes = convert.param_shapes(tcfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes
    assert "layers.1.moe.w_out" in shapes and not any(".mlp." in k for k in shapes)
    np.testing.assert_array_equal(state["layers.1.moe.router"].numpy(),
                                  lm_params["layer_1"]["moe"]["router"]["kernel"])
    # flax's variance scaling draws normal(0, 1/fan_in): the router's fan-in
    # is d_model, an expert weight's E · its input width. Both sides' draws
    # are held to that std within 4 standard errors of a sample std.
    fresh = convert.init_params(tcfg, seed=0, device="cpu")
    e, dm, ff = TINY["num_experts"], TINY["d_model"], TINY["d_ff"]
    for key, fan_in in (("layers.0.moe.router", dm), ("layers.0.moe.w_in", e * dm),
                        ("layers.0.moe.w_out", e * ff)):
        want = fan_in ** -0.5
        slack = 4 / np.sqrt(2 * state[key].numel())
        for drawn in (state[key], fresh[key]):
            assert abs(drawn.std().item() / want - 1) <= slack, key


def test_moe_lm_serves_its_padded_batch(lm_params):
    """A served answer is the module's forward on the batch the server
    ran: three instances padded to the bucket of 4, routed together."""
    model = _port_lm(lm_params)
    servable = Servable.from_module("moe", model, max_batch=4, device="cpu")
    tokens, _ = _tokens(4, 3, 128)
    got = servable.predict(list(tokens))
    padded = np.concatenate([tokens, np.zeros((1, 128), tokens.dtype)])
    with torch.no_grad():
        want = model(torch.from_numpy(padded))[:3].numpy()
    np.testing.assert_array_equal(got, want)
