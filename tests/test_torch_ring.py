"""The port's sequence-parallel (sp ring) attention against the JAX
package's, and its in-process ring against a process-group ring.

The JAX side runs on the 8 virtual CPU devices that tests/conftest.py
sets up, inside `shard_map`; the port's ring runs in one process
(`build_mesh` without `torch.distributed`: every ring position on the
CPU), except in the gloo test, which starts two processes. JAX's
`ring_flash_attention(..., interpret=True)` runs its Pallas kernels in
interpret mode on every hop; JAX's `TransformerLM` on an sp mesh takes
the dense-hop `ring_attention` on the CPU (its `_attend` sends only the
TPU to ring flash), so the port's ring-flash LM is held against JAX's
dense-hop ring there. Inputs come from numpy and weights from JAX's init
through `from_flax`. Tolerances: 5e-5 (the reference's f32 flash gate,
tests/test_flash_schedule.py:250-253) for attention and its gradients,
1e-5 for logits and losses (as tests/test_torch_transformer.py).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.ops import flash as jflash
from kubeflow_tpu.ops.attention import ring_attention as jring_attention
from kubeflow_tpu.parallel import MeshSpec as JaxMeshSpec
from kubeflow_tpu.parallel import build_mesh as jax_build_mesh
from kubeflow_tpu.parallel import collectives as jcoll
from kubeflow_tpu.parallel import distributed as jdist
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.ops import flash as tflash
from kubeflow_tpu_torch.ops.attention import dense_attention, ring_attention
from kubeflow_tpu_torch.parallel import collectives as tcoll
from kubeflow_tpu_torch.parallel import distributed as tdist
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.train import TrainConfig, Trainer, softmax_cross_entropy

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=5e-5, rtol=5e-5)
LM_TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
            d_ff=128, flash_block_q=64, flash_block_k=64)


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _jax_ring_mesh(sp):
    # tests/test_flash_attention.py:131-136: dp=2 x sp on virtual devices.
    return JaxMesh(np.array(jax.devices()[: sp * 2]).reshape(2, sp), ("dp", "sp"))


def _port_mesh(sp, dp=2):
    return tmesh.build_mesh(tmesh.MeshSpec(dp=dp, sp=sp))


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


# -- ring flash and the dense ring against JAX -------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_flash_matches_jax_ring_flash(causal, sp):
    """Forward and the gradients of sum(o^2), at the JAX tests' own
    shapes (tests/test_flash_attention.py:139-181: b=2, s=8*sp, h=2,
    d=128); JAX's hops run its Pallas kernels in interpret mode."""
    arrays = _qkv(sp * 10 + causal, 2, 8 * sp, 2, 128)
    jmesh = _jax_ring_mesh(sp)

    def jloss(q, k, v):
        o = jflash.ring_flash_attention(q, k, v, jmesh, causal=causal,
                                        heads_axis=None, interpret=True)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, arrays)
    )
    mesh = _port_mesh(sp)
    got, grads = _torch_grads(
        lambda q, k, v: tflash.ring_flash_attention(q, k, v, mesh, causal=causal),
        arrays,
    )
    np.testing.assert_allclose(got, np.asarray(jo), **TOL)
    for g, w, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax_ring_attention(devices, causal, sp):
    """tests/test_attention.py:47-57's shapes and mesh (b=4, s=32, h=4,
    d=8; dp=2 x sp, tp filling the rest on the JAX side, which the port's
    mesh keeps at 1), forward and gradients."""
    arrays = _qkv(sp + 2 * causal, 4, 32, 4, 8)
    jmesh = jax_build_mesh(JaxMeshSpec(dp=2, sp=sp, tp=8 // (2 * sp) or 1), devices)

    def jloss(q, k, v):
        o = jring_attention(q, k, v, jmesh, causal=causal)
        return jnp.sum(o ** 2), o

    (_, jo), jgrads = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)
    )(*map(jnp.asarray, arrays))
    mesh = _port_mesh(sp)
    got, grads = _torch_grads(
        lambda q, k, v: ring_attention(q, k, v, mesh, causal=causal), arrays
    )
    np.testing.assert_allclose(got, np.asarray(jo), **TOL)
    for g, w, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **TOL)


def test_trivial_ring_falls_back():
    """sp = 1: ring flash is flash_attention, the dense ring is
    dense_attention (tests/test_flash_attention.py:184-193,
    tests/test_attention.py:60-64)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 16, 2, 128))
    mesh = _port_mesh(1)
    assert mesh.shape["sp"] == 1
    torch.testing.assert_close(
        tflash.ring_flash_attention(q, k, v, mesh), tflash.flash_attention(q, k, v),
        atol=0, rtol=0,
    )
    torch.testing.assert_close(
        ring_attention(q, k, v, mesh), dense_attention(q, k, v), atol=0, rtol=0
    )
    jo = jflash.ring_flash_attention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                                     _jax_ring_mesh(1), interpret=True)
    np.testing.assert_allclose(tflash.ring_flash_attention(q, k, v, mesh).numpy(),
                               np.asarray(jo), **TOL)


@pytest.mark.parametrize("s,match", [(18, "divi"), (24, "8-aligned")],
                         ids=["indivisible", "chunk-does-not-tile"])
def test_ring_refuses_what_jax_refuses(s, match):
    """An indivisible sequence (tests/test_flash_attention.py:196-203)
    and, for ring flash on the CPU, a chunk that does not tile without
    padding (kubeflow_tpu/ops/flash.py:1537-1544): both packages raise.
    (On the card the port's ring takes such a chunk: see
    test_torch_cuda_kernels.py.)"""
    sp = 4 if s == 18 else 2
    arrays = _qkv(3, 1, s, 2, 128)
    with pytest.raises(ValueError, match=match):
        jflash.ring_flash_attention(*map(jnp.asarray, arrays), _jax_ring_mesh(sp),
                                    interpret=True)
    q, k, v = map(torch.from_numpy, arrays)
    with pytest.raises(ValueError, match=match):
        tflash.ring_flash_attention(q, k, v, _port_mesh(sp))
    if s == 18:
        with pytest.raises(ValueError, match="divisible"):
            ring_attention(q, k, v, _port_mesh(sp))


def test_ring_refuses_a_batch_the_mesh_cannot_split():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 3, 16, 2, 64))
    with pytest.raises(ValueError, match="batch"):
        tflash.ring_flash_attention(q, k, v, _port_mesh(2, dp=2))


# -- collectives, mesh and env contract --------------------------------------


def test_ppermute_ring_direction_and_psum_match_jax():
    """Position i's slice goes to position i + 1, as JAX's ppermute_ring
    under shard_map moves it; psum gives every position the sum; the
    rotation's gradient rotates back."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    jmesh = JaxMesh(np.array(jax.devices()[:4]), ("sp",))
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    body = lambda a: (jcoll.ppermute_ring(a, "sp"), jcoll.psum(a, "sp"),
                      jcoll.axis_index("sp")[None].astype(jnp.float32))
    jrot, jsum, jidx = shard_map(body, mesh=jmesh, in_specs=P("sp"),
                                 out_specs=(P("sp"), P("sp"), P("sp")))(x)
    ring = tcoll.LocalRing(4)
    t = torch.from_numpy(x).requires_grad_()
    rot = tcoll.ppermute_ring(t, ring)
    np.testing.assert_array_equal(rot.detach().numpy(), np.asarray(jrot))
    np.testing.assert_array_equal(tcoll.psum(t, ring).detach().numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(tcoll.axis_index(ring).numpy(), np.asarray(jidx))
    assert tcoll.axis_size(ring) == 4
    (rot * torch.arange(12.0).reshape(4, 3)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.roll(np.arange(12.0).reshape(4, 3), -1, 0))


@pytest.mark.parametrize(
    "spec,n",
    [(dict(dp=-1), 8), (dict(dp=2, sp=-1), 8), (dict(sp=4), 4),
     (dict(dp=3, sp=2), 8), (dict(dp=-1, sp=-1), 4), (dict(dp=0), 1)],
)
def test_mesh_spec_resolves_as_jax(spec, n):
    def resolve(cls):
        try:
            got = cls(**spec).resolve(n)
        except ValueError as err:
            return type(err)
        return got.sizes(), got.data_parallelism
    assert resolve(tmesh.MeshSpec) == resolve(JaxMeshSpec)
    assert tmesh.AXES == ("pp", "dp", "fsdp", "sp", "ep", "tp")
    assert tmesh.BATCH_AXES == ("dp", "fsdp")


def test_build_mesh_in_one_process_and_its_refusals():
    mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=2, sp=4))
    assert not mesh.multiprocess and isinstance(mesh.ring(), tcoll.LocalRing)
    assert mesh.shape == {"pp": 1, "dp": 2, "fsdp": 1, "sp": 4, "ep": 1, "tp": 1}
    assert mesh.ring().ranks == (0, 1, 2, 3) and mesh.ring().sequence_offset(64) == 0
    assert tmesh.build_mesh(tmesh.MeshSpec(sp=-1), n_devices=4).shape["sp"] == 4
    assert tmesh.build_mesh().shape["dp"] == 1
    # fsdp, like dp, only sets the batch shards in one process.
    assert tmesh.build_mesh(tmesh.MeshSpec(fsdp=2, sp=2)).shape["fsdp"] == 2
    for axis in ("pp", "ep", "tp"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            tmesh.build_mesh(tmesh.MeshSpec(**{axis: 2}))


@pytest.mark.parametrize(
    "env",
    [{}, {"TPUJOB_COORDINATOR": "h:1", "TPUJOB_NUM_PROCESSES": "4",
          "TPUJOB_PROCESS_ID": "3", "TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": "1"},
     {"TPUJOB_NUM_PROCESSES": "2"}, {"TPUJOB_NUM_PROCESSES": "2", "TPUJOB_PROCESS_ID": "2",
                                     "TPUJOB_COORDINATOR": "h:1"},
     {"TPUJOB_NUM_PROCESSES": "3", "TPUJOB_NUM_SLICES": "2", "TPUJOB_COORDINATOR": "h:1"}],
    ids=["single", "gang", "no-coordinator", "rank-out-of-range", "uneven-slices"],
)
def test_process_env_contract_matches_jax(env):
    def parse(cls):
        try:
            pe = cls.from_env(env)
        except ValueError as err:
            return str(err)
        return (pe.coordinator, pe.num_processes, pe.process_id, pe.num_slices,
                pe.slice_id, pe.is_coordinator, pe.to_env())
    assert parse(tdist.ProcessEnv) == parse(jdist.ProcessEnv)


def test_single_process_gang_skips_init():
    pe = tdist.initialize_from_env({}, device="cpu")
    assert pe.num_processes == 1 and not torch.distributed.is_initialized()


# -- the LM's sp branch ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_variables():
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    return jtf.TransformerLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _port_lm(jax_variables, mesh=None, impl="flash", **cfg):
    model = ttf.TransformerLM(
        ttf.TransformerConfig(**TINY, dtype=torch.float32, attention_impl=impl, **cfg),
        mesh=mesh, device="cpu",
    )
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jax_variables["params"]))
    model.load_state_dict(convert.from_flax(params))
    return model


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s))


def _jax_loss(logits, tokens):
    labels = np.roll(tokens, -1, axis=1)
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    return float(-jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean())


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_sp_lm_matches_jax_sp_lm(devices, jax_variables, impl):
    """A 2-layer LM on a dp=2 x sp=2 mesh (template tests/test_transformer.py
    :86-103): the port's ring ("flash": ring flash; "dense": the dense
    ring) against JAX's sp model, whose attention is the dense-hop ring
    on the CPU. Logits and the next-token loss."""
    tokens = _tokens(11, 2, 64)
    jmesh = jax_build_mesh(JaxMeshSpec(dp=2, sp=2), devices[:4])
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl=impl)
    want = np.asarray(jtf.TransformerLM(jcfg, mesh=jmesh).apply(
        jax_variables, jnp.asarray(tokens)))
    model = _port_lm(jax_variables, _port_mesh(2), impl)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **LM_TOL)
    loss = softmax_cross_entropy(got, torch.from_numpy(np.roll(tokens, -1, axis=1)))
    np.testing.assert_allclose(loss.item(), _jax_loss(want, tokens), **LM_TOL)


def test_sp_lm_equals_flat_lm_logits_and_grads(jax_variables):
    """The same weights and tokens through the port's flat LM and its
    sp=4 ring LM: equal logits and parameter gradients (f32, summation
    order aside). Positions other than the global ones would move the
    logits of every chunk but the first."""
    tokens = torch.from_numpy(_tokens(12, 2, 128))
    labels = tokens.roll(-1, dims=1)
    flat = _port_lm(jax_variables)
    ring = _port_lm(jax_variables, _port_mesh(4))
    out = {}
    for name, model in (("flat", flat), ("ring", ring)):
        logits = model(tokens)
        softmax_cross_entropy(logits, labels).backward()
        out[name] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    torch.testing.assert_close(out["ring"][0], out["flat"][0], **LM_TOL)
    for n, g in out["ring"][1].items():
        torch.testing.assert_close(g, out["flat"][1][n], atol=1e-6, rtol=1e-5, msg=n)


def test_trainer_steps_the_in_process_ring_like_the_flat_lm(jax_variables):
    """The single-device Trainer takes the sp ring LM unchanged: its ring
    positions share the parameters, so two steps land where the flat
    LM's do. (sgd: adamw's normalisation would turn summation-order
    differences in gradients near zero into whole learning-rate steps.)"""
    tokens = torch.from_numpy(_tokens(13, 2, 64))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    config = TrainConfig(batch_size=2, learning_rate=0.5, warmup_steps=1,
                         total_steps=10, optimizer="sgd", label_smoothing=0.0)
    params, losses = {}, {}
    for name, mesh in (("flat", None), ("ring", _port_mesh(2))):
        trainer = Trainer(_port_lm(jax_variables, mesh, remat_policy="none"), config,
                          input_key="tokens", label_key="labels", device="cpu")
        state, step = trainer.init_state(), trainer.make_train_step()
        losses[name] = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses[name].append(float(metrics["loss"]))
        params[name] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    assert losses["ring"][2] < losses["ring"][1]
    np.testing.assert_allclose(losses["ring"], losses["flat"], **LM_TOL)
    for n, p in params["ring"].items():
        torch.testing.assert_close(p, params["flat"][n], atol=1e-5, rtol=1e-5, msg=n)


# -- a torch.distributed ring -----------------------------------------------

_WORKER = r"""
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
from kubeflow_tpu_torch.ops.attention import ring_attention
from kubeflow_tpu_torch.ops.flash import ring_flash_attention
from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env
from kubeflow_tpu_torch.train import TrainConfig, Trainer, softmax_cross_entropy

data, out = sys.argv[1], sys.argv[2]
lm_cfg = dict(json.loads(sys.argv[3]), dtype=torch.float32, remat=False)
pe = initialize_from_env(device="cpu")
try:
    mesh = build_mesh(MeshSpec(sp=-1))
    assert mesh.multiprocess and mesh.ring().ranks == (pe.process_id,)
    arrays = np.load(data)
    c = arrays["q"].shape[1] // pe.num_processes
    mine = slice(pe.process_id * c, (pe.process_id + 1) * c)
    q, k, v, w = (torch.from_numpy(arrays[n][:, mine].copy()) for n in "qkvw")
    result = {}
    for name, fn in (("flash", ring_flash_attention), ("dense", ring_attention)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, mesh, causal=True)
        (o * w).sum().backward()
        result[name] = o.detach()
        for t, g in zip("qkv", ts):
            result[f"{name}_d{t}"] = g.grad
    model = TransformerLM(TransformerConfig(**lm_cfg), mesh=mesh, device="cpu")
    c = arrays["tokens"].shape[1] // pe.num_processes
    mine = slice(pe.process_id * c, (pe.process_id + 1) * c)
    tokens, labels = (torch.from_numpy(arrays[n][:, mine].copy()) for n in ("tokens", "labels"))
    logits = model(tokens)
    softmax_cross_entropy(logits, labels).backward()
    result["logits"] = logits.detach()
    for n, p in model.named_parameters():
        result[f"grad.{n}"] = p.grad
    # A Trainer takes the process mesh (it reduces over the gang).
    trainer = Trainer(model, TrainConfig(batch_size=2), device="cpu")
    result["trainer_gang"] = torch.tensor(int(trainer.gang is mesh))
    torch.save(result, out)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_ring_equals_in_process_ring(tmp_path):
    """Two processes on a gloo sp group, started through the TPUJOB_* env
    contract (`initialize_from_env`), each holding its chunk: ring flash
    and the dense ring (output and q/k/v gradients) and the LM (logits of
    each chunk at its global positions, and parameter gradients summed
    over the ranks) equal the in-process ring's on the same inputs, and a
    Trainer takes the process mesh as its gang. The workers get 60 s, so
    a hang fails this test instead of the suite."""
    n, b, s, h, d = 2, 2, 32, 2, 64
    rng = np.random.default_rng(21)
    arrays = {c: rng.standard_normal((b, s, h, d)).astype(np.float32) for c in "qkvw"}
    tokens = rng.integers(0, TINY["vocab_size"], (b, 64))
    arrays.update(tokens=tokens, labels=np.roll(tokens, -1, axis=1))
    np.savez(tmp_path / "in.npz", **arrays)
    lm_cfg = dict(TINY, dtype=torch.float32, remat=False)
    env = dict(os.environ, TPUJOB_COORDINATOR=f"localhost:{_free_port()}",
               TPUJOB_NUM_PROCESSES=str(n), PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path / "in.npz"),
             str(tmp_path / f"out{r}.pt"), json.dumps(TINY)],
            cwd=REPO, env=dict(env, TPUJOB_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(n)
    ]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    parts = [torch.load(tmp_path / f"out{r}.pt", weights_only=True) for r in range(n)]
    cat = lambda key: torch.cat([p[key] for p in parts], dim=1)

    mesh = _port_mesh(n, dp=1)
    q, k, v, w = (torch.from_numpy(arrays[c]) for c in "qkvw")
    for name, fn in (("flash", tflash.ring_flash_attention), ("dense", ring_attention)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, mesh, causal=True)
        (o * w).sum().backward()
        torch.testing.assert_close(cat(name), o.detach(), **TOL)
        for t, g in zip("qkv", ts):
            torch.testing.assert_close(cat(f"{name}_d{t}"), g.grad, **TOL, msg=f"{name} d{t}")

    model = ttf.TransformerLM(ttf.TransformerConfig(**lm_cfg), mesh=mesh, device="cpu")
    logits = model(torch.from_numpy(tokens))
    # The ranks' losses are means over their chunks; their sum's gradient
    # is n times the in-process mean's.
    (n * softmax_cross_entropy(logits, torch.from_numpy(arrays["labels"]))).backward()
    torch.testing.assert_close(cat("logits"), logits.detach(), **LM_TOL)
    for name, p in model.named_parameters():
        summed = sum(part[f"grad.{name}"] for part in parts)
        torch.testing.assert_close(summed, p.grad, atol=1e-5, rtol=1e-5, msg=name)
    assert all(int(part["trainer_gang"]) == 1 for part in parts)


def test_port_parallel_modules_load_no_jax():
    code = (
        "import sys, kubeflow_tpu_torch.parallel.collectives, "
        "kubeflow_tpu_torch.parallel.mesh, kubeflow_tpu_torch.parallel.sharding, "
        "kubeflow_tpu_torch.parallel.distributed, kubeflow_tpu_torch.ops.flash, "
        "kubeflow_tpu_torch.models.resnet, kubeflow_tpu_torch.serving.batching, "
        "kubeflow_tpu_torch.serving.__main__\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kubeflow_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
