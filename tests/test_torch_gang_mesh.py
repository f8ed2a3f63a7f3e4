"""The port's mesh, sharding rules, collectives and process bootstrap
against the JAX package's, on the CPU.

- JAX's tests/test_distributed_env.py runs on the port's
  `parallel/distributed.py` (the source exec'd with the module path
  pointed at the port), and the backend rule is held without a GPU by
  injecting the layout: gloo on the CPU and wherever a host's ranks
  outnumber its cards, NCCL where each has its own; the local ranks
  from the coordinator's address; the group
  timeout from KFTPU_GROUP_TIMEOUT_S.
- JAX's tests/test_mesh.py and tests/test_trainer_resize.py:72-112
  cases: `MeshSpec.resolve`, `local_mesh_spec`, `resize_spec` (their
  values, or their error texts, equal JAX's), `mesh_spec_of`,
  `build_hybrid_mesh` in one process, and the refusals of pp, ep and tp.
- The sharding rules, `spec_for` and `batch_shard_count` equal JAX's.
- Every collective of tests/test_collectives.py on an in-process axis
  (`LocalRing`) against JAX's under `shard_map` on four virtual devices,
  forward and backward (the transposes), at f32 1e-6; then the same
  collectives over a two-process gloo group (`GroupRing`, 60 s) equal
  the in-process ones, forward and backward.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from kubeflow_tpu.parallel import collectives as jcol
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import sharding as jsharding
from kubeflow_tpu_torch.parallel import collectives as tcol
from kubeflow_tpu_torch.parallel import distributed as tdist
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.testing.gang import run_gang

REPO = Path(__file__).resolve().parents[1]
N = 4
TOL = dict(atol=1e-6, rtol=1e-6)


def _jax_tests_on_the_port(path: Path) -> dict:
    src = path.read_text().replace("kubeflow_tpu.parallel", "kubeflow_tpu_torch.parallel")
    namespace = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items() if k.startswith("test_") and callable(v)}


DIST_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_distributed_env.py")


@pytest.mark.parametrize("name", sorted(DIST_TESTS))
def test_jax_distributed_env_tests_on_the_port(name):
    DIST_TESTS[name]()


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 0, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 2, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 2, "nccl"),
    ("cuda", 2, 8, "nccl"),
])
def test_backend_rule(device, local, cards, want):
    assert tdist.choose_backend(device, local, cards) == want


def test_backend_rule_refuses_a_cuda_rank_without_a_card():
    with pytest.raises(RuntimeError, match="no card"):
        tdist.choose_backend("cuda", 1, 0)


@pytest.mark.parametrize("coordinator,want", [
    ("localhost:1234", 2), ("127.0.0.1:1234", 2), ("[::1]:1234", 2),
    ("127.0.0.2:1234", 2), ("10.0.0.5:1234", 1), ("[2001:db8::1]:1234", 1),
    ("job-worker-0.job.ns.svc:8476", 1),
])
def test_local_ranks_from_the_coordinator_or_the_env(coordinator, want):
    pe = tdist.ProcessEnv(coordinator=coordinator, num_processes=2, process_id=1)
    assert tdist.local_ranks(pe) == want


def test_group_timeout_is_tens_of_seconds_by_default():
    assert tdist.group_timeout({}).total_seconds() == 60.0
    assert tdist.group_timeout({"KFTPU_GROUP_TIMEOUT_S": "12.5"}).total_seconds() == 12.5
    assert tdist.started() == {} and tdist.control_group() is None


# -- the mesh -------------------------------------------------------------------


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("spec,n", [
    (dict(dp=-1, tp=2), 8), (dict(dp=2, fsdp=2, tp=2), 8), (dict(dp=3), 8),
    (dict(dp=-1, tp=3), 8), (dict(dp=-1, fsdp=-1), 8), (dict(fsdp=-1), 4),
    (dict(dp=2, fsdp=2, sp=2), 8), (dict(fsdp=0), 1),
])
def test_mesh_spec_resolves_as_jax(spec, n):
    def run(mod):
        got = _outcome(mod.MeshSpec(**spec).resolve, n)
        return got if isinstance(got, tuple) else (got.sizes(), got.data_parallelism)
    assert run(tmesh) == run(jmesh)


@pytest.mark.parametrize("n,tp,sp", [(8, 2, 1), (8, 3, 1), (8, 1, 2), (6, 2, 2), (4, 1, 1)])
def test_local_mesh_spec_as_jax(n, tp, sp):
    def run(mod):
        got = _outcome(mod.local_mesh_spec, n, tp=tp, sp=sp)
        return got if isinstance(got, tuple) else got.sizes()
    assert run(tmesh) == run(jmesh)
    assert tmesh.local_mesh_spec(tp=1).sizes() == (1, 1, 1, 1, 1, 1)  # one process


@pytest.mark.parametrize("spec,new_dp,kwargs", [
    (dict(dp=2, tp=2), 5, dict(n_devices=8)),
    (dict(dp=4), 3, dict(n_devices=8, global_batch=8)),
    (dict(dp=4, fsdp=2), 2, dict(global_batch=6)),
    (dict(dp=4, fsdp=2), 2, dict(global_batch=8)),
    (dict(dp=2), 0, {}),
    (dict(dp=2, fsdp=-1), 1, {}),
    (dict(dp=2, fsdp=2, sp=2), 1, dict(n_devices=4, global_batch=12)),
])
def test_resize_spec_as_jax(spec, new_dp, kwargs):
    def run(mod):
        got = _outcome(mod.resize_spec, mod.MeshSpec(**spec), new_dp, **kwargs)
        return got if isinstance(got, tuple) else got.sizes()
    assert run(tmesh) == run(jmesh)


def test_resize_spec_spells_out_the_arithmetic():
    """JAX's tests/test_trainer_resize.py:72-104, on the port."""
    with pytest.raises(ValueError) as e:
        tmesh.resize_spec(tmesh.MeshSpec(dp=2, tp=2), 5, n_devices=8)
    assert "dp=5 * tp=2 = 10 devices" in str(e.value) and "at most 4" in str(e.value)
    with pytest.raises(ValueError) as e:
        tmesh.resize_spec(tmesh.MeshSpec(dp=4), 3, n_devices=8, global_batch=8)
    assert "valid dp: [1, 2, 4, 8]" in str(e.value)
    with pytest.raises(ValueError, match=r"dp=2 \* fsdp=2"):
        tmesh.resize_spec(tmesh.MeshSpec(dp=4, fsdp=2), 2, global_batch=6)
    assert tmesh.resize_spec(tmesh.MeshSpec(dp=4, fsdp=2), 2, global_batch=8) == \
        tmesh.MeshSpec(dp=2, fsdp=2)


def test_in_process_meshes_and_refusals():
    spec = tmesh.MeshSpec(dp=2, fsdp=2, sp=2)
    mesh = tmesh.build_mesh(spec)
    assert not mesh.multiprocess and tmesh.mesh_spec_of(mesh) == spec
    assert mesh.axis("batch").size == 4 and mesh.axis("sp").size == 2
    assert mesh.index("batch") == 0 and mesh.group("dp") is None
    assert tsharding.batch_shard_count(mesh) == 4
    assert tsharding.batch_sharding(mesh, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="batch shards"):
        tsharding.batch_sharding(mesh, 6)
    for axis in ("pp", "ep", "tp"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            tmesh.build_mesh(tmesh.MeshSpec(**{axis: 2}))


def test_hybrid_mesh_in_one_process_as_jax(devices):
    got = tmesh.build_hybrid_mesh(tmesh.MeshSpec(fsdp=2), tmesh.MeshSpec(dp=2))
    want = jmesh.build_hybrid_mesh(jmesh.MeshSpec(fsdp=2), jmesh.MeshSpec(dp=2), devices[:4])
    assert got.shape == dict(want.shape)
    with pytest.raises(ValueError, match="explicit"):
        tmesh.build_hybrid_mesh(tmesh.MeshSpec(fsdp=4), tmesh.MeshSpec(dp=-1))
    with pytest.raises(ValueError, match="divisible"):
        tmesh.build_hybrid_mesh(tmesh.MeshSpec(fsdp=2), tmesh.MeshSpec(dp=3), n_devices=8)


# -- the rules -------------------------------------------------------------------


@pytest.mark.parametrize("fsdp_params", [True, False])
def test_rules_and_specs_as_jax(fsdp_params):
    rules = tsharding.default_rules(fsdp_params=fsdp_params)
    assert rules == jsharding.default_rules(fsdp_params=fsdp_params)
    for names in [("embed", "heads", "kv"), ("heads", "kv", "embed"), ("mlp", "embed"),
                  ("vocab", "embed"), ("norm",), ("batch", "seq", None), (None, None),
                  ("conv_out", "conv_in", None, None), ("expert", "embed", "mlp")]:
        assert tuple(tsharding.spec_for(names, rules)) == \
            tuple(jsharding.spec_for(names, rules)), names
    with pytest.raises(KeyError):
        tsharding.spec_for(("nope",), rules)


# -- the collectives ------------------------------------------------------------


def _cases():
    """(name, JAX body, port function, per-device input shape)."""
    return [
        ("psum", lambda x: jcol.psum(x, "x"), lambda x, r: tcol.psum(x, r), (3, 4)),
        ("pmean", lambda x: jcol.pmean(x, "x"), lambda x, r: tcol.pmean(x, r), (3, 4)),
        ("all_gather0", lambda x: jcol.all_gather(x, "x"),
         lambda x, r: tcol.all_gather(x, r), (3, 4)),
        ("all_gather1", lambda x: jcol.all_gather(x, "x", gather_axis=1),
         lambda x, r: tcol.all_gather(x, r, gather_axis=1), (3, 4)),
        ("all_gather_stacked", lambda x: jcol.all_gather(x, "x", tiled=False, gather_axis=1),
         lambda x, r: tcol.all_gather(x, r, tiled=False, gather_axis=1), (3, 4)),
        ("reduce_scatter0", lambda x: jcol.reduce_scatter(x, "x"),
         lambda x, r: tcol.reduce_scatter(x, r), (8, 4)),
        ("reduce_scatter1", lambda x: jcol.reduce_scatter(x, "x", scatter_axis=1),
         lambda x, r: tcol.reduce_scatter(x, r, scatter_axis=1), (3, 8)),
        ("all_to_all_1_0", lambda x: jcol.all_to_all(x, "x", split_axis=1, concat_axis=0),
         lambda x, r: tcol.all_to_all(x, r, split_axis=1, concat_axis=0), (2, 8)),
        ("all_to_all_0_1", lambda x: jcol.all_to_all(x, "x", split_axis=0, concat_axis=1),
         lambda x, r: tcol.all_to_all(x, r, split_axis=0, concat_axis=1), (8, 2)),
        ("ppermute", lambda x: jcol.ppermute_ring(x, "x", shift=1),
         lambda x, r: tcol.ppermute_ring(x, r, shift=1), (3, 4)),
    ]


CASES = {case[0]: case for case in _cases()}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, *shape)).astype(np.float32)


def _local(name):
    """The port's output and input gradient on an in-process axis, for a
    loss weighted by a fixed random tensor."""
    _, _, port, shape = CASES[name]
    x = torch.from_numpy(_inputs(shape)).requires_grad_()
    out = port(x, tcol.LocalRing(N))
    w = torch.from_numpy(_inputs(tuple(out.shape[1:]), seed=1))
    (out * w).sum().backward()
    return out.detach(), x.grad, w


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_and_its_transpose_match_jax(devices, name):
    _, body, _, shape = CASES[name]
    out, grad, w = _local(name)
    mesh = JaxMesh(np.asarray(devices[:N]), ("x",))
    fn = shard_map(lambda x: body(x[0])[None], mesh=mesh, in_specs=P("x"),
                   out_specs=P("x"), check_rep=False)
    x = jnp.asarray(_inputs(shape))
    want = jax.jit(fn)(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    jgrad = jax.jit(jax.grad(lambda x: (fn(x) * jnp.asarray(w.numpy())).sum()))(x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **TOL)


_GROUP_WORKER = r"""
import sys
import torch
from kubeflow_tpu_torch.parallel import GroupRing, distributed, initialize_from_env
sys.path.insert(0, sys.argv[2])
from test_torch_gang_mesh import CASES, _inputs

pe = initialize_from_env(device="cpu")
ring = GroupRing()
result = {}
for name, (_, _, port, shape) in CASES.items():
    mine = slice(pe.process_id, pe.process_id + 1)
    x = torch.from_numpy(_inputs(shape)[mine]).requires_grad_()
    out = port(x, ring)
    w = torch.from_numpy(_inputs(tuple(out.shape[1:]), seed=1)[mine])
    (out * w).sum().backward()
    result[name] = {"out": out.detach(), "grad": x.grad}
torch.save(result, f"{sys.argv[1]}.{pe.process_id}")
distributed.shutdown()
"""


def test_process_group_collectives_equal_the_in_process_ones(tmp_path):
    runs = run_gang([sys.executable, "-c", _GROUP_WORKER, str(tmp_path / "out"),
                     str(Path(__file__).parent)], N, timeout=60,
                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert all(rc == 0 for rc, _ in runs), "\n".join(text for _, text in runs)
    parts = [torch.load(tmp_path / f"out.{r}", weights_only=True) for r in range(N)]
    for name in CASES:
        out, grad, _ = _local(name)
        torch.testing.assert_close(torch.cat([p[name]["out"] for p in parts]), out,
                                   atol=1e-6, rtol=1e-6, msg=name)
        torch.testing.assert_close(torch.cat([p[name]["grad"] for p in parts]), grad,
                                   atol=1e-6, rtol=1e-6, msg=name)
