"""The port's multi-model registry, by the JAX package's own tests.

Every test of tests/test_serving_registry.py and the two per-model
isolation tests of tests/test_serving_batching.py, run against
`kubeflow_tpu_torch.serving.ServableRegistry` on the same stand-in
servables: lazy, measured page-in; LRU eviction at the residency limit;
a paged-out model paging back in; eager reload of a resident model on a
roll and a spec-only update of a paged-out one; a roll that waits out an
in-flight page-in; whole-registry kill; a factory failure that surfaces
without poisoning the entry; one slow model that does not delay another's
flush; kill(model) during its page-in.

Then the port's own contracts and parity:
- one request sequence through both packages' registries (a recording
  factory) gives the same builds, page-outs and stats, step by step;
- a page-out, a kill, a removal and a failed page-in leave no reference
  to the servable (weak references die with the garbage collector off),
  which is what gives a model's weights back to the device;
- a `tiny_resnet` catalog written by the port's `Checkpointer`, paged
  through ``max_resident=1`` by `build_servable_from_rspec`, answers as
  direct forwards of the same checkpoints do (f32, exact: the same
  module on the same batch of one).
"""

import threading
import time

import numpy as np
import pytest

from kubeflow_tpu_torch.serving import (
    BatchingConfig,
    ModelNotFound,
    PagingConfig,
    ServableRegistry,
)
from kubeflow_tpu_torch.serving.batching import QueueClosed


class Recorder:
    """Factory + servable in one: records every build so tests can
    assert exactly when page-ins happened."""

    def __init__(self):
        self.builds: list[str] = []
        self._lock = threading.Lock()

    def __call__(self, rspec: dict):
        name = rspec["model"]
        with self._lock:
            self.builds.append(name)
        outer = self

        class _Servable:
            def __init__(self):
                self.name = name
                self.version = int(rspec.get("modelVersion", 0) or 1)

            def predict(self, instances):
                return np.asarray(instances) * 2.0

        del outer
        return _Servable()


def make_registry(max_resident=0, factory=None):
    return ServableRegistry(
        factory or Recorder(),
        batching=BatchingConfig(max_batch=4, timeout_ms=2.0),
        paging=PagingConfig(max_resident=max_resident),
    )


X = np.ones((1, 3))


def test_page_in_is_lazy_and_measured():
    factory = Recorder()
    registry = make_registry(factory=factory)
    try:
        registry.ensure({"model": "a"})
        assert factory.builds == []  # registration loads nothing
        row = registry.stats()["models"]["a"]
        assert row["state"] == "registered" and row["page_ins"] == 0

        np.testing.assert_array_equal(registry.predict("a", X), X * 2.0)
        assert factory.builds == ["a"]
        row = registry.stats()["models"]["a"]
        assert row["state"] == "resident"
        assert row["page_ins"] == 1
        assert row["last_page_in_s"] >= 0.0
        assert registry.page_ins_total.value(model="a") == 1

        registry.predict("a", X)  # resident: no rebuild
        assert factory.builds == ["a"]
    finally:
        registry.close()


def test_unknown_model_is_model_not_found():
    registry = make_registry()
    try:
        with pytest.raises(ModelNotFound):
            registry.predict("ghost", X)
    finally:
        registry.close()


def test_lru_evicts_least_recently_used():
    factory = Recorder()
    registry = make_registry(max_resident=2, factory=factory)
    try:
        for name in ("a", "b", "c"):
            registry.ensure({"model": name})
        registry.predict("a", X)
        time.sleep(0.01)  # monotonic last_used ordering
        registry.predict("b", X)
        time.sleep(0.01)
        registry.predict("c", X)  # residency limit: "a" pages out

        stats = registry.stats()
        assert stats["resident"] == 2
        assert stats["models"]["a"]["state"] == "registered"
        assert stats["models"]["b"]["state"] == "resident"
        assert stats["models"]["c"]["state"] == "resident"
        assert registry.page_outs_total.value(model="a") == 1

        # The paged-out model serves again — one more (measured) build.
        np.testing.assert_array_equal(registry.predict("a", X), X * 2.0)
        assert factory.builds == ["a", "b", "c", "a"]
        assert registry.stats()["models"]["a"]["page_ins"] == 2
        # ...and its page-in evicted the new LRU, "b".
        assert registry.stats()["models"]["b"]["state"] == "registered"
    finally:
        registry.close()


def test_predict_touch_refreshes_lru_rank():
    registry = make_registry(max_resident=2)
    try:
        for name in ("a", "b", "c"):
            registry.ensure({"model": name})
        registry.predict("a", X)
        time.sleep(0.01)
        registry.predict("b", X)
        time.sleep(0.01)
        registry.predict("a", X)  # touch: "b" is now the LRU
        time.sleep(0.01)
        registry.predict("c", X)
        stats = registry.stats()["models"]
        assert stats["a"]["state"] == "resident"
        assert stats["b"]["state"] == "registered"
    finally:
        registry.close()


def test_roll_resident_reloads_eagerly():
    factory = Recorder()
    registry = make_registry(factory=factory)
    try:
        registry.ensure({"model": "a", "modelVersion": 1})
        registry.predict("a", X)
        registry.roll("a", {"model": "a", "modelVersion": 7})
        # Still resident, new generation, no request needed.
        row = registry.stats()["models"]["a"]
        assert row["state"] == "resident" and row["version"] == 7
        assert factory.builds == ["a", "a"]
    finally:
        registry.close()


def test_roll_paged_out_updates_spec_only():
    factory = Recorder()
    registry = make_registry(factory=factory)
    try:
        registry.ensure({"model": "a", "modelVersion": 1})
        registry.roll("a", {"model": "a", "modelVersion": 7})
        assert factory.builds == []  # not resident: nothing loads
        registry.predict("a", X)
        assert registry.stats()["models"]["a"]["version"] == 7
    finally:
        registry.close()


def test_roll_waits_out_inflight_page_in():
    """Failure matrix: page-in-racing-roll. The roll must wait the
    in-flight load out, then swap — the caller parked on the first
    page-in completes against the generation it claimed, and the
    post-roll version is the rolled spec's."""
    release = threading.Event()
    in_factory = threading.Event()
    recorder = Recorder()

    def factory(rspec):
        if not in_factory.is_set():
            in_factory.set()
            release.wait(10)
        return recorder(rspec)

    registry = make_registry(factory=factory)
    try:
        registry.ensure({"model": "a", "modelVersion": 1})
        results = []

        def first_caller():
            results.append(registry.predict("a", X))

        t = threading.Thread(target=first_caller)
        t.start()
        assert in_factory.wait(5)  # page-in v1 is in flight

        rolled = threading.Thread(
            target=lambda: registry.roll(
                "a", {"model": "a", "modelVersion": 2}
            )
        )
        rolled.start()
        time.sleep(0.05)
        assert rolled.is_alive()  # parked behind the load, not yanking it

        release.set()
        t.join(timeout=10)
        rolled.join(timeout=10)
        assert not t.is_alive() and not rolled.is_alive()
        assert len(results) == 1  # the racing caller was answered
        assert registry.stats()["models"]["a"]["version"] == 2
    finally:
        release.set()
        registry.close()


def test_kill_registry_is_terminal():
    registry = make_registry()
    try:
        registry.ensure({"model": "a"})
        registry.predict("a", X)
        registry.kill()
        with pytest.raises(QueueClosed):
            registry.predict("a", X)
        assert registry.stats()["closed"]
    finally:
        registry.close()


def test_factory_failure_surfaces_and_does_not_poison():
    """A failed page-in reports its error to the waiting callers but
    leaves the catalog entry retryable — the next request tries again."""
    boom = [True]
    recorder = Recorder()

    def factory(rspec):
        if boom[0]:
            raise RuntimeError("checkpoint store down")
        return recorder(rspec)

    registry = make_registry(factory=factory)
    try:
        registry.ensure({"model": "a"})
        with pytest.raises(RuntimeError, match="checkpoint store down"):
            registry.predict("a", X)
        assert registry.stats()["models"]["a"]["state"] == "registered"
        boom[0] = False
        np.testing.assert_array_equal(registry.predict("a", X), X * 2.0)
    finally:
        registry.close()


# -- per-model isolation (tests/test_serving_batching.py) --------------------


class CountingServable:
    """Identity 'model' that records every underlying execution."""

    name = "ident"
    version = 1

    def __init__(self, fail_batches=()):
        self.calls: list[int] = []
        self.fail_batches = set(fail_batches)
        self._lock = threading.Lock()

    def predict(self, instances):
        batch = np.asarray(instances)
        with self._lock:
            self.calls.append(batch.shape[0])
            if len(self.calls) - 1 in self.fail_batches:
                raise RuntimeError("injected device fault")
        return batch * 2.0


def test_slow_model_does_not_delay_idle_models_flush():
    """Multiplexing isolation: one model wedged mid-execution (and with
    work queued behind it) must not add a microsecond of queueing to a
    sibling model's flush — per-model queues, per-model workers."""
    wedge = threading.Event()

    class SlowServable(CountingServable):
        name = "slow"

        def predict(self, instances):
            wedge.wait(10)
            return super().predict(instances)

    fast = CountingServable()
    fast.name = "fast"

    def factory(rspec):
        return SlowServable() if rspec["model"] == "slow" else fast

    registry = ServableRegistry(
        factory,
        batching=BatchingConfig(max_batch=4, timeout_ms=5.0),
    )
    registry.ensure({"model": "slow"})
    registry.ensure({"model": "fast"})
    x = np.ones((1, 2))
    threads = [
        threading.Thread(
            target=lambda: registry.predict("slow", x), daemon=True
        )
        for _ in range(3)
    ]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while (
            registry.stats()["models"]["slow"].get("inflight", 0) == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.005)

        t0 = time.monotonic()
        out = registry.predict("fast", x)
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(out, x * 2.0)
        assert not wedge.is_set()  # slow was STILL wedged throughout
        # Generous bound: page-in + one flush window, nowhere near the
        # 10s the slow model's gate would impose if queues were shared.
        assert elapsed < 2.0, f"idle model's flush took {elapsed:.2f}s"
    finally:
        wedge.set()
        for t in threads:
            t.join(timeout=10)
        registry.close()


def test_kill_during_page_in_fails_only_that_model():
    """kill(model) while its page-in is in flight: the claiming caller
    and every caller parked on the load fail with QueueClosed; sibling
    models keep serving; the killed model pages back in on the next
    request (generation fencing, no resurrect of the dead load)."""
    in_factory = threading.Event()
    release = threading.Event()

    def factory(rspec):
        if rspec["model"] == "wedged":
            in_factory.set()
            release.wait(10)

            class Wedged(CountingServable):
                name = "wedged"

            return Wedged()
        ok = CountingServable()
        ok.name = "ok"
        return ok

    registry = ServableRegistry(
        factory,
        batching=BatchingConfig(max_batch=4, timeout_ms=5.0),
    )
    registry.ensure({"model": "wedged"})
    registry.ensure({"model": "ok"})
    x = np.ones((1, 2))
    registry.predict("ok", x)  # sibling resident before the fun starts

    errors = [None, None]

    def call(i):
        try:
            registry.predict("wedged", x)
        except BaseException as e:
            errors[i] = e

    claimer = threading.Thread(target=call, args=(0,))
    parked = threading.Thread(target=call, args=(1,))
    try:
        claimer.start()
        assert in_factory.wait(5)  # page-in is now in flight
        parked.start()
        time.sleep(0.05)  # let the second caller park on ready

        registry.kill("wedged")

        # Parked caller dies immediately — it is not waiting on the
        # factory, only on the entry's ready event.
        parked.join(timeout=5)
        assert not parked.is_alive()
        assert isinstance(errors[1], QueueClosed), errors
        assert "page-in" in str(errors[1])

        # The sibling never noticed.
        np.testing.assert_array_equal(registry.predict("ok", x), x * 2.0)

        # The claimer unwinds once the wedged factory returns into a
        # bumped generation — its load is discarded, not installed.
        release.set()
        claimer.join(timeout=5)
        assert not claimer.is_alive()
        assert isinstance(errors[0], QueueClosed), errors

        # And the model is not poisoned: next request pages it back in.
        np.testing.assert_array_equal(
            registry.predict("wedged", x), x * 2.0
        )
    finally:
        release.set()
        registry.close()


# -- parity with the JAX package's registry -------------------------------------


def _registry_trace(pkg: str, seed: int) -> list:
    """One seeded sequence of catalog and request operations through
    `pkg`'s registry ("jax" or "torch") at ``max_resident=3`` over five
    models, with a recording factory; after every operation, the builds
    so far, each model's page-outs and the stats without their timings."""
    import random

    if pkg == "jax":
        from kubeflow_tpu.serving import batching as bt
        from kubeflow_tpu.serving import registry as rg
    else:
        from kubeflow_tpu_torch.serving import batching as bt
        from kubeflow_tpu_torch.serving import registry as rg

    factory = Recorder()
    registry = rg.ServableRegistry(
        factory, batching=bt.BatchingConfig(max_batch=4, timeout_ms=1.0),
        paging=rg.PagingConfig(max_resident=3),
    )
    names = ["a", "b", "c", "d", "e"]
    rng = random.Random(seed)
    trace = []
    try:
        for name in names:
            registry.ensure({"model": name, "modelVersion": 1})
        for step in range(60):
            name = rng.choice(names)
            op = rng.random()
            if op < 0.1:
                registry.roll(name, {"model": name, "modelVersion": step + 2})
                outcome = "rolled"
            elif op < 0.15:
                registry.kill(name)
                outcome = "killed"
            elif op < 0.2:
                registry.remove(name)
                registry.ensure({"model": name, "modelVersion": 1})
                outcome = "re-registered"
            else:
                outcome = registry.predict(name, X * step).tolist()
            stats = registry.stats()
            for row in stats["models"].values():
                row.pop("last_page_in_s")
                row.pop("queue_wait_ms", None)
            trace.append((
                name, outcome, list(factory.builds),
                {n: registry.page_outs_total.value(model=n) for n in names},
                stats,
            ))
            time.sleep(0.002)  # distinct LRU stamps
    finally:
        registry.close()
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_same_sequence_same_paging_as_the_jax_registry(seed):
    jax_trace = _registry_trace("jax", seed)
    torch_trace = _registry_trace("torch", seed)
    for want, got in zip(jax_trace, torch_trace):
        assert got == want
    assert len(torch_trace) == len(jax_trace) == 60
    outcomes = {row[1] for row in jax_trace if isinstance(row[1], str)}
    assert {"rolled", "killed", "re-registered"} <= outcomes
    assert sum(jax_trace[-1][3].values()) >= 5  # LRU paging engaged


# -- a page-out leaves no reference to the servable ---------------------------


class _Weights:
    """A stand-in servable that a weak reference can watch."""

    def __init__(self, name):
        self.name, self.version = name, 1

    def predict(self, instances):
        return np.asarray(instances) * 2.0


def _dies(ref, timeout=5.0) -> bool:
    """True once `ref` is dead (the garbage collector stays off: a
    reference cycle would keep it alive), polled for the scheduler
    thread of a killed queue to finish."""
    deadline = time.monotonic() + timeout
    while ref() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    return ref() is None


@pytest.mark.parametrize("how", ["page_out", "kill_model", "remove", "kill", "close"])
def test_dropping_a_model_leaves_no_reference_to_its_servable(how):
    import gc
    import weakref

    refs = {}

    def factory(rspec):
        servable = _Weights(rspec["model"])
        refs[rspec["model"]] = weakref.ref(servable)
        return servable

    registry = make_registry(max_resident=1, factory=factory)
    gc.disable()
    try:
        registry.ensure({"model": "a"})
        registry.ensure({"model": "b"})
        registry.predict("a", X)
        assert refs["a"]() is not None
        if how == "page_out":
            registry.predict("b", X)  # max_resident=1: "a" pages out
        elif how == "kill_model":
            registry.kill("a")
        elif how == "remove":
            registry.remove("a")
        else:
            getattr(registry, how)()
        assert _dies(refs["a"]), how
    finally:
        gc.enable()
        registry.close()


def test_a_failed_page_in_keeps_no_half_built_model():
    """A factory that built a model and then failed (a warm-up out of
    memory, say): the error reaches every caller, and the registry keeps
    it, but not the frames whose locals held that model, whether a
    request's page-in failed or a roll's (which raises to no one)."""
    import gc
    import weakref

    refs = []
    fail = [True]

    def factory(rspec):
        built = _Weights(rspec["model"])
        refs.append(weakref.ref(built))
        if fail[0]:
            raise RuntimeError("warm-up ran out of memory")
        return built

    registry = make_registry(factory=factory)
    gc.disable()
    try:
        registry.ensure({"model": "a"})
        for _ in range(2):
            with pytest.raises(RuntimeError, match="out of memory"):
                registry.predict("a", X)
        fail[0] = False
        registry.predict("a", X)
        fail[0] = True
        registry.roll("a")  # the old generation pages out, the new fails
        assert registry.stats()["models"]["a"]["state"] == "registered"
        assert len(refs) == 4
        assert all(_dies(ref, timeout=0.0) for ref in refs)
    finally:
        gc.enable()
        registry.close()


# -- a tiny_resnet catalog restored by build_servable_from_rspec -------------


def _write_resnet_checkpoint(directory, model, step: int) -> None:
    """`model`'s parameters and batch statistics as step `step` of a
    checkpoint directory, in the layout `Servable.from_checkpoint` reads."""
    from kubeflow_tpu_torch.train import Checkpointer
    from kubeflow_tpu_torch.train.trainer import batch_stats

    ckpt = Checkpointer(directory, save_interval_steps=1)
    ckpt.save(step, {"params": dict(model.named_parameters()),
                     "batch_stats": batch_stats(model)}, force=True)
    ckpt.close()


def _tiny_resnets(n: int):
    """`n` distinct tiny_resnets (seeds 0..n-1) with every BatchNorm's
    statistics and affine moved off their init, in eval mode."""
    import torch

    from kubeflow_tpu_torch.models import resnet as tr

    models = []
    for seed in range(n):
        model = tr.tiny_resnet(device="cpu", seed=seed)
        gen = torch.Generator().manual_seed(100 + seed)
        with torch.no_grad():
            for bn in model.modules():
                if isinstance(bn, tr.BatchNorm):
                    shape = bn.weight.shape
                    bn.weight.copy_(1 + 0.2 * torch.randn(shape, generator=gen))
                    bn.bias.copy_(0.1 * torch.randn(shape, generator=gen))
                    bn.running_mean.copy_(0.1 * torch.randn(shape, generator=gen))
                    bn.running_var.copy_(1 + 0.5 * torch.rand(shape, generator=gen))
        models.append(model.eval())
    return models


def test_checkpoint_catalog_pages_through_one_slot(tmp_path, monkeypatch):
    """Three tiny_resnet checkpoints behind one registry at
    ``max_resident=1``: every request after the first pages a model in
    from its directory (the binary's factory, restoring into a module of
    another seed), and every answer equals the written module's own
    forward on the same instance."""
    import torch

    from kubeflow_tpu_torch.models import resnet as tr
    from kubeflow_tpu_torch.serving import __main__ as binary

    # The binary restores into resnet50(); a CPU test restores the same
    # way into tiny_resnet (the catalog's architecture), seeded apart
    # so that nothing is served unless it was restored.
    monkeypatch.setattr(binary, "resnet50",
                        lambda device=None: tr.tiny_resnet(device=device, seed=99))
    models = _tiny_resnets(3)
    for i, model in enumerate(models):
        _write_resnet_checkpoint(tmp_path / f"r{i}", model, step=10 + i)
    registry = ServableRegistry(
        lambda rspec: binary.build_servable_from_rspec(rspec, device="cpu"),
        batching=BatchingConfig(max_batch=4, timeout_ms=1.0),
        paging=PagingConfig(max_resident=1),
    )
    x = np.random.default_rng(0).standard_normal((1, 224, 224, 3)).astype(np.float32)
    try:
        for i in range(3):
            registry.ensure({"model": f"r{i}", "checkpointDir": str(tmp_path / f"r{i}"),
                             "maxBatch": 4})
        answers = {}
        for name in ["r0", "r1", "r2", "r0", "r2", "r1"]:
            got = registry.predict(name, x)
            answers.setdefault(name, got)
            np.testing.assert_array_equal(got, answers[name])
        with torch.inference_mode():
            for i, model in enumerate(models):
                np.testing.assert_array_equal(
                    answers[f"r{i}"], model(torch.tensor(x)).numpy())
        stats = registry.stats()
        assert stats["resident"] == 1
        assert {n: r["page_ins"] for n, r in stats["models"].items()} == {
            "r0": 2, "r1": 2, "r2": 2}
        assert {n: r["version"] for n, r in stats["models"].items()
                if r["state"] == "resident"} == {"r1": 11}
        assert sum(registry.page_outs_total.value(model=n) for n in answers) == 5
    finally:
        registry.close()


def test_build_servable_from_rspec_demo_model():
    from kubeflow_tpu_torch.serving import __main__ as binary

    servable = binary.build_servable_from_rspec(
        {"model": "m", "modelVersion": 3, "maxBatch": 2}, device="cpu")
    assert (servable.name, servable.version, servable.max_batch) == ("m", 3, 2)
    out = servable.predict(np.zeros((3, 32, 32, 3), np.float32))
    assert out.shape == (3, 10) and np.isfinite(out).all()


def test_a_model_just_paged_in_is_the_most_recently_used():
    """A page-in that takes long (a full-width checkpoint restore under
    load) must not leave its model the LRU victim of the next page-in:
    its parked callers have not reached its queue yet. Installing counts
    as a use."""
    release = threading.Event()
    in_factory = threading.Event()
    recorder = Recorder()

    def factory(rspec):
        if rspec["model"] == "a":
            in_factory.set()
            release.wait(10)
        return recorder(rspec)

    registry = make_registry(max_resident=2, factory=factory)
    try:
        for name in ("a", "b", "c", "d"):
            registry.ensure({"model": name})
        registry.predict("b", X)
        t = threading.Thread(target=registry.predict, args=("a", X))
        t.start()
        assert in_factory.wait(5)  # a's load claimed, and slow
        time.sleep(0.01)
        registry.predict("c", X)  # used after a's claim
        release.set()
        t.join(timeout=10)
        assert not t.is_alive()
        registry.predict("d", X)  # pages out the LRU: c, not fresh a
        states = {n: r["state"] for n, r in registry.stats()["models"].items()}
        assert states == {"a": "resident", "b": "registered",
                          "c": "registered", "d": "resident"}
    finally:
        release.set()
        registry.close()


def test_page_outs_under_a_caller_never_read_as_death():
    """A caller whose model pages out between its lookup and its call
    pages it back in, however often that happens: QueueClosed out of a
    live registry would reach the router as ReplicaGone and mark a live
    replica dead. Here every lookup of "a", three times over, is
    followed by a page-in of "b" that evicts it (one slot)."""
    factory = Recorder()
    registry = make_registry(max_resident=1, factory=factory)
    lookup = registry._resident_queue
    evictions = [3]

    def racing_lookup(model):
        queue = lookup(model)
        if model == "a" and evictions[0]:
            evictions[0] -= 1
            registry.predict("b", X)  # closes a's queue under the caller
        return queue

    registry._resident_queue = racing_lookup
    try:
        registry.ensure({"model": "a"})
        registry.ensure({"model": "b"})
        np.testing.assert_array_equal(registry.predict("a", X), X * 2.0)
        assert factory.builds == ["a", "b", "a", "b", "a", "b", "a"]
        registry.kill()
        with pytest.raises(QueueClosed):
            registry.predict("a", X)  # a killed registry still re-raises
    finally:
        registry.close()


def test_a_waiter_whose_model_pages_out_again_pages_it_in():
    """A caller parked on a page-in whose model is paged out again
    (another install took the one slot) before it got to the queue pages
    the model in anew; it is not told the model is gone."""
    release, b_done = threading.Event(), threading.Event()
    in_factory = threading.Event()
    recorder = Recorder()

    def factory(rspec):
        if rspec["model"] == "a" and not in_factory.is_set():
            in_factory.set()
            release.wait(10)
        return recorder(rspec)

    class LateWaiter(threading.Event):
        """Wakes only once "b" has taken the slot after "a" installed."""

        def wait(self, timeout=None):
            super().wait(timeout)
            return b_done.wait(timeout)

    registry = make_registry(max_resident=1, factory=factory)
    results, errors = [], []

    def call():
        try:
            results.append(registry.predict("a", X))
        except BaseException as e:
            errors.append(e)

    claimer, waiter = threading.Thread(target=call), threading.Thread(target=call)
    try:
        registry.ensure({"model": "a"})
        registry.ensure({"model": "b"})
        claimer.start()
        assert in_factory.wait(5)  # a's page-in is in flight
        with registry._lock:
            registry._entries["a"].ready = LateWaiter()
        waiter.start()
        time.sleep(0.05)  # parked on a's ready event
        release.set()
        claimer.join(timeout=10)
        registry.predict("b", X)  # one slot: "a" pages out
        b_done.set()
        waiter.join(timeout=10)
        assert not claimer.is_alive() and not waiter.is_alive()
        assert errors == [] and len(results) == 2
        assert recorder.builds == ["a", "b", "a"]
    finally:
        release.set()
        b_done.set()
        registry.close()
