"""The port's tenant lifecycle against the JAX package's: the store's
finalizers and Namespace drain (`testing/fake_apiserver.py`), the
workload materializer (`runtime/workloads.py`) and the Profile,
Notebook and Tensorboard controllers (`controllers/{profile,notebook,
tensorboard}.py`).

- JAX's own tests run against the port, every case: the modules'
  source with their imports pointed at the port and `google.com/tpu`
  read as `nvidia.com/gpu` (tests/test_profile_controller.py,
  tests/test_notebook_controller.py, tests/test_tensorboard_controller.py,
  tests/test_workload_materializer.py, and of
  tests/test_fake_apiserver.py the three finalizer and cascade tests).
- One seeded sequence of Profile, Notebook and Tensorboard creates,
  stop-annotation changes, pod phase changes and deletes (Profile
  deletion and a namespace conflict included) goes through both
  packages' stores with the three controllers and the materializer: the
  same objects (kind, namespace, name, spec, labels, annotations, owner
  kinds), the same statuses and the same event reasons after every
  operation.
- The drain on the durable store: a Profile deleted with its finalizer
  pending survives a restart from the WAL as pending, is finalized by a
  controller on the restarted store, and a third store over the same
  directory holds neither the Profile, nor its Namespace, nor anything
  in it.
- A create into a namespace the store drained: the JAX store takes it
  (a stale materializer step or an in-flight TpuJob reconcile leaves a
  pod nothing owns in a namespace that is gone), the port's refuses it.
- The tenant modules import no JAX and nothing of the JAX package.
"""

import json
import os
import random
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers.notebook import NotebookController as JNotebookController
from kubeflow_tpu.controllers.profile import ProfileController as JProfileController
from kubeflow_tpu.controllers.tensorboard import TensorboardController as JTensorboardController
from kubeflow_tpu.runtime import WorkloadMaterializer as JWorkloadMaterializer
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers.notebook import STOP_ANNOTATION, NotebookController
from kubeflow_tpu_torch.controllers.profile import FINALIZER, ProfileController
from kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from kubeflow_tpu_torch.runtime import WorkloadMaterializer
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

REPO = Path(__file__).resolve().parents[1]
MODULES = ("test_profile_controller", "test_notebook_controller",
           "test_tensorboard_controller", "test_workload_materializer")
STORE_TESTS = ("test_finalizers_defer_deletion", "test_owner_cascade",
               "test_finalizer_cascade_journal_stays_rv_ordered")


def _jax_module_on_the_port(stem: str) -> dict:
    """JAX's test module tests/<stem>.py executed with `kubeflow_tpu.`
    imports pointed at `kubeflow_tpu_torch.` and the TPU resource read
    as the GPU: its namespace."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return namespace


def _cases() -> dict:
    cases = {}
    for stem in MODULES:
        namespace = _jax_module_on_the_port(stem)
        for name, fn in namespace.items():
            if name.startswith("test_") and callable(fn):
                assert not getattr(fn, "pytestmark", []), f"{stem}.{name} is parametrised"
                cases[f"{stem}::{name}"] = fn
    namespace = _jax_module_on_the_port("test_fake_apiserver")
    for name in STORE_TESTS:
        cases[f"test_fake_apiserver::{name}"] = namespace[name]
    return cases


JAX_CASES = _cases()


def test_all_of_jax_tenant_tests_are_collected():
    by_module = {}
    for case in JAX_CASES:
        stem = case.split("::")[0]
        by_module[stem] = by_module.get(stem, 0) + 1
    assert by_module == {"test_profile_controller": 6, "test_notebook_controller": 11,
                         "test_tensorboard_controller": 3, "test_workload_materializer": 6,
                         "test_fake_apiserver": 3}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_jax_tenant_tests_on_the_port(case):
    fn = JAX_CASES[case]
    if "api" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        api = FakeApiServer()
        try:
            fn(api)
        finally:
            api.close()
    else:
        fn()


# -- one seeded sequence through both packages ------------------------------------


class Tenancy:
    """One package's store with the three controllers and the
    materializer, settled to a fixpoint after each operation."""

    def __init__(self, store, new, profile, notebook, tensorboard, materializer):
        self.api = store()
        self.new = new
        self.controllers = [profile(self.api).controller, notebook(self.api).controller,
                            tensorboard(self.api).controller]
        self.materializer = materializer(self.api)

    def settle(self) -> None:
        for _ in range(20):
            before = self.api.current_rv
            for c in self.controllers:
                c.run_until_idle()
            self.materializer.step()
            for c in self.controllers:
                c.run_until_idle()
            if self.api.current_rv == before:
                return
        raise AssertionError("the tenancy did not settle")

    def snapshot(self) -> dict:
        objects, events = {}, []
        for kind in sorted(set(self.api.kinds())):
            for obj in self.api.list(kind):
                if kind == "Event":
                    events.append((obj.metadata.namespace, obj.spec["involvedObject"]["kind"],
                                   obj.spec["involvedObject"]["name"], obj.spec["reason"],
                                   obj.spec["type"]))
                    continue
                owners = sorted(ref["kind"] for ref in obj.metadata.owner_references)
                objects[obj.key] = (obj.spec, dict(obj.metadata.labels),
                                    dict(obj.metadata.annotations), owners,
                                    list(obj.metadata.finalizers),
                                    obj.metadata.deletion_timestamp is not None, obj.status)
        return {"objects": objects, "events": sorted(events)}

    def close(self) -> None:
        if hasattr(self.api, "close"):
            self.api.close()


def _sequence(seed: int, n: int) -> list:
    rng = random.Random(seed)
    ops = [("foreign_namespace", "t9", None)]
    for i in range(n):
        tenant = f"t{rng.randrange(3)}" if rng.random() < 0.9 else "t9"
        r = rng.random()
        if r < 0.2:
            hard = {"nvidia.com/gpu": rng.choice([1, 2]), "pods": rng.choice([4, 8])}
            ops.append(("profile", tenant, hard if rng.random() < 0.7 else None))
        elif r < 0.38:
            ops.append(("notebook", tenant, f"nb{rng.randrange(3)}"))
        elif r < 0.52:
            logspath = rng.choice(["ckpt/traces", "gs://bucket/run", "ckpt"])
            ops.append(("tensorboard", tenant, (f"tb{rng.randrange(2)}", logspath)))
        elif r < 0.64:
            ops.append(("stop", tenant, (f"nb{rng.randrange(3)}", rng.random() < 0.6)))
        elif r < 0.78:
            ops.append(("pod_phase", tenant, (rng.random(), rng.choice(["Running", "Failed",
                                                                         "Pending"]))))
        elif r < 0.88:
            kind = rng.choice(["Notebook", "Tensorboard"])
            ops.append(("delete", tenant, (kind, rng.random())))
        else:
            ops.append(("delete_profile", tenant, None))
    return ops


def _apply(t: Tenancy, op) -> None:
    what, ns, arg = op
    api, new = t.api, t.new
    try:
        if what in ("notebook", "tensorboard"):
            # A tenant creates into its namespace: a namespace with no
            # Namespace object yet, or one a Profile's deletion drained,
            # is skipped (the port refuses a create into a drained one;
            # `test_a_create_into_a_drained_namespace_*` below).
            api.get("Namespace", ns, "")
        if what == "foreign_namespace":
            api.create(new("Namespace", ns, ""))
        elif what == "profile":
            spec = {"owner": {"kind": "User", "name": f"{ns}@example.com"}}
            if arg:
                spec["resourceQuotaSpec"] = {"hard": dict(arg)}
            api.create(new("Profile", ns, "default", spec=spec))
        elif what == "notebook":
            api.create(new("Notebook", arg, ns, spec={"image": "nb:1"}))
        elif what == "tensorboard":
            name, logspath = arg
            api.create(new("Tensorboard", name, ns, spec={"logspath": logspath}))
        elif what == "stop":
            name, stop = arg
            nb = api.get("Notebook", name, ns).thaw()
            if stop:
                nb.metadata.annotations[STOP_ANNOTATION] = "scripted"
            else:
                nb.metadata.annotations.pop(STOP_ANNOTATION, None)
            api.update(nb)
        elif what == "pod_phase":
            pick, phase = arg
            pods = api.list("Pod", ns)
            if pods:
                pod = pods[int(pick * len(pods))].thaw()
                pod.status["phase"] = phase
                api.update_status(pod)
        elif what == "delete":
            kind, pick = arg
            objs = api.list(kind, ns)
            if objs:
                obj = objs[int(pick * len(objs))]
                api.delete(kind, obj.metadata.name, ns)
        elif what == "delete_profile":
            api.delete("Profile", ns, "default")
    except Exception as e:  # the same refusal on both sides
        return type(e).__name__
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_same_objects_conditions_and_events_as_jax(seed):
    port = Tenancy(FakeApiServer, new_resource, ProfileController, NotebookController,
                   TensorboardController, WorkloadMaterializer)
    jax = Tenancy(JFakeApiServer, j_new_resource, JProfileController, JNotebookController,
                  JTensorboardController, JWorkloadMaterializer)
    try:
        for i, op in enumerate(_sequence(seed, 80)):
            assert _apply(port, op) == _apply(jax, op), (i, op)
            port.settle()
            jax.settle()
            assert port.snapshot() == jax.snapshot(), (i, op)
        # The sequence reached what it is about: a drained profile, a
        # refused takeover, a stopped notebook.
        reasons = {e[3] for e in port.snapshot()["events"]}
        assert "NamespaceConflict" in reasons
    finally:
        port.close()
        jax.close()


def test_the_seeded_sequences_drain_a_profile_with_workloads_in_it():
    """What the parity above covers: each seed deletes a Profile whose
    namespace holds a Notebook's or a Tensorboard's pods."""
    for seed in (0, 1, 2):
        t = Tenancy(FakeApiServer, new_resource, ProfileController, NotebookController,
                    TensorboardController, WorkloadMaterializer)
        drained = False
        try:
            for op in _sequence(seed, 80):
                owned = {n.metadata.name for n in t.api.list("Namespace")
                         if n.metadata.owner_references}
                held = {p.metadata.namespace for p in t.api.list("Pod")} & owned
                _apply(t, op)
                t.settle()
                if op[0] == "delete_profile" and op[1] in held:
                    assert t.api.list("Pod", op[1]) == []
                    assert [k for k in t.api.kinds() if t.api.list(k, op[1])] == []
                    drained = True
        finally:
            t.close()
        assert drained, seed


# -- the drain on the durable store ---------------------------------------------


def test_pending_profile_deletion_survives_a_restart_and_drains(tmp_path):
    state = str(tmp_path / "state")
    api = FakeApiServer(persist_dir=state, snapshot_every=7)
    ctl = ProfileController(api)
    nbs = NotebookController(api)
    materializer = WorkloadMaterializer(api)
    api.create(new_resource("Profile", "team", "default", spec={
        "owner": {"kind": "User", "name": "t@example.com"},
        "resourceQuotaSpec": {"hard": {"nvidia.com/gpu": 1}}}))
    ctl.controller.run_until_idle()
    api.create(new_resource("Notebook", "nb", "team", spec={"image": "nb:1"}))
    api.create(new_resource("PersistentVolumeClaim", "ckpt", "team"))
    for _ in range(3):
        nbs.controller.run_until_idle()
        materializer.step()
    assert api.get("Pod", "nb-0", "team").status["phase"] == "Running"
    in_team = {o.key for k in api.kinds() for o in api.list(k, "team")}
    assert len(in_team) >= 9  # SAs, RoleBinding, policy, quota, STS, Service, VS, pod, PVC
    api.delete("Profile", "team", "default")  # parks: the controller is not run
    api.close()

    api = FakeApiServer(persist_dir=state)
    pending = api.get("Profile", "team", "default")
    assert pending.metadata.deletion_timestamp is not None
    assert pending.metadata.finalizers == [FINALIZER]
    assert {o.key for k in api.kinds() for o in api.list(k, "team")} == in_team
    bookmark = api.current_rv
    ProfileController(api).controller.run_until_idle()
    events, _ = api.events_since(bookmark)
    rvs = [rv for rv, _, _ in events]
    assert rvs == sorted(rvs)
    deleted = {o.key for _, event, o in events if event == "DELETED"}
    assert in_team | {("Profile", "default", "team"), ("Namespace", "", "team")} <= deleted
    api.close()

    api = FakeApiServer(persist_dir=state)
    try:
        with pytest.raises(NotFound):
            api.get("Profile", "team", "default")
        with pytest.raises(NotFound):
            api.get("Namespace", "team", "")
        assert [o.key for k in api.kinds() for o in api.list(k, "team")] == []
    finally:
        api.close()


def test_a_held_dependent_stays_until_it_is_finalized():
    """The cascade deletes a dependent that still lists a finalizer the
    way `delete` does: it is only marked, and its own cascade runs when
    its last finalizer is cleared."""
    api = FakeApiServer()
    try:
        parent = api.create(new_resource("Profile", "p"))
        child = new_resource("Namespace", "p", "")
        child.metadata.owner_references = [{"kind": "Profile", "name": "p",
                                            "uid": parent.metadata.uid, "controller": True}]
        child.metadata.finalizers = ["kubernetes"]
        api.create(child)
        api.create(new_resource("Pod", "w", "p"))
        api.delete("Profile", "p")
        held = api.get("Namespace", "p", "")
        assert held.metadata.deletion_timestamp is not None
        assert api.get("Pod", "w", "p")
        held = held.thaw()
        held.metadata.finalizers = []
        api.update(held)
        with pytest.raises(NotFound):
            api.get("Namespace", "p", "")
        assert api.list("Pod", "p") == []
    finally:
        api.close()


# -- a create into a drained namespace: the reference's fault, fixed in the port -----


def _drained_store(store, new):
    api = store()
    api.create(new("Namespace", "team", ""))
    api.create(new("Deployment", "tb", "team", spec={
        "replicas": 1, "template": {"metadata": {"labels": {"tensorboard": "tb"}},
                                    "spec": {"containers": [{"name": "tb"}]}}}))
    return api


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_create_into_a_drained_namespace_by_a_stale_materializer_step(package):
    """A materializer step that listed a Deployment before its namespace
    was drained creates the pod after it: the JAX store keeps that pod, a
    Running pod that nothing owns in a namespace that is gone; the port's
    store refuses it, and the step ends on NotFound as on any race."""
    store, new, materializer = (
        (JFakeApiServer, j_new_resource, JWorkloadMaterializer) if package == "jax"
        else (FakeApiServer, new_resource, WorkloadMaterializer))
    api = _drained_store(store, new)
    stale = api.list("Deployment", "team")[0]
    api.delete("Namespace", "team", "")
    assert api.list("Deployment", "team") == []
    with pytest.raises(Exception) as raised:
        materializer(api)._reconcile(stale)
    assert type(raised.value).__name__ == "NotFound"
    orphans = [p.metadata.name for p in api.list("Pod", "team")]
    assert orphans == (["tb-dp-0"] if package == "jax" else [])
    if package == "port":
        api.create(new("Namespace", "team", ""))  # created again: open again
        api.create(new("Pod", "p", "team"))
        api.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_create_into_a_drained_namespace_by_an_in_flight_tpujob_reconcile(package):
    """A TpuJob reconcile that read its job just before the job's namespace
    was drained goes on to create the gang's Service and pods: the JAX
    store takes them, the port's refuses the first with NotFound, and the
    operator's next pass finds the job gone."""
    if package == "jax":
        from kubeflow_tpu.api import make_tpujob
        from kubeflow_tpu.controllers.tpujob import TpuJobController as Operator
        store, new = JFakeApiServer, j_new_resource
    else:
        from kubeflow_tpu_torch.api import make_tpujob
        from kubeflow_tpu_torch.controllers.tpujob import TpuJobController as Operator
        store, new = FakeApiServer, new_resource

    api = store()
    api.create(new("Namespace", "team", ""))
    api.create(make_tpujob("lm", "team", replicas=1, tpu_chips_per_worker=1,
                           command=("python", "-c", "pass")))

    class DrainAfterTheJobIsRead:
        """The store, with the namespace drained right after the
        reconcile's read of its job."""

        def __getattr__(self, name):
            return getattr(api, name)

        drained = False

        def get(self, kind, name, namespace="default"):
            obj = api.get(kind, name, namespace)
            if kind == "TpuJob" and not self.drained:
                self.drained = True
                api.delete("Namespace", "team", "")
            return obj

    operator = Operator(api)
    if package == "jax":
        # The gang is created; only the status write after it finds the
        # job gone.
        with pytest.raises(Exception) as raised:
            operator.reconcile(DrainAfterTheJobIsRead(), ("team", "lm"))
        assert type(raised.value).__name__ == "NotFound"
        assert [p.metadata.name for p in api.list("Pod", "team")] == ["lm-worker-0"]
    else:
        with pytest.raises(NotFound, match="namespace 'team' is gone"):
            operator.reconcile(DrainAfterTheJobIsRead(), ("team", "lm"))
        assert api.list("Pod", "team") == [] and api.list("Service", "team") == []
        operator.reconcile(api, ("team", "lm"))  # the next pass: the job is gone
        assert api.list("Pod", "team") == []
        api.close()


def test_tenant_modules_import_no_jax():
    modules = ["kubeflow_tpu_torch.controllers.profile", "kubeflow_tpu_torch.controllers.notebook",
               "kubeflow_tpu_torch.controllers.tensorboard",
               "kubeflow_tpu_torch.runtime.workloads", "kubeflow_tpu_torch.controllers.__main__"]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kubeflow_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
