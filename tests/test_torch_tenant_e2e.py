"""A tenant's lifecycle end to end on the CPU, through the port's binary
(``--controllers profile,notebook,tensorboard,tpujob``) and `JobPlane`
with a durable store (``persist_dir``) and the workload materializer
beside the pod runner, as chip_smoke's tenant phase runs it on the card:

- Profile team-c provisions its namespace (owner annotation and an
  ownerReference to the Profile, both ServiceAccounts, the RoleBinding,
  the AuthorizationPolicy, the ResourceQuota, the finalizer); Profile
  team-x meets a namespace it does not own and is Failed with one
  NamespaceConflict Warning, the namespace untouched;
- a tiny LM TpuJob (`testing/workers/lm_job.py`, one thread, paced)
  trains in team-c under the quota's one GPU (status.used reads 1 while
  it runs) and traces two steps into ``KFTPU_TRACE_DIR``; a Notebook
  reaches Running through the materializer and stops; a Tensorboard on
  the trace directory's claim becomes ready;
- deleting the Profile mid-run drains team-c: the worker gets SIGTERM,
  honours it at a step boundary and exits 0; nothing of any kind is left
  in the namespace, no pod comes back and the runner starts no process;
  the binary exits 0 on SIGTERM; a fresh store over the state directory
  holds neither the Profile, nor the Namespace, nor anything in it.
"""

import json
import os
import sys
import time

from kubeflow_tpu_torch.api import make_tpujob, new_resource
from kubeflow_tpu_torch.controllers.notebook import STOP_ANNOTATION
from kubeflow_tpu_torch.controllers.profile import EDITOR_SA, FINALIZER, VIEWER_SA
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.testing.job_plane import JobPlane

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32, d_ff=128,
            batch=2, seq=128, dtype="float32", lr=1e-2)
HARD = {"nvidia.com/gpu": 1, "pods": 8, "persistentvolumeclaims": 2}
QUIET_S = 3.0


def _records(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith('{"event"')]


def _gone(api, kind, name, ns) -> bool:
    try:
        api.get(kind, name, ns)
    except NotFound:
        return True
    return False


def test_profile_deletion_drains_a_training_tenant(tmp_path):
    state = str(tmp_path / "state")
    trace_dir = tmp_path / "lm-ckpt" / "traces"
    env = {"KFTPU_CKPT_DIR": str(tmp_path / "lm-ckpt" / "ckpt"),
           "KFTPU_TRACE_DIR": str(trace_dir), "KFTPU_TOTAL_STEPS": "40",
           "KFTPU_SAVE_EVERY": "4", "KFTPU_STEP_SLEEP_S": "0.3",
           "KFTPU_LM_SIZE": json.dumps(TINY)}
    with JobPlane(controllers=("profile", "notebook", "tensorboard", "tpujob"),
                  capture_dir=str(tmp_path / "logs"), persist_dir=state,
                  extra_env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                             "MKL_NUM_THREADS": "1"}) as plane:
        api = plane.api
        assert "manager ready profile,notebook,tensorboard,tpujob" in plane.manager_output
        condition = lambda name: api.get("Profile", name, "default").status.get(  # noqa: E731
            "condition")

        api.create(new_resource("Profile", "team-c", "default", spec={
            "owner": {"kind": "User", "name": "c@example.com"},
            "resourceQuotaSpec": {"hard": dict(HARD)}}))
        plane.run_until(lambda: condition("team-c") == "Ready", 30, "team-c Ready")
        profile = api.get("Profile", "team-c", "default")
        ns = api.get("Namespace", "team-c", "")
        assert ns.metadata.annotations["owner"] == "c@example.com"
        assert [r["uid"] for r in ns.metadata.owner_references] == [profile.metadata.uid]
        for kind, name in (("ServiceAccount", EDITOR_SA), ("ServiceAccount", VIEWER_SA),
                           ("RoleBinding", "namespaceAdmin"),
                           ("AuthorizationPolicy", "ns-owner")):
            assert not _gone(api, kind, name, "team-c"), (kind, name)
        assert api.get("ResourceQuota", "kf-resource-quota", "team-c").spec["hard"] == HARD
        assert profile.metadata.finalizers == [FINALIZER]

        api.create(new_resource("Namespace", "team-x", ""))
        api.create(new_resource("Profile", "team-x", "default",
                                spec={"owner": {"kind": "User", "name": "x@example.com"}}))
        plane.run_until(lambda: condition("team-x") == "Failed", 30, "team-x Failed")

        api.create(new_resource("PersistentVolumeClaim", "lm-ckpt", "team-c"))
        api.create(make_tpujob(
            "lm-tenant", "team-c", replicas=1, tpu_chips_per_worker=1,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items())))
        api.create(new_resource("Notebook", "nb", "team-c", spec={"image": "nb:1"}))
        api.create(new_resource("Tensorboard", "tb", "team-c",
                                spec={"logspath": "lm-ckpt/traces"}))
        plane.run_until(lambda: api.get("Notebook", "nb", "team-c").status.get(
            "containerState") == "Running", 30, "nb Running")
        nb = api.get("Notebook", "nb", "team-c").thaw()
        nb.metadata.annotations[STOP_ANNOTATION] = "test"
        api.update(nb)
        plane.run_until(lambda: api.get("Notebook", "nb", "team-c").status.get(
            "containerState") == "Terminated" and not api.list(
                "Pod", "team-c", label_selector={"notebook": "nb"}), 30, "nb stopped")
        plane.run_until(lambda: api.get("Tensorboard", "tb", "team-c").status.get(
            "readyReplicas") == 1, 30, "tb ready")
        mounts = api.get("Deployment", "tb", "team-c").spec["template"]["spec"][
            "containers"][0]["volumeMounts"]
        assert mounts == [{"name": "logs", "mountPath": "/logs", "subPath": "traces"}]

        used = set()

        def tick():
            if any(p.status.get("phase") == "Running" for p in api.list(
                    "Pod", "team-c", label_selector={"kubeflow-tpu.org/job": "lm-tenant"})):
                used.add(api.get("ResourceQuota", "kf-resource-quota", "team-c").status.get(
                    "used", {}).get("nvidia.com/gpu"))

        plane.run_until(lambda: 3 in {p["step"] for p in api.get(
            "TpuJob", "lm-tenant", "team-c").status.get("metrics", [])}, 120,
            "lm-tenant's step 3 acked", tick=tick)
        assert used - {None, 0} == {1}  # published asynchronously

        api.delete("Profile", "team-c", "default")
        worker = ("team-c", "lm-tenant-worker-0")

        def exited() -> bool:
            return any((ns, name) == worker and ev["exit"] is not None
                       for (ns, name, _), ev in plane.runner.evictions.items())

        plane.run_until(lambda: _gone(api, "Profile", "team-c", "default")
                        and _gone(api, "Namespace", "team-c", "") and exited(), 60,
                        "team-c drained and its worker gone")
        logs = set(os.listdir(tmp_path / "logs"))
        seen = set()
        t0 = time.monotonic()
        plane.run_until(lambda: time.monotonic() - t0 >= QUIET_S, QUIET_S + 30, "quiet",
                        tick=lambda: seen.update(
                            p.metadata.name for p in api.list("Pod", "team-c")))
        assert not seen and plane.runner.running_count() == 0
        assert set(os.listdir(tmp_path / "logs")) == logs
        assert [k for k in api.kinds() if api.list(k, "team-c")] == []
        assert api.get("Namespace", "team-x", "").metadata.annotations == {}
        assert condition("team-x") == "Failed"
        conflicts = [e for e in api.list("Event", "default")
                     if e.spec["reason"] == "NamespaceConflict"]
        assert len(conflicts) == 1

        (eviction,) = [ev for (ns, name, _), ev in plane.runner.evictions.items()
                       if (ns, name) == worker]
        assert eviction["returncode"] == 0
        records = _records(plane.pod_logs()["lm-tenant-worker-0.log"])
        (preempted,) = [r for r in records if r["event"] == "preempted"]
        assert 3 <= preempted["steps_done"] < 40
        (trace,) = [r for r in records if r["event"] == "trace"]
        assert trace["written"] and any(f.endswith(".pt.trace.json")
                                        for f in os.listdir(trace_dir))
        assert plane.stop_manager() == 0

    fresh = FakeApiServer(persist_dir=state)
    try:
        assert _gone(fresh, "Profile", "team-c", "default")
        assert _gone(fresh, "Namespace", "team-c", "")
        assert [k for k in fresh.kinds() if fresh.list(k, "team-c")] == []
        assert not _gone(fresh, "Namespace", "team-x", "")
    finally:
        fresh.close()
