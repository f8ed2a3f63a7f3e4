"""A lost Node end to end on the CPU: the controller-manager binary with
the nodehealth controller (``--controllers tpujob,nodehealth``), the
local pod runner on a cluster model of two one-accelerator Nodes, the
port's sidecar CLI as its own process, and the ResNet records worker
(`testing/workers/resnet_records_job.py`) at tiny_resnet, training
from a record file through `fit()`.

Once the worker has logged step 3 and its step-2 save is committed,
`JobPlane.lose_node` kills its host: the pod's process is SIGKILLed and
its Node deleted. The nodehealth controller fails the pod with reason
NodeLost and one Warning event; the operator restarts the gang once, on
the surviving Node; the new incarnation resumes from the committed save,
repositions the record stream, and repeats the lost steps bitwise
(threads pinned to one, as every e2e worker here). The sidecar gates
the worker's start (SIGCONT), writes SIGTERM when the job succeeds,
uploads the results and exits 0.

Also: no new module of the port imports JAX or the JAX package.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.controllers.nodehealth import REASON_NODE_LOST
from kubeflow_tpu_torch.controllers.tpujob import LABEL_INCARNATION
from kubeflow_tpu_torch.testing.job_plane import JobPlane
from kubeflow_tpu_torch.train.records import RecordSpec, write_records

REPO = Path(__file__).resolve().parents[1]
TINY = dict(model="tiny_resnet", classes=10, image=32, batch=8, lr=0.1)
TOTAL, SAVE_EVERY, LOSE_AFTER = 8, 2, 3


def _records(log: str) -> list[dict]:
    return [json.loads(line) for line in log.splitlines() if line.startswith('{"event"')]


def test_lost_node_fails_the_pod_and_the_gang_resumes_bitwise(tmp_path):
    spec = RecordSpec.of(image=("uint8", (32, 32, 3)), label=("int32", ()))
    rng = np.random.default_rng(0)
    records = str(tmp_path / "train.rec")
    write_records(records, spec, ({"image": rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                                   "label": np.int32(rng.integers(0, 10))} for _ in range(40)))
    ckpt = tmp_path / "ckpt"
    sig, results, store = tmp_path / "sig", tmp_path / "results", tmp_path / "store"
    env = {
        "KFTPU_RECORDS": records, "KFTPU_SHUFFLE_BUFFER": "40", "KFTPU_DATA_SEED": "0",
        "KFTPU_CKPT_DIR": str(ckpt), "KFTPU_TOTAL_STEPS": str(TOTAL),
        "KFTPU_SAVE_EVERY": str(SAVE_EVERY), "KFTPU_STEP_SLEEP_S": "0.5",
        "KFTPU_RESNET_SIZE": json.dumps(TINY), "KFTPU_SIGNAL_DIR": str(sig),
        "KFTPU_RESULTS_DIR": str(results),
    }
    pods: list[tuple] = []
    with JobPlane(controllers=("tpujob", "nodehealth"), capture_dir=str(tmp_path / "logs"),
                  extra_env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                             "MKL_NUM_THREADS": "1"}) as plane:
        plane.api.watch(lambda event, pod: pods.append(
            (event, pod.metadata.uid, pod.metadata.labels.get(LABEL_INCARNATION),
             pod.spec.get("nodeName"), pod.status.get("phase"), pod.status.get("reason"))),
            "Pod")
        plane.add_node("node-a")
        plane.add_node("node-b")
        plane.api.create(make_tpujob(
            "rn", replicas=1, tpu_chips_per_worker=1, max_restarts=1,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.resnet_records_job:main"),
            env=tuple(env.items())))
        # After the create: a sidecar whose first poll finds no job reads it
        # as Failed.
        sidecar = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.sidecar", "--workdir", str(sig),
             "--job", "rn", "--apiserver", plane.url, "--poll-seconds", "0.5",
             "--timeout-seconds", "120", "--skip-device-probe", "--results", str(results),
             "--artifacts", str(store)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            def logged(inc: int, step: int) -> bool:
                return any(r["event"] == "step" and r["incarnation"] == inc
                           and r["step"] == step for r in
                           _records(plane.pod_logs().get("rn-worker-0.log", "")))

            plane.run_until(
                lambda: logged(0, LOSE_AFTER)
                and (ckpt / str(SAVE_EVERY) / "kftpu_manifest.json").exists(),
                120, f"step {LOSE_AFTER} and the step-{SAVE_EVERY} save")
            committed = max(int(p.name) for p in ckpt.iterdir() if p.name.isdigit()
                            and (p / "kftpu_manifest.json").exists())
            host = plane.api.get("Pod", "rn-worker-0").spec["nodeName"]
            assert plane.lose_node(host) == ["rn-worker-0"]
            plane.run_until(
                lambda: plane.api.get("TpuJob", "rn").status.get("phase")
                in ("Succeeded", "Failed"), 120, "the job to finish")
            job = plane.api.get("TpuJob", "rn")
            assert job.status["phase"] == "Succeeded", plane.diagnostics()
            out, _ = sidecar.communicate(timeout=60)
            events = [e for e in plane.api.list("Event", "default")
                      if e.spec["reason"] == REASON_NODE_LOST]
            survivor = plane.api.get("Pod", "rn-worker-0").spec["nodeName"]
            log = plane.pod_logs()["rn-worker-0.log"]
            assert plane.stop_manager() == 0
        finally:
            if sidecar.poll() is None:
                sidecar.kill()
                sidecar.wait()

    # NodeLost, once, on the lost host's pod; one restart on the survivor.
    lost = [p for p in pods if p[4] == "Failed"]
    assert lost and {p[5] for p in lost} == {REASON_NODE_LOST}, pods
    assert {(p[2], p[3]) for p in lost} == {("0", host)}
    assert len(events) == 1 and events[0].spec["type"] == "Warning"
    assert job.status["restarts"] == 1
    assert survivor != host and survivor in ("node-a", "node-b")

    # The resume: from the committed save, the lost steps repeated bitwise,
    # and the record position equal to the step on every line.
    records_ = _records(log)
    steps = {(r["incarnation"], r["step"]): r for r in records_ if r["event"] == "step"}
    first = sorted(s for i, s in steps if i == 0)
    again = sorted(s for i, s in steps if i == 1)
    obs = job.status["observation"]
    assert committed >= SAVE_EVERY and obs["resumed_from"] == float(committed)
    assert again == list(range(committed + 1, TOTAL + 1))
    repeated = [s for s in first if s > committed]
    assert repeated and all(steps[(0, s)]["loss"] == steps[(1, s)]["loss"] for s in repeated)
    assert all(r["batches_delivered"] == r["step"] for r in steps.values())
    restored = [r for r in records_ if r["event"] == "restored"]
    assert [(r["incarnation"], r["data_state"]) for r in restored] == [
        (1, {"batches_delivered": committed})]
    assert not any(k.startswith("launches_") for k in obs)

    # The sidecar: the gate before the first step, SIGTERM at the end, the
    # upload, exit 0.
    assert sidecar.returncode == 0, out
    assert "terminal phase: Succeeded" in out
    first_step_time = min(r["time"] for r in steps.values())
    assert (sig / "SIGCONT").stat().st_mtime <= first_step_time
    assert (sig / "SIGTERM").exists()
    assert json.loads((store / "observation.json").read_text())["incarnation"] == 1


def test_new_modules_import_no_jax():
    modules = ["kubeflow_tpu_torch.native", "kubeflow_tpu_torch.native.build",
               "kubeflow_tpu_torch.native.dataloader", "kubeflow_tpu_torch.train.records",
               "kubeflow_tpu_torch.sidecar", "kubeflow_tpu_torch.sidecar.controller",
               "kubeflow_tpu_torch.sidecar.__main__", "kubeflow_tpu_torch.controllers.nodehealth",
               "kubeflow_tpu_torch.controllers.__main__",
               "kubeflow_tpu_torch.testing.workers.resnet_records_job"]
    code = ("import sys\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'kubeflow_tpu' or m.startswith('kubeflow_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
