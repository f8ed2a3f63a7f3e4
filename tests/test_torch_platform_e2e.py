"""The port's platform in a box end to end on the CPU: ``python -m
kubeflow_tpu_torch.apps`` (`apps/__main__.py`) as its own process,
driven only through its entry points (HTTP to the dashboard, kfam and
the Jupyter app, the https facade and ``python -m
kubeflow_tpu_torch.cli``), by `testing/platform.run_flow`: a workgroup
registered, an RBAC-bound outsider refused by the mesh gate, a
PodDefault with the facade's env, a notebook spawned and
stopped, a tiny LM TpuJob applied, watched to Succeeded, described and
its logs read, the dashboard's tables, the trace drain, a durable
restart, and nuke-self with the team's service-account token revoked.
The same flow runs on the card at full width in chip_smoke's
`platform` phase. The worker runs on the CPU (``KFTPU_DEVICE=cpu``, one
thread); the platform seeds no Node (``--nodes 0``: this host has no
GPU to advertise), so the one-GPU job places without a cluster model.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

from kubeflow_tpu_torch.testing.platform import run_flow

REPO = Path(__file__).resolve().parents[1]
TINY_LM = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 2, "head_dim": 16,
           "d_ff": 64, "batch": 2, "seq": 32, "dtype": "float32", "lr": 1e-3}
STEPS = 4


def test_platform_flow_on_the_cpu(tmp_path):
    rec = run_flow(
        str(tmp_path / "state"), user="p@example.com",
        env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"},
        nodes=0, timeout=240.0,
        job_env={"KFTPU_CKPT_DIR": str(tmp_path / "ckpt"), "KFTPU_TOTAL_STEPS": str(STEPS),
                 "KFTPU_SAVE_EVERY": str(STEPS), "KFTPU_LM_SIZE": json.dumps(TINY_LM)})
    ns, sa = "team-p", rec["service_account"]
    # 1-2. Boot, workgroup, bindings.
    assert rec["credentials_printed"]
    assert rec["workgroup_create"] == (200, {"success": True, "status": 200, "namespace": ns})
    assert rec["owner_binding"] == ["p@example.com"]
    assert ns in rec["env_info"][1]["namespaces"] and rec["env_info"][1]["isClusterAdmin"]
    assert rec["kfam_binding"][0] == 200
    assert any(b["user"]["name"] == sa for b in rec["kfam_bindings"][1]["bindings"])
    # The mesh gate: RBAC without an AuthorizationPolicy rule is refused.
    status, body = rec["mesh_outsider"]
    assert status == 403 and "mesh policy denies" in body["log"], rec["mesh_outsider"]
    assert rec["mesh_owner"][0] == 200
    # 3-4. The PodDefault's env on the notebook's pod.
    assert rec["poddefault_apply"][0] == 0
    assert "poddefault/facade-env created" in rec["poddefault_apply"][1]
    assert rec["notebook_post"][0] == 200 and rec["notebook_stop"][0] == 200
    assert rec["notebook_pod_env"] == [rec["facade_env"]]
    # 5. The job, on the worker's pod the same env; its steps reported
    # through the facade with the service account's token.
    assert rec["tpujob_apply"][0] == 0 and "tpujob/lm-platform created" in rec["tpujob_apply"][1]
    assert rec["watch_rc"] == 0
    assert rec["job_status"]["phase"] == "Succeeded"
    assert [p["step"] for p in rec["job_status"]["metrics"]] == list(range(1, STEPS + 1))
    assert all(math.isfinite(p["loss"]) for p in rec["job_status"]["metrics"])
    assert rec["worker_pod_env"] == [rec["facade_env"]]
    assert rec["describe"][0] == 0 and "Succeeded" in rec["describe"][1]
    assert rec["logs"][0] == 0
    steps = [json.loads(line) for line in rec["logs"][1].splitlines()
             if line.startswith('{"event": "step"')]
    assert [s["step"] for s in steps] == list(range(1, STEPS + 1))
    assert rec["top"][0] == 0 and "# 0/0 chips reserved across 0 node(s)" in rec["top"][1]
    # The token file is not under the pod-log root.
    assert all(not rec["token_file"].startswith(root) for root in rec["pod_log_root"])
    # 6. The dashboard.
    rows = rec["workloads"][1]
    assert [(r["kind"], r["name"], r["phase"], r["chips"]) for r in rows] == \
        [("TpuJob", "lm-platform", "Succeeded", 1)]
    assert rec["activities"][0] == 200 and rec["activities"][1]
    # 7. The trace drain: the apply, the worker's status writes and the
    # operator's reconciles of the job.
    rc, spans, _ = rec["traces"]
    assert rc == 0
    http = [s["attributes"] for s in spans if s["name"] == "http"]
    assert {"app": "apiserver", "method": "POST", "path": "/apis/TpuJob",
            "status": "201"} in http
    status_writes = [a for a in http if a.get("method") == "PUT"
                     and a.get("path") == f"/apis/TpuJob/{ns}/lm-platform/status"]
    assert len(status_writes) >= STEPS + 1
    assert any(s["name"] == "reconcile" and s["attributes"] == {
        "controller": "tpujob-controller", "key": f"{ns}/lm-platform"} for s in spans)
    # 8. The restart.
    assert rec["stop_rc"] == 0
    assert rec["restart_same_admin_token"]
    assert rec["restart_job_phase"] == "Succeeded" and rec["restart_notebook"] == "nb"
    # 9. Nuke: the namespace's tokens die with it; the admin's does not.
    assert rec["sa_before_nuke"] == "lm-platform"
    assert rec["nuke_self"] == (200, {"success": True, "status": 200, "deleted": [ns]})
    assert "no valid bearer token" in rec["sa_after_nuke"]
    assert ns not in rec["admin_after_nuke"]
    assert not rec["sa_token_in_file"]
    assert rec["final_stop_rc"] == 0
    # Both boots ran every controller on the compiled work queue (no Node
    # here: nothing was placed by a scheduler).
    assert len(rec["planes"]) == 2
    for plane in rec["planes"]:
        assert set(plane["workqueue"].values()) == {"native"}
        assert plane["tpujob_gang_placements_total"]["python"] == 0


def test_the_platform_modules_import_no_jax():
    """The web tier, the CLI and the platform driver import neither JAX
    nor the JAX package (a fresh interpreter, so nothing else has)."""
    code = ("import sys\n"
            "import kubeflow_tpu_torch.apps.__main__, kubeflow_tpu_torch.cli, "
            "kubeflow_tpu_torch.controllers.webhook, kubeflow_tpu_torch.testing.platform\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'kubeflow_tpu' or m.startswith('kubeflow_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_control_plane_processes_load_no_torch():
    """The platform, the controller-manager binary, the facade process,
    the CLI and a load client's wire codec start without importing torch
    (it loads in the workers and the model servers that run on the
    card): their start-up is Python's, not torch's."""
    code = ("import sys\n"
            "import kubeflow_tpu_torch.apps.__main__, kubeflow_tpu_torch.cli, "
            "kubeflow_tpu_torch.controllers.__main__, "
            "kubeflow_tpu_torch.testing.workers.apiserver\n"
            "from kubeflow_tpu_torch.serving import wire\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
