#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Phases, each printed as one
JSON line; any failure raises and the exit code is non-zero:

1. device: the card (nvidia-smi's name and power limit), torch and CUDA.
2. build: every kernel under kubeflow_tpu_torch/ops/csrc, built with
   nvcc for sm_90a (one nvcc per source, all at once, or found built),
   with ptxas's resource report (registers, spills, and the dynamic
   shared memory of every flash_fwd, flash_bwd_dq and flash_bwd_dkv
   instantiation); beside them, while nvcc runs, the compiled
   control-plane tier from kubeflow_tpu_torch/native/csrc with c++
   (libkftpu_core: the work queue, store and WAL; libkftpu_sched: the
   gang scheduler), each library's seconds printed, so every controller
   process and facade finds them built.
3. kernel: flash_fwd against its plain PyTorch version on the card, in
   bf16 and f32, at small, ragged and serving shapes, with the stated
   tolerance; then its time beside the plain version's, one PyTorch
   library call's and the card's bound.
4. bwd_kernel: the backward kernels (flash_delta, flash_bwd_fused,
   flash_bwd_dq, flash_bwd_dkv) against their plain versions at small,
   ragged, training and long shapes in bf16 and f32; then every
   kernel's time at the training shape (B=8, S=2048, H=8, D=128, bf16),
   the compact dq's with its tensor-core instantiation's registers,
   spills and shared memory (ptxas).
5. rect_kernel: the rectangular kernels (flash_fwd_rect,
   flash_bwd_dq_rect, flash_bwd_dkv_rect) against their plain versions
   in bf16 and f32 at (1, 128x128, 2, 64) non-causal, ragged
   (2, 1001 q x 777 k, 4, 128) causal and not, a long key side
   (1, 1024 q x 16384 k, 8, 128) non-causal, and one full ring hop
   (1, 4096x4096, 8, 128) non-causal; then rect_kernel_timing: their
   times at the hop shape beside the plain versions', SDPA's
   (is_causal=False) and the bound.
6. serve, main path 1: the full-width TransformerLM (vocab 32000,
   d_model 1024, 16 layers, 8x128 heads, d_ff 4096, bf16; random
   weights from seed 0) behind Servable -> ModelRepository ->
   ModelServerApp -> HTTP, three :predict requests (JSON and binary
   frame, S=2048 and S=1001). The launch counters are zeroed just
   before the requests and read just after: 16 flash launches per
   forward.
7. check: the served answers against the same module run directly with
   attention through the plain version (bf16, and the same weights in
   f32), with the tolerances stated in `check_phase`.
8. forward: forward time per request shape, the 4 x 2048 bucket with
   the kernel and with the plain version, and a profile of its device
   time by kernel.
9. train, main path 2: the same LM trained as `bench.py --workload lm`
   trains it (remat "none", adamw lr 3e-4, loss-only metrics) on
   SyntheticTokens, batch 8 at S=2048: 2 warm-up steps, then timed
   steps with the launch counters zeroed just before and read just
   after (16 flash_fwd + 16 flash_delta + 16 flash_bwd_fused a step),
   one more step with the two-pass backward pinned
   (KFTPU_FLASH_FUSED_BWD=0: 16 flash_bwd_dq + 16 flash_bwd_dkv), step
   time, tokens/s, MFU and profiles of one step and of one two-pass
   step.
10. train_check: one step's loss and every parameter's gradient on the
   kernel path against the same step with attention through the plain
   versions, in bf16 and in f32, with the tolerances stated in
   `train_check_phase`.
10a. gang_parity, the gang phase's parity: two ranks of one gang
   (TPUJOB_* contract; on one card gloo ranks sharing it) take one f32
   step of the same LM on their rows of train_check's batch at dp = 2
   and at fsdp = 2 (ZeRO-3), each rank's loss and gathered gradients
   held to train_check's one-process f32 step with its f32 limits; per
   rank the step's s, its s in collectives, peak memory, launches
   (`gang_parity_phase`).
11. remat, main path 2a: the train step under every remat policy of the
   JAX model: block policies none, full, mlp, dots, attn and flash, and
   step_remat dots, attn and flash over block "none". Each: one step
   whose loss and global gradient norm are held against "none"'s, then
   timed steps with the counters zeroed just before and read just after
   (16 flash_fwd a step where the backward runs no flash forward, 32
   where it reruns it: full, dots, attn), step time and peak memory.
12. moe_check: one step of the switch-MoE LM (the same widths, 8
   experts, remat "flash") at 2 layers on the kernels against the same
   step on the plain versions, with train_check's bf16 limits.
13. moe_train, main path 2b: that MoE LM at 16 layers (1.17 B params)
   trained with make_train_step at batch 8 x 2048: per step its time,
   loss, load-balancing loss, dropped-token share and launches (16
   flash_fwd, flash_delta and flash_bwd_fused); tokens/s, peak memory.
14. moe_serve, main path 2c: the trained MoE module served over HTTP
   (REQUESTS), each answer bitwise equal to the module's forward on the
   padded batch the server ran, 16 flash_fwd launches a forward; on an
   earlier line (moe_serve_diagnostic) that forward's distance from the
   served answers four ways: on this thread and a second one, each
   under inference_mode (the server's) and no_grad.
15. fit, main path 4: the same LM and stream through the training job's
   entry point, `fit()`, with an AnomalyGuard and the two-pass backward
   pinned: an uninterrupted 4-step run; a run that saves every step into
   a temporary Checkpointer directory (4 kept) and gets a SIGTERM at
   step 1 (`Preempted` at step 2 after its save); a resumed run to step
   4, under the profiler for one step, bitwise equal to the
   uninterrupted one over the same batch positions; then a step poisoned
   with NaN (skipped, nothing moves); the soak's three storage faults
   (`testing/chaos.apply_checkpoint_fault`: a truncated file, flipped
   bytes, a garbled manifest) on steps 4, 3 and 2 in a seeded
   `TrainFaultSchedule`'s order, each quarantined, step 1 restored
   bitwise (the classes, quarantined steps and restored step printed);
   save and restore times, the checkpoint's size and the directory's at
   its peak, and fit()'s step time beside the bare steps'. The
   counters are zeroed before the three fit() runs and read after them
   (16 flash_fwd, flash_delta, flash_bwd_dq and flash_bwd_dkv a step).
16. ring_train, main path 3: the same LM with sequence parallelism, its
   attention on ring flash over an in-process sp ring of 4 on the card,
   batch 1 at S=16384 (chunks of 4096), adamw lr 3e-4: one warm-up
   step, then timed steps with the counters zeroed just before and read
   just after (a step: 16 flash_fwd + 48 flash_fwd_rect + 16
   flash_delta + 16 flash_bwd_fused + 48 flash_bwd_dq_rect + 48
   flash_bwd_dkv_rect), step time, tokens/s, MFU, a profile of one
   step, and the flat LM's step at the same S beside it.
17. ring_check: one ring step's loss and gradients against the flat
   LM's in f32, and against the same ring on the plain versions in
   bf16, with the tolerances stated in `ring_check_phase`.
18. ring_nccl (printed right after gang_parity): the ring over a process
   group against the in-process ring: with two or more cards over NCCL,
   one card each; with one card, gang_parity's two gloo ranks sharing it
   run it (`parallel/distributed.choose_backend`).
19. resnet_check: ResNet-50 at full width in f32 (batch 8 at 224, weights
   from seed 0 with every BatchNorm moved off its init), one training
   forward and backward on the card (TF32 off) and on the CPU in this
   process: logits, loss, every gradient and the updated running
   statistics within the limits stated in `resnet_check_phase`; also the
   bf16 forward's distance from the f32 one.
20. resnet_train, main path 5: ResNet-50 as `bench.py`'s default run
   trains it (batch 256 of bf16 SyntheticImages at 224, SGD-Nesterov lr
   0.4): 3 warm-up steps, 10 timed steps, step time, images/s, MFU,
   peak memory and a profile of one step by group (convs, batch norm,
   elementwise, optimizer). It launches none of the flash kernels.
21. resnet_fit, main path 6: the same model through `fit()` at batch 256
   with an AnomalyGuard and a temporary Checkpointer (cuDNN
   deterministic): SIGTERM at step 1 → `Preempted` at 2, resume to 4
   bitwise equal to an uninterrupted run in parameters, momentum and
   running statistics; then a step whose input is NaN, skipped with all
   three bitwise unchanged; save and restore seconds, checkpoint size.
21a. records_fit, main path 6a: the same model trained from record files
   on disk (`records_fit_phase`): 2560 records (uint8 224x224x3 image,
   int32 label) written from seed 0 by the port's writer, read by its
   compiled loader through `RecordDataset.device_iter()` (pinned host
   buffers, one non-blocking copy a batch, fields split on the card):
   the loader alone (batches/s, MB/s), one batch's pinned copy (ms by
   CUDA events), fit() with an AnomalyGuard and cuDNN deterministic:
   16 straight steps across an epoch, SIGTERM at 10 → `Preempted` at 11,
   a resume whose fast-forward crosses the epoch, bitwise equal to the
   straight run, the position equal to the step at every step, no flash
   launch; then resnet_train's loop on the records beside its synthetic
   step, and a profile of three steps (device time by group, idle share).
22. resnet_serve, main path 7: the model-server binary's app on that
   checkpoint with batching (max_batch 64, 5 ms) over HTTP: the version
   is the checkpoint's step, every answer matches the restored model's
   eval forward (limit in `resnet_serve_phase`); single-instance
   p50/p99, batch-64 predictions/s on the device and host paths, and
   p50/p99 and predictions/s under 64 concurrent one-instance clients
   with batching on and off.
23. controller, main path 9: the serving control plane (`controller_phase`):
   a ServingDeployment CR on that checkpoint directory reconciled by
   the port's ServingDeploymentController into 2 ResNet-50 replicas
   (LocalReplicaRuntime): owned ServingReplica objects, readiness,
   versions and answers; 64 closed-loop clients (p50/p99,
   predictions/s, the device's idle share); a drain-based roll to a
   step that fit() commits, under the same load (one replica at a
   time, no failure); 10 reconciles after a third step without a roll;
   scale 2 -> 3 -> 1 with the weights' memory given back; then 2
   model-server worker processes in replica mode behind the apiserver
   facade (ProcessReplicaRuntime), one SIGKILLed under load and
   respawned, a self-roll on a modelVersion push, and the workers
   reaped when the CR is deleted.
24. rl, main path 10: the actor–learner RL loop (`rl_phase`, `bench.py
   --workload rl` phase A at its configuration: an 8 -> 32 -> 4 policy,
   8 envs x horizon 4, 48 learner steps, a publish every 12, 2 actors):
   a CR "rl-policy" of 2 replicas reconciled through
   `PolicyCheckpointPublisher`, the REINFORCE learner (`loss_in_model`)
   on the card solo and under actor traffic (steps/s and their ratio,
   the device's idle share over 3 s), then `run_actor_learner`: actor
   steps/s, publish-to-actor seconds, each replica rolled once per
   publish, servedVersions [48], nothing lost, a replica's answer
   against the restored policy, the return against a fresh init's; in
   two arms, the policy fleet on the card (the path) and pinned to the
   CPU as the bench pins it; the card's loss and gradients against the
   CPU's, and the live tensors back after the fleets close.
25. frontdoor, main path 8: the multi-model front door (FrontDoorApp →
   Router → 2 MultiModelReplicas, each a ServableRegistry paging at most
   5 models' weights on the card) over HTTP, serving 7 ResNet-50s, each
   restored from its own checkpoint at every page-in, and the LM: each
   model probed and held against its direct forward (the LM's flash
   launches counted), open-loop load at 150 requests/s with one replica
   killed (no acknowledged request lost), page-in seconds, hot and cold
   p99, goodput and the device's idle share, the weights' memory given
   back after the fleet closes and across page cycles
   (`frontdoor_phase`).
26. job, main path 11: the job plane (`job_plane_phases`): the apiserver
   facade over this process's store, the controller-manager binary as
   its own process (``python -m kubeflow_tpu_torch.controllers
   --controllers tpujob,study,workflow,cronworkflow,nodehealth``), the
   local pod runner. A TpuJob "lm-train" (1 worker, 1 GPU, maxRestarts 1) runs the
   same LM through the launcher and fit() in a worker process on the
   default dispatch for 6 steps, saving at the end (the kill, the
   whole-gang restart and the resumed step are path L's): Succeeded,
   restarts 0, the worker's flash launches (16
   flash_fwd, flash_delta and flash_bwd_fused a step); CR to Running,
   spawn to first step, step ms beside the train phase's, wall time,
   peak memory (`job_phase`).
26a. gang, main path 21: the same LM as a two-worker TpuJob "lm-gang"
   (replicas 2, KFTPU_MESH dp = -1, bf16) on the same binary, one model
   over the gang through fit(); rank 1 SIGKILLs itself after step 3,
   once step 2's save is committed, rank 0's collective fails, the
   operator restarts the gang whole and both ranks resume from rank 0's
   step 2: Succeeded, restarts 1, step 3's loss bitwise across the
   incarnations, the ranks' losses equal and within path A's limit of
   its curve, every rank's flash launches; the backend, per-rank step ms,
   ms in collectives, peak memory, the survivor's seconds from the
   kill to its failure (`gang_job_phase`).
27. rl_soak, main path 12: RL's study soak on the same plane
   (`rl_soak_phase`, bench.py's phase B at its configuration): a grid
   Study of 4 trial TpuJobs, 2 at a time, each a worker process with its
   learner and 2-replica policy fleet on the card, under the seeded
   trial, learner and actor kills: Succeeded, 4 scored trials, every
   fault class covered, each trial's restarts as planned;
   rl_studies_per_hour, each trial's seconds and return, the worst
   publish latency, the card's memory with two trials running.
28. pipeline, main path 14: the nightly pipeline on the same plane, the
   binary running the workflow and cronworkflow controllers too
   (`pipeline_phase`): a CronWorkflow "lm-nightly" (``* * * * *``,
   Forbid), created suspended before path A, is unsuspended, fires its
   missed tick at once and is suspended again; its DAG trains the same
   LM as a TpuJob slice step (4 steps, no SIGKILL: path L runs a kill
   and resume on the card, tests/test_torch_pipeline_e2e.py the DAG's),
   evaluates step 4 read-only in a pod (held-out loss against ln(vocab)
   + 1: promote), serves it from a pod over HTTP (REQUESTS, bitwise
   equal to the restored module's forward, version 4) and tears the
   checkpoint directory down in its exit handler: one Workflow, one
   train attempt, no restart, each pod's process gone before the next
   starts, Succeeded; the cron wait, each step's seconds, the eval loss
   beside the fresh init's, serve latencies, each pod's peak
   memory, the card's memory.used at each pod's start, the Workflow's
   seconds; the launches of train, eval and serve.
28a. node_lost, main path 15: a lost Node on the same plane, the binary
   now also running nodehealth (`node_lost_phase`): two one-GPU Nodes;
   ResNet-50 from records_fit's records (written anew) as a TpuJob
   (`testing/workers/resnet_records_job.py`, 8 steps, saving every 4,
   paced at 0.5 s a step) gated by the port's sidecar CLI; once step 6
   is logged and step 4 committed, the worker is SIGKILLed and its Node
   deleted: the pod Failed with reason NodeLost and one event, one
   restart on the surviving Node, resumed from 4 with steps 5 and 6
   bitwise, the position equal to the step on every line, the sidecar's
   SIGCONT before the first step, its pid never on the card, SIGTERM,
   the upload, exit 0; seconds from the loss to the NodeLost write, the
   new pod, the worker's start and its first resumed step; each step's
   loss against records_fit's straight run.
28b. ci_dag, main path 21: the kernel CI DAG on the same plane
   (`ci_dag_phase`), before the binary stops:
   `testing/workflows.sharded_unit_tests_workflow` with two shards of the
   card's kernel tests (tests/test_torch_cuda_kernels.py's
   test_flash_fwd_matches_plain_version and
   test_flash_delta_matches_plain_version, pytest without
   tests/conftest.py), each a pod of `testing/shard_runner`, then the
   collect step's `testing/junit_merge`: the Workflow Succeeded, a junit
   file per shard, junit_merged.xml with tests > 0, failures 0 and errors
   0; the counts and each shard's seconds. Then, after path C, the
   job plane's compiled tier (`tier_phase`, a ``job_plane_tier`` line):
   the binary's and the preempt_ha replica's work queues all compiled,
   and their gang placements (paths E and C) all on the compiled
   scheduler; ha_job, tenant, platform and chaos_job each print such a
   line for their own managers, on a one-GPU Node.
29. preempt, main path 13: the multi-tenant, highly available job plane
   on the same facade and runner (`preempt_phase`): a one-GPU Node and
   two tenants with a ResourceQuota of one GPU each; two operator
   replicas on one Lease (a `testing/workers/preempt_ha.py` leader that
   stalls after a preemption's evictions, the binary with
   ``--leader-elect`` as standby); the LM as TpuJob lm-low (priority 1,
   8 steps), evicted at its step boundary by lm-high (priority 10, 4
   steps) once it has logged step 5; the leader SIGKILLed in the stall,
   the standby taking over and placing lm-high; lm-low resumed from its
   preemption's save after lm-high: one eviction, no lost or repeated
   step, restarts 0, quota usage, each worker's flash launches, the
   card's memory at lm-high's first step; SIGTERM to the victim's exit,
   eviction to lm-high's first step, kill to the standby's first write,
   lm-high's end to lm-low's first resumed step.
30. ha_job, main path 16: the durable, highly available control plane
   (`ha_job_phase`): the LM as a TpuJob on an active-passive facade pair
   over one WAL-backed store, over https, the binary leader-elected on
   the endpoint list; the active facade SIGKILLed after step 4's ack;
   no restart, every acked step in a fresh store over the state
   directory, the losses against path A's; both facades on the compiled
   WAL, ``wal.log`` on a new inode after the standby's takeover (the
   inodes before and after printed).
31. tenant, main path 17: tenants (`tenant_phase`): a job plane on a
   durable store, the binary running the profile, notebook, tensorboard
   and tpujob controllers, the workload materializer beside the pod
   runner; Profile team-c provisioned (its Namespace, ServiceAccounts,
   RoleBinding, AuthorizationPolicy, a one-GPU ResourceQuota, the
   finalizer), Profile team-x refused a namespace it does not own; the
   LM as TpuJob lm-tenant in team-c (two steps traced), a Notebook
   started and stopped and a Tensorboard on the trace directory's claim;
   the Profile deleted after step 3's ack: team-c drained in memory and
   on disk, the worker SIGTERMed to its exit, the card's memory back,
   no pod back in 5 s; seconds for each.
32. platform, main path 18: the platform in a box (`platform_phase`):
   ``python -m kubeflow_tpu_torch.apps`` as its own process, driven only
   through the dashboard, kfam, the Jupyter app, the https facade and
   the `kftpu` CLI: a workgroup registered, an RBAC-bound outsider
   refused by the mesh gate (403), a PodDefault with the
   facade's env and a team service-account token, a notebook spawned
   and stopped, the LM as TpuJob lm-platform (4 steps) applied and
   watched to Succeeded, described, its logs and `top`, the dashboard's
   tables, the trace drain, a durable restart, nuke-self with the
   token revoked (401); seconds for each.
33. chaos_job, main path 19: the control plane's wire under faults
   (`chaos_job_phase`): the facade process behind a seeded `ChaosProxy`
   (seed 0, two faults of each of the seven wire classes), the binary,
   the pod runner and the worker on the proxy; the LM as TpuJob lm-chaos
   (4 steps) beside a Notebook applied at v1alpha1 and read back at
   every served version; every class fired, no duplicate side effect,
   the binary's watch degraded to long-poll and streamed again; seconds
   for each, the faults by class, long-poll rounds, degraded seconds.
34. deploy, main path 20: deploying the platform (`deploy_phase`), no
   work on the card: ``python -m kubeflow_tpu_torch.deploy serve
   --worker-mode process`` as its own process, a platform created over
   its HTTP API with one GPU pool sized from the card (nvidia-smi's name
   through the GPU table, one GPU on one host), its worker SIGKILLed
   mid-apply (the pool's Node written, no bundle object yet),
   respawned, the phase Ready with KfAvailable, the same Node and every
   bundle object; one
   `DeployProber` round; ``deploy apply --dry-run`` with provider gke
   printing an a3-highgpu-1g pool with one nvidia-h100-80gb; no deploy
   process loads torch; the phase within 15 s.
35. kernels: one line per ported kernel (launches, error, times, bound).
36. the last line: {"ok": true, "device": {...}}.

Without a GPU, or outside a checkout (copied alone, where
`kubeflow_tpu_torch` does not import), it says why on stderr and exits
non-zero before printing any result.

    python3 chip_smoke.py --loss-seeds N

runs only the device and build phases, then train_check and ring_check
for the seeds 0..N-1 of weights and tokens without failing on them, and
prints each seed's bf16 loss statistics: the readings `LOSS_Z` is set
from.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import weakref

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SEED = 0
DEVICE = "cuda"
KERNEL_SHAPES = [  # (B, S, H, D)
    (1, 128, 2, 64),
    (2, 1000, 4, 128),  # tiles into 8-row blocks without padding
    (2, 1001, 4, 128),  # ragged: the plain version pads to 1024
    (4, 2048, 8, 128),  # the serving shape
]
MAIN_SHAPE = KERNEL_SHAPES[-1]
BWD_SHAPES = [  # (B, S, H, D)
    (1, 128, 2, 64),
    (2, 1001, 4, 128),  # ragged: the plain versions pad to 1024
    (8, 2048, 8, 128),  # the training shape
    (1, 16384, 8, 128),  # long context
]
TRAIN_SHAPE = BWD_SHAPES[2]
# Tolerances, as in numpy's allclose: |kernel - plain| <= atol + rtol*|plain|.
# f32: the reference's own flash-vs-dense gate (tests/test_flash_schedule.py,
# atol = rtol = 5e-5); kernel and plain version sum in other orders.
# bf16 outputs: both round one float32 result to bf16, so where the two f32
# results straddle a rounding boundary they differ by one bf16 ulp, at most
# 2^-7 of the value. The lse is float32 in both dtypes.
TOL = {
    "float32": {"o": (5e-5, 5e-5), "lse": (5e-5, 5e-5)},
    "bfloat16": {"o": (1e-5, 2.0 ** -7), "lse": (5e-5, 5e-5)},
}
# Backward kernels, as in tests/test_torch_cuda_kernels.py: gradients
# grow with S, so atol is JAX's 5e-5 grad gate relative to the plain
# result's RMS; rtol 5e-5 in f32 (sums in another order), 2^-7 on bf16
# outputs (one rounding of the same float32 value). delta is float32 in
# both dtypes.
BWD_RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
BWD_ATOL_PER_RMS = 5e-5
LM = dict(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
          head_dim=128, d_ff=4096)
TRAIN = dict(batch=8, seq=2048, lr=3e-4, warmup_steps=2, timed_steps=5)
# Sequence parallelism: the same LM on an in-process sp ring of 4 at
# S = 16384 (chunks of 4096), batch 1: the 16384 tokens a step of TRAIN.
RING = dict(sp=4, batch=1, seq=16384, lr=3e-4, warmup_steps=1, timed_steps=3)
# The bf16 checks' mean-loss limit (`bf16_loss_ok`), in standard errors of
# the per-token loss differences. Set from the readings of
# `chip_smoke.py --loss-seeds 8` over 8 seeds of weights and tokens
# (PERF.md, section 6).
LOSS_Z = 5.0
# remat: the train phase's LM, batch and optimizer under every remat
# policy of the JAX model (kubeflow_tpu/models/transformer.py:106-168):
# each block policy with no step checkpoint, then each selective
# step_remat over block "none" (kubeflow_tpu/train/trainer.py:443-449).
# Each: a first step, held against "none"'s (loss and global gradient
# norm), then `steps` timed steps.
REMAT = dict(block=("none", "full", "mlp", "dots", "attn", "flash"),
             step=("dots", "attn", "flash"), steps=1)
# moe: the same widths with 8 switch experts, JAX's defaults for the
# capacity factor and the load-balancing loss, remat "flash", batch
# 8 x 2048 (groups of 4096 tokens, capacity 640): `steps` guarded train
# steps (the first a warm-up), a check of one step at `check_layers` layers on
# the kernels against the plain versions, and REQUESTS served from the
# trained module at `max_batch`.
MOE = dict(num_experts=8, capacity_factor=1.25, aux_loss_coef=0.01, remat="flash",
           steps=6, check_layers=2, max_batch=4)
# fit(): 4 steps of TRAIN's LM and stream with a SIGTERM raised at step 1
# in the preempted run; every step saved and four kept, so the storage
# faults damage the newest three and the restore lands on the fourth. The
# classes come in the order TrainFaultSchedule(fault_seed, 32,
# save_interval=4) draws them.
FIT = dict(steps=4, save_every=1, sigterm_at=1, keep=4, fault_seed=0)
RECT_SHAPES = [  # (B, S_q, S_k, H, D, causal)
    (1, 128, 128, 2, 64, False),
    (2, 1001, 777, 4, 128, False),  # ragged: the plain versions pad
    (2, 1001, 777, 4, 128, True),  # top-left causal mask, s_q > s_k
    (1, 1024, 16384, 8, 128, False),  # dq sums over 16384 keys
    (1, 4096, 4096, 8, 128, False),  # one full hop of RING
]
HOP_SHAPE = RECT_SHAPES[-1]
KERNEL_ROWS = {  # name → (CUDA source, the TPU kernel it replaces)
    "flash_fwd": ("flash_fwd.cu", "kubeflow_tpu/ops/flash.py:533 (_fwd_kernel_compact)"),
    "flash_fwd_rect": ("flash_fwd.cu", "kubeflow_tpu/ops/flash.py:515 (_fwd_kernel)"),
    "flash_delta": ("flash_delta.cu", "kubeflow_tpu/ops/flash.py:549 (_delta_kernel)"),
    "flash_bwd_fused": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:714 (_dqkv_kernel_fused)"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "kubeflow_tpu/ops/flash.py:618 (_dq_kernel_compact)"),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:696 (_dkv_kernel_compact)"),
    "flash_bwd_dq_rect": ("flash_bwd_dq.cu", "kubeflow_tpu/ops/flash.py:602 (_dq_kernel)"),
    "flash_bwd_dkv_rect": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:679 (_dkv_kernel)"),
}
RECT_KERNELS = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")
# ResNet-50 as bench.py trains it (bench.py:335-388): batch 256 per chip
# at 224x224, bf16 images, SGD lr 0.4.
RESNET = dict(batch=256, image=224, classes=1000, lr=0.4, warmup_steps=3,
              timed_steps=10)
# resnet_check: one f32 step at batch 8, on the card and on the CPU.
RESNET_CHECK = dict(batch=8)
# resnet_fit: fit() at batch 256, 4 steps, saving every 2, SIGTERM at 1.
RESNET_FIT = dict(batch=256, steps=4, save_every=2, sigterm_at=1)
# Training from record files (records_fit; node_lost reads the same file):
# `records` records of a uint8 RESNET["image"]^2 x 3 image and an int32
# label, written from SEED (10 batches of 256, 385 MB), read with a
# buffered shuffle over the whole file and no epoch limit. records_fit:
# the loader alone over `loader_batches`, fit() for `steps` (SIGTERM at
# `sigterm_at`, saves every `save_every`; the resume's fast-forward
# crosses the first epoch's end), then resnet_train's timed loop on the
# records and a profile of `profiled_steps` steps.
RECORDS = dict(records=2560, batch=256, shuffle_buffer=2560, loader_batches=20, steps=16,
               save_every=4, sigterm_at=10, warmup_steps=3, timed_steps=10,
               profiled_steps=3)
# node_lost (path E): ResNet-50 from those records as a TpuJob on two
# one-GPU Nodes, its host lost once step `lose_after` is logged and the
# step-`save_every` save is committed; steps paced by `step_sleep_s`; the
# sidecar polls every `poll_s`. Waits in seconds.
NODE_LOST = dict(model="resnet50", steps=8, save_every=4, lose_after=6, max_restarts=1,
                 step_sleep_s=0.5, poll_s=0.5, timeout_s=300, sidecar_exit_s=60)
# resnet_serve: bench.py --workload serving's max_batch and repetitions
# (bench.py:419-450), the binary's batching at 5 ms, 64 concurrent
# one-instance clients over 64 distinct instances, each posting in a loop
# through a warm-up, a measured window and a profiled window (seconds).
RESNET_SERVE = dict(max_batch=64, timeout_ms=5.0, single=60, device_reps=30,
                    host_reps=5, clients=64, distinct=64, warmup_s=0.5, window_s=2.0,
                    profile_s=1.0)
# frontdoor: bench.py's multiplex phase (bench.py:1057-1240) on the card:
# 7 ResNet-50s and the LM behind 2 replicas of at most 5 resident models
# each, batching 64 / 5 ms as the binary; open-loop load at 150
# requests/s (about half of what one batched ModelServerApp sustained
# under 64 clients in resnet_serve), resnet-0..3 hot (weight 4), the
# rest cold (1); a 2 s warm-up, an 8 s measured run, 2 s of it profiled;
# page cycles at 2 resident; memory held within 64 MiB.
# Each load worker keeps up to 256 requests in flight (bench.py's 64 is
# sized for tiny models): a cold request waits out a page-in of seconds,
# and a worker out of slots fires late, which is a closed loop.
FRONTDOOR = dict(resnets=7, hot=4, replicas=2, max_resident=5, max_batch=64,
                 timeout_ms=5.0, lm_max_batch=4, rate=150.0, warmup_s=2.0,
                 window_s=8.0, workers=4, concurrency=256, profile_s=2.0,
                 cycle_resident=2, memory_slack_mib=64)
# controller: bench.py's serving data plane (bench.py:727-1050) through
# the control plane at full width: a ServingDeployment on resnet_fit's
# checkpoint directory, 2 replicas, batching 64 / 5 ms; 64 closed-loop
# one-instance clients over 64 distinct instances (a 0.5 s warm-up, a 2 s
# measured window, all of it profiled); a roll under the same load that
# must converge within 120 s; 10 reconciles after a third step; scale
# 2 -> 3 -> 1; then 2 worker processes behind the facade, each serving
# within 120 s, 16 closed-loop clients for 2 s with one worker SIGKILLed;
# memory held within 64 MiB.
CONTROLLER = dict(replicas=2, max_batch=64, timeout_ms=5.0, clients=64, distinct=64,
                  warmup_s=0.5, window_s=2.0, profile_s=2.0, roll_timeout_s=120.0,
                  fault_reconciles=10, scale=(3, 1), workers=2, worker_start_s=120.0,
                  process_clients=16, process_load_s=2.0, process_compare_s=2.0,
                  memory_slack_mib=64)
# rl: bench.py --workload rl's phase A (bench.py:2137-2146, :2186-2190,
# :244-249): an 8 -> 32 -> 4 policy, 8 envs x horizon 4, 48 learner steps
# at lr 0.05 (3 warm-up steps before the solo and loaded timings), a
# publish every 12, 2 actors, replay capacity 8; 2 replicas batching
# 8 / 1 ms; a 3 s profiled window. The last 20 trajectories' mean return
# (of 4, the horizon) must beat the fresh init's by `margin`: on the CPU
# over seeds 0-4 the gap read 1.26-1.85 (tools/rl_margin.py), and the
# fresh init's return moves by about 0.1 between index sets. A replica's
# answer within f32 1e-6 of the restored policy's forward; the card's
# loss and gradients within 1e-5 of the CPU's.
RL = dict(obs_dim=8, n_actions=4, n_envs=8, horizon=4, hidden=32, steps=48,
          publish_every=12, actors=2, capacity=8, lr=0.05, replicas=2, max_batch=8,
          timeout_ms=1.0, warmup_steps=3, timed_steps=max(10, 48), profile_s=3.0,
          last=20, margin=0.5, answer_tol=1e-6, grad_tol=1e-5,
          stall_timeout_s=120.0, memory_slack_mib=64)
# The job plane (path A): TpuJob "lm-train" of one worker running TRAIN's
# LM through fit() (fused backward) for 6 steps, saving at the end (path
# L's gang carries the kill and the resume). Waits in seconds.
JOB = dict(steps=6, save_every=6, max_restarts=1, timeout_s=600, manager_ready_s=120)
# Priority preemption under leader election (path C): lm-low (team-a,
# priority 1, 8 steps; 10 until PR 22) runs until step 5 (6 until PR 22),
# then lm-high (team-b, priority 10, 4 steps; 6 until PR 22) evicts it on
# the one-GPU cluster model (the PR 22 cut, two fewer 3.0 GB saves,
# paying for path K); the leader, a
# preempt_ha replica, stalls 6 s after the eviction and is SIGKILLed in
# it; the standby binary takes the Lease (2 s, renew deadline 1.2 s,
# polls every 0.25 s as the JAX e2e's) and places lm-high; lm-low resumes
# after it. Waits in seconds; the memory slack is this gate's 2 GiB.
PREEMPT = dict(low_steps=8, high_steps=4, save_every=4, submit_at=5, lease_s=2.0,
               renew_s=1.2, retry_s=0.25, stall_s=6.0, timeout_s=480, manager_ready_s=120,
               memory_slack_mib=2048)
# RL's study soak (path B): bench.py's nightly configuration
# (tests/e2e/test_rl_soak_e2e.py:158-171): seed 7, 4 grid trials over lr
# in [0.02, 0.08], 18 learner steps, a publish every 6.
RL_SOAK = dict(seed=7, trials=4, steps=18, publish_every=6, deadline_s=420)
# The nightly pipeline (path D): a CronWorkflow ("* * * * *", Forbid)
# whose Workflow trains TRAIN's LM as a TpuJob slice step for `steps`
# with no kill (path L runs a kill and resume on the card, and
# tests/test_torch_pipeline_e2e.py the DAG's through a kill), evaluates
# the newest step and serves it when its held-out loss is at most
# ln(vocab) + 1 (uniform tokens: a trained loss stays near ln(vocab)). The
# CronWorkflow is created suspended before path A, so its anchor is
# minutes old when the pipeline unsuspends it and the missed tick fires
# at once, where a CronWorkflow created in the phase would wait 5-60 s
# for the next minute boundary.
PIPELINE = dict(steps=4, save_every=4, max_eval_loss=math.log(32000) + 1.0,
                cron_wait_s=61.0, spawn_timeout_s=75, timeout_s=480)
# The durable, highly available control plane (path F): TpuJob "lm-ha" of
# one worker running TRAIN's LM through fit() for `steps` on an HA job
# plane (two facade processes over one WAL-backed store, https, the
# apiserver lease 3 s with a 2 s renew deadline); the binary runs
# the tpujob controller leader-elected (its Lease renewals, every
# `manager_retry_s`, are its steady writes); the active facade is
# SIGKILLed once the worker's step `kill_after` is acked. Waits in
# seconds.
HA_JOB = dict(steps=6, kill_after=4, manager_lease_s=15.0,
              manager_renew_s=10.0, manager_retry_s=0.5, probe_every_s=0.2, timeout_s=300,
              manager_ready_s=120)
# The tenant lifecycle (path G): Profile "team-c" (owner c@example.com,
# `hard` as its ResourceQuota) provisions its namespace; Profile "team-x"
# meets a namespace of that name it does not own; TpuJob "lm-tenant"
# trains TRAIN's LM in team-c for `steps` (a save every `save_every`:
# none before the drain, whose SIGTERM saves at the next step boundary;
# the second and third steps traced under the checkpoint root's
# traces/), beside Notebook "nb" (stopped once ready) and Tensorboard
# "tb" on claim lm-ckpt's traces/; once step `drain_after` is acked the
# Profile is deleted and team-c drained; then `quiet_s` of watching that
# nothing comes back. Waits in seconds; the memory slack in MiB.
TENANT = dict(steps=8, save_every=8, drain_after=3, owner="c@example.com",
              hard={"nvidia.com/gpu": 1, "pods": 8, "persistentvolumeclaims": 2},
              quiet_s=5.0, memory_slack_mib=64, ready_timeout_s=60, timeout_s=300,
              drain_timeout_s=120, manager_ready_s=120)
PLATFORM = dict(steps=4, user="p@example.com", namespace="team-p", job="lm-platform",
                timeout_s=300)
# The control plane's wire under faults (path I): the facade process
# behind a ChaosProxy running FaultSchedule(seed, faults_per_class) over
# the seven wire fault classes; TRAIN's LM as TpuJob "lm-chaos" for
# `steps` steps (one save, at the end) beside a Notebook applied at
# v1alpha1. Waits in seconds.
CHAOS_JOB = dict(seed=0, faults_per_class=2, steps=4, timeout_s=300, manager_ready_s=120)
# The deploy phase: each worker holds apply_delay_s between its PLATFORM
# and K8S phases (the worker's KFTPU_WORKER_APPLY_DELAY), and the first
# is SIGKILLed in that hold; the phase must end within limit_s.
DEPLOY = dict(apply_delay_s=1.5, ready_timeout_s=12.0, limit_s=15.0)
# The compiled control-plane tier the build phase builds (`native/build.py`).
# The gang phase: two ranks of one gang (gloo with CUDA tensors on one
# card, NCCL with a card each): (a) one f32 step of the full-width LM at
# each mesh, held to the one-process step (train_check's f32 limits);
# (b) the LM as a two-worker TpuJob (dp = -1, bf16) through fit(), rank
# 1 SIGKILLed after step kill_at once the save before it is committed,
# the gang restarted whole.
GANG = dict(ranks=2, meshes={"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}}, parity_timeout_s=300,
            steps=4, save_every=2, kill_at=3, kill_rank=1, max_restarts=1, timeout_s=480)
NATIVE_LIBRARIES = ("kftpu_core", "kftpu_sched")
# The kernel CI DAG (path K): `sharded_unit_tests_workflow` over these
# shards of the card's kernel tests, each shard's pytest without
# tests/conftest.py (it imports JAX); waits in seconds.
CI_DAG = dict(shards=("tests/test_torch_cuda_kernels.py::test_flash_fwd_matches_plain_version",
                      "tests/test_torch_cuda_kernels.py::test_flash_delta_matches_plain_version"),
              pytest_args="-q --noconftest -p no:cacheprovider", timeout_s=300)
REQUESTS = [  # (wire format, batch, sequence length)
    ("json", 1, 2048),
    ("json", 3, 2048),  # padded to bucket 4
    ("binary", 2, 1001),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(a, b, atol: float, rtol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def device_phase(torch, bytecode: dict) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "bytecode_cache": bytecode,
    }
    emit(info)
    return info


def ptxas_report(log: str, smem=None) -> list[str]:
    """One line per compiled kernel: its (mangled) name, registers, static
    shared memory and spills, from nvcc -Xptxas -v, and any ptxas warning
    (a serialised wgmma pipeline shows there). `smem(name)` adds the
    kernel's dynamic shared memory where it gives one."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            dynamic = smem(name) if smem else None
            extra = f"; {dynamic} bytes dynamic smem" if dynamic else ""
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}{extra}")
            name = None
        elif "warning" in line.lower():
            out.append(line.strip())
    return out


def kernel_smem(name: str):
    """The dynamic shared memory of a flash_fwd, flash_bwd_dq or
    flash_bwd_dkv instantiation (tensor-core bf16 body or CUDA-core body,
    read from its mangled template arguments), from the library itself."""
    import re

    from kubeflow_tpu_torch.ops import _kernels

    fwd = re.search(r"flash_fwd_(tc|simt)ILi(\d+)E", name)
    if fwd is not None:
        dtype = 1 if fwd.group(1) == "tc" else 0
        return _kernels.library("flash_fwd").kftpu_flash_fwd_smem_bytes(int(fwd.group(2)), dtype)
    dq = re.search(r"flash_bwd_dq_(tc|simt)I(?:(13__nv_bfloat16|f))?Li(\d+)E", name)
    if dq is not None:
        tensor_cores = dq.group(1) == "tc"
        dtype = 1 if tensor_cores or dq.group(2) != "f" else 0
        return _kernels.library("flash_bwd_dq").kftpu_flash_bwd_dq_smem_bytes(
            int(dq.group(3)), dtype, int(tensor_cores))
    bwd = _kernels.library("flash_bwd_dkv").kftpu_flash_bwd_dkv_smem_bytes
    tc = re.search(r"flash_bwd_tcILi(\d+)ELb[01]ELb[01]ELb([01])E", name)
    if tc is not None:
        return bwd(int(tc.group(1)), 1, 1, int(tc.group(2)))
    simt = re.search(r"flash_bwd_dkv_kernelIfLi(\d+)ELb[01]ELb[01]ELb([01])E", name)
    if simt is not None:
        return bwd(int(simt.group(1)), 0, 0, int(simt.group(2)))
    return None


def build_native(name: str) -> dict:
    """Builds one of the port's host libraries (`native/build.py`)."""
    from kubeflow_tpu_torch.native import build

    cached = build.target(name).exists()
    t0 = time.perf_counter()
    path = build.build(name)
    return {"library": os.path.basename(path), "cached": cached,
            "seconds": time.perf_counter() - t0}


def build_phase() -> list[str]:
    """Builds the kernels, and beside them (one thread, while nvcc runs)
    the compiled control-plane tier, libkftpu_core then libkftpu_sched,
    so the binary and the facade processes find them built; returns
    ptxas's lines of every source."""
    from concurrent.futures import ThreadPoolExecutor

    from kubeflow_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(lambda: {name: build_native(name) for name in NATIVE_LIBRARIES})
        built = _kernels.build()
        native = native.result()
    kernels = {
        name: {
            "cached": b["cached"],
            "seconds": round(b["seconds"], 3),
            "ptxas": ptxas_report(b["ptxas"], kernel_smem),
        }
        for name, b in built.items()
    }
    emit({"phase": "build", "kernels": kernels, "native": native,
          "seconds": time.perf_counter() - t0})
    return [line for k in kernels.values() for line in k["ptxas"]]


def instantiation(ptxas: list[str], mangled: str) -> dict:
    """Registers, spill bytes and dynamic shared memory of the kernel
    instantiation whose mangled name holds `mangled`, from ptxas's line."""
    import re

    line = next((x for x in ptxas if mangled in x.split(":", 1)[0]), None)
    if line is None:
        raise AssertionError(f"no ptxas line for {mangled}")
    num = lambda pattern: int(re.search(pattern, line).group(1))
    return {"kernel": line.split(":", 1)[0], "registers": num(r"Used (\d+) registers"),
            "spill_store_bytes": num(r"(\d+) bytes spill stores"),
            "spill_load_bytes": num(r"(\d+) bytes spill loads"),
            "dynamic_smem_bytes": num(r"(\d+) bytes dynamic smem")}


def kernel_phase(torch) -> dict:
    """flash_fwd vs flash_attention_reference on the card; returns the
    kernel's entry for the kernels line (launches filled in later)."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    failures, max_err = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, s, h, d in KERNEL_SHAPES:
            q, k, v = (
                torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
                for _ in range(3)
            )
            o, lse = flash.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash.flash_attention_reference(q, k, v)
            o, ro = o.float(), ro.float()
            err_o = (o - ro).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            ok = (
                close(o, ro, *TOL[dname]["o"])
                and close(lse, rlse, *TOL[dname]["lse"])
                and bool(torch.isfinite(o).all())
            )
            if dtype == torch.bfloat16:
                max_err = max(max_err, err_o)
            emit({
                "phase": "kernel", "kernel": "flash_fwd", "dtype": dname,
                "shape_bshd": [b, s, h, d], "max_abs_err_o": err_o,
                "max_abs_err_lse": err_lse,
                "tol_o_atol_rtol": TOL[dname]["o"],
                "tol_lse_atol_rtol": TOL[dname]["lse"], "ok": ok,
            })
            if not ok:
                failures.append((dname, (b, s, h, d)))
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version: {failures}")

    b, s, h, d = MAIN_SHAPE
    q, k, v = (
        torch.randn(b * h, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
        for _ in range(3)
    )
    kernel_ms = cuda_ms(torch, lambda: flash.flash_fwd(q, k, v), iters=20)
    plain_ms = cuda_ms(
        torch, lambda: flash.flash_attention_reference(q, k, v), iters=3, warmup=1
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    library_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), iters=20)
    # The work the function needs: q.k and p.v over the causal triangle,
    # q/k/v read once, o and the f32 lse written once.
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    nbytes = 4 * b * h * s * d * q.element_size() + b * h * s * 4
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash.py:533 (_fwd_kernel_compact)",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
        "shape_bshd": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "bound_share": max(t_ops, t_bytes) / kernel_ms,
    }
    emit({"phase": "kernel_timing", **entry})
    return entry


def bwd_close(got, want, dtype: str):
    """(ok, max |got - want|, atol, rtol) under the BWD_* tolerances."""
    want = want.float()
    atol = BWD_ATOL_PER_RMS * want.pow(2).mean().sqrt().item()
    rtol = BWD_RTOL[dtype]
    err = (got.float() - want).abs().max().item()
    return close(got.float(), want, atol, rtol), err, atol, rtol


def bwd_kernel_phase(torch, card: str, ptxas: list[str]) -> dict:
    """The backward kernels against their plain versions on the card at
    BWD_SHAPES in bf16 and f32 (each on the same inputs: the kernel
    forward's o and lse, the kernel delta), then all five kernels' times
    at the training shape, the compact dq's with its tensor-core
    instantiation (registers, spills, shared memory from ptxas). Returns
    the entries of the kernels line."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    failures = []
    max_err = dict.fromkeys(KERNEL_ROWS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, s, h, d in BWD_SHAPES:
            q, k, v, do = (
                torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
                for _ in range(4)
            )
            o, lse = flash.flash_fwd(q, k, v)
            delta = flash.flash_delta(o, do)
            fused = flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=True)
            two = flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=False)
            torch.cuda.synchronize()
            checks = {"flash_delta": [bwd_close(delta, flash.flash_delta_reference(o, do), "float32")]}
            plain = flash.flash_bwd_fused_reference(q, k, v, do, lse, delta)
            checks["flash_bwd_fused"] = [bwd_close(g, w, dname) for g, w in zip(fused, plain)]
            plain = flash.flash_bwd_reference(q, k, v, do, lse, delta)
            checks["flash_bwd_dq"] = [bwd_close(two[0], plain[0], dname)]
            checks["flash_bwd_dkv"] = [bwd_close(g, w, dname) for g, w in zip(two[1:], plain[1:])]
            del plain
            for name, results in checks.items():
                ok = all(r[0] for r in results) and all(
                    bool(torch.isfinite(t).all()) for t in (delta, *fused, *two)
                )
                err = max(r[1] for r in results)
                if dtype == torch.bfloat16:
                    max_err[name] = max(max_err[name], err)
                emit({
                    "phase": "bwd_kernel", "kernel": name, "dtype": dname,
                    "shape_bshd": [b, s, h, d], "max_abs_err": err,
                    "tol_atol_rtol": [[r[2], r[3]] for r in results], "ok": ok,
                })
                if not ok:
                    failures.append((name, dname, (b, s, h, d)))
    if failures:
        raise AssertionError(f"backward kernels disagree with their plain versions: {failures}")

    # Times at the training shape, bf16.
    b, s, h, d = TRAIN_SHAPE
    bh, n = b * h, b * h * s * d
    q, k, v, do = (
        torch.randn(bh, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
        for _ in range(4)
    )
    o, lse = flash.flash_fwd(q, k, v)
    delta = flash.flash_delta(o, do)
    bwd = lambda fused: flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=fused)
    kernel_ms = {
        "flash_fwd": cuda_ms(torch, lambda: flash.flash_fwd(q, k, v), iters=10),
        "flash_delta": cuda_ms(torch, lambda: flash.flash_delta(o, do), iters=20),
        "flash_bwd_fused": cuda_ms(torch, lambda: bwd(True), iters=5),
    }
    kernel_ms["flash_bwd_dq"] = cuda_ms(
        torch, lambda: flash._flash_bwd_dq_cuda(q, k, v, do, lse, delta), iters=5)
    kernel_ms["flash_bwd_dkv"] = cuda_ms(
        torch, lambda: flash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta), iters=5)
    two_pass_ref = cuda_ms(torch, lambda: flash.flash_bwd_reference(
        q, k, v, do, lse, delta), iters=2, warmup=1)
    plain_ms = {
        "flash_fwd": cuda_ms(torch, lambda: flash.flash_attention_reference(q, k, v), iters=2, warmup=1),
        "flash_delta": cuda_ms(torch, lambda: flash.flash_delta_reference(o, do), iters=10),
        "flash_bwd_fused": cuda_ms(torch, lambda: flash.flash_bwd_fused_reference(
            q, k, v, do, lse, delta), iters=2, warmup=1),
        "flash_bwd_dq": two_pass_ref,
        "flash_bwd_dkv": two_pass_ref,
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, s, d).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, s, d)
    sdpa_fwd = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), iters=20)
    sdpa_both = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True).backward(do4), iters=20
    )
    sdpa_bwd = sdpa_both - sdpa_fwd
    library = {
        "flash_fwd": (sdpa_fwd, "scaled_dot_product_attention(is_causal=True), forward"),
        "flash_delta": (None, "no single PyTorch call computes delta alone; SDPA's "
                        "backward includes it (see flash_bwd_fused)"),
        **{name: (sdpa_bwd, "backward of scaled_dot_product_attention(is_causal=True), "
                  "timed as forward+backward minus forward; it covers delta plus "
                  "dq, dk and dv together") for name in
           ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")},
    }
    # The work each function needs at this shape: FLOP per causal pair per
    # head dim (q.k and p.v forward: 4; dq pass: 6; dk/dv pass: 8; fused:
    # 10), each input read once, each output written once.
    pairs = bh * d * (s * (s + 1) / 2)
    el = q.element_size()
    rows = bh * s * 4  # one float32 per row: lse or delta
    work = {
        "flash_fwd": (4 * pairs, 3 * n * el + n * el + rows),
        "flash_delta": (2.0 * n, 2 * n * el + rows),
        "flash_bwd_fused": (10 * pairs, 4 * n * el + 2 * rows + 3 * n * el),
        "flash_bwd_dq": (6 * pairs, 4 * n * el + 2 * rows + n * el),
        "flash_bwd_dkv": (8 * pairs, 4 * n * el + 2 * rows + 2 * n * el),
    }
    entries = {}
    for name, (src, replaces) in KERNEL_ROWS.items():
        if name in RECT_KERNELS:
            continue
        flops, nbytes = work[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib_ms, lib_note = library[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_err[name], "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library": lib_note,
            "shape_bshd": list(TRAIN_SHAPE), "dtype": "bfloat16",
            "achieved_tflops": flops / (kernel_ms[name] * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / kernel_ms[name],
            "over_library": kernel_ms[name] / lib_ms if lib_ms else None,
            "card": card,
        }
        if name == "flash_bwd_dq":  # the bf16 D = 128 compact instantiation
            entries[name]["instantiation"] = instantiation(
                ptxas, "flash_bwd_dq_tcILi128ELb0ELb1E")
        emit({"phase": "bwd_kernel_timing", **entries[name]})
    return entries


def unmasked_pairs(causal: bool, sq: int, sk: int) -> int:
    """(query, key) pairs the rectangular grid computes: all of them, or
    those with q_pos >= k_pos (the top-left causal mask)."""
    if not causal:
        return sq * sk
    full = max(0, sq - sk)  # rows that see every key
    diag = min(sq, sk)  # rows 0..diag-1 see keys 0..row
    return diag * (diag + 1) // 2 + full * sk


def rect_kernel_phase(torch, card: str) -> dict:
    """The rectangular kernels (flash_fwd_rect, flash_bwd_dq_rect,
    flash_bwd_dkv_rect) against their plain versions at RECT_SHAPES in
    bf16 and f32, each on the same inputs (the kernel forward's o and
    lse, the kernel delta), with the forward's and the backward's
    tolerances; then, at the hop shape, their times beside the plain
    versions', SDPA's (is_causal=False) and the bound. Returns the
    entries of the kernels line."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    failures, max_err = [], dict.fromkeys(RECT_KERNELS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, sq, sk, h, d, causal in RECT_SHAPES:
            draw = lambda s: torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
            q, k, v, do = draw(sq), draw(sk), draw(sk), draw(sq)
            o, lse = flash.flash_fwd(q, k, v, causal=causal)
            delta = flash.flash_delta(o, do)
            dq, dk, dv = flash.flash_bwd_kernels(q, k, v, do, lse, delta, causal=causal)
            torch.cuda.synchronize()
            ro, rlse = flash.flash_attention_reference(q, k, v, causal=causal)
            plain = flash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal)
            checks = {
                "flash_fwd_rect": [
                    (close(o.float(), ro.float(), *TOL[dname]["o"]),
                     (o.float() - ro.float()).abs().max().item(), *TOL[dname]["o"]),
                    (close(lse, rlse, *TOL[dname]["lse"]),
                     (lse - rlse).abs().max().item(), *TOL[dname]["lse"]),
                ],
                "flash_bwd_dq_rect": [bwd_close(dq, plain[0], dname)],
                "flash_bwd_dkv_rect": [bwd_close(g, w, dname) for g, w in zip((dk, dv), plain[1:])],
            }
            finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
            for name, results in checks.items():
                ok = finite and all(r[0] for r in results)
                err = max(r[1] for r in results)
                if dtype == torch.bfloat16:
                    max_err[name] = max(max_err[name], err)
                emit({
                    "phase": "rect_kernel", "kernel": name, "dtype": dname,
                    "shape_b_sq_sk_h_d": [b, sq, sk, h, d], "causal": causal,
                    "max_abs_err": err,
                    "tol_atol_rtol": [[r[2], r[3]] for r in results], "ok": ok,
                })
                if not ok:
                    failures.append((name, dname, (b, sq, sk, h, d, causal)))
            del plain, ro
    if failures:
        raise AssertionError(f"rectangular kernels disagree with their plain versions: {failures}")

    # Times at the hop shape, bf16.
    b, sq, sk, h, d, causal = HOP_SHAPE
    bh = b * h
    draw = lambda s: torch.randn(bh, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
    q, k, v, do = draw(sq), draw(sk), draw(sk), draw(sq)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    delta = flash.flash_delta(o, do)
    kernel_ms = {
        "flash_fwd_rect": cuda_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=causal), iters=10),
        "flash_bwd_dq_rect": cuda_ms(torch, lambda: flash._flash_bwd_dq_rect_cuda(
            q, k, v, do, lse, delta, causal), iters=5),
        "flash_bwd_dkv_rect": cuda_ms(torch, lambda: flash._flash_bwd_dkv_rect_cuda(
            q, k, v, do, lse, delta, causal), iters=5),
    }
    two_pass_ref = cuda_ms(torch, lambda: flash.flash_bwd_reference(
        q, k, v, do, lse, delta, causal=causal), iters=2, warmup=1)
    plain_ms = {
        "flash_fwd_rect": cuda_ms(torch, lambda: flash.flash_attention_reference(
            q, k, v, causal=causal), iters=2, warmup=1),
        "flash_bwd_dq_rect": two_pass_ref,
        "flash_bwd_dkv_rect": two_pass_ref,
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, -1, d).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, sq, d)
    sdpa_fwd = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=causal), iters=20)
    sdpa_bwd = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=causal).backward(do4), iters=20
    ) - sdpa_fwd
    bwd_note = ("backward of scaled_dot_product_attention(is_causal=False), timed as "
                "forward+backward minus forward; it covers delta plus dq, dk and dv together")
    library = {
        "flash_fwd_rect": (sdpa_fwd, "scaled_dot_product_attention(is_causal=False), forward"),
        "flash_bwd_dq_rect": (sdpa_bwd, bwd_note),
        "flash_bwd_dkv_rect": (sdpa_bwd, bwd_note),
    }
    # The work each function needs: FLOP per unmasked pair per head dim
    # (forward 4, dq 6, dk/dv 8); each input read once, each output
    # written once.
    pairs = bh * d * unmasked_pairs(causal, sq, sk)
    el = q.element_size()
    nq, nk, rows = bh * sq * d * el, bh * sk * d * el, bh * sq * 4
    work = {
        "flash_fwd_rect": (4 * pairs, 2 * nq + 2 * nk + rows),
        "flash_bwd_dq_rect": (6 * pairs, 3 * nq + 2 * nk + 2 * rows),
        "flash_bwd_dkv_rect": (8 * pairs, 2 * nq + 4 * nk + 2 * rows),
    }
    entries = {}
    for name in RECT_KERNELS:
        src, replaces = KERNEL_ROWS[name]
        flops, nbytes = work[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib_ms, lib_note = library[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_err[name], "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library": lib_note,
            "shape_b_sq_sk_h_d": [b, sq, sk, h, d], "causal": causal,
            "dtype": "bfloat16",
            "achieved_tflops": flops / (kernel_ms[name] * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / kernel_ms[name],
            "over_library": kernel_ms[name] / lib_ms if lib_ms else None,
            "card": card,
        }
        emit({"phase": "rect_kernel_timing", **entries[name]})
    return entries


def last_logits(model, tokens):
    """The servable's function: next-token logits [n, V] (f32) at the
    last position."""
    from kubeflow_tpu_torch.models.transformer import lm_head

    h = model.features(tokens)[:, -1:]
    return lm_head(h, model.embedding, dtype=model.config.dtype)[:, 0]


def dense_attend(q, k, v, *, causal=True, **_):
    from kubeflow_tpu_torch.ops.attention import dense_attention

    return dense_attention(q, k, v, causal=causal)


@contextlib.contextmanager
def plain_kernels():
    """flash_fwd, flash_delta and flash_bwd_kernels through their plain
    versions on CUDA tensors meanwhile (the port itself never takes them
    for a CUDA tensor): the flat and the ring paths alike."""
    from kubeflow_tpu_torch.ops import flash

    def fwd(q, k, v, *, causal=True, block_q=1024, block_k=1024):
        return flash.flash_attention_reference(q, k, v, causal=causal,
                                               block_q=block_q, block_k=block_k)

    def bwd(q, k, v, do, lse, delta, *, causal=True, block_q=1024, block_k=1024,
            fused=None):
        del fused  # the plain fused and two-pass versions are bit-identical
        return flash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                         block_q=block_q, block_k=block_k)

    saved = (flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels)
    flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels = (
        fwd, flash.flash_delta_reference, bwd)
    try:
        yield
    finally:
        flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels = saved


@contextlib.contextmanager
def attention_via(attend):
    """Route the model's flash attention through `attend` meanwhile."""
    from kubeflow_tpu_torch.models import transformer

    original = transformer.flash_attention
    transformer.flash_attention = attend
    try:
        yield
    finally:
        transformer.flash_attention = original


def post(url: str, body: bytes, content_type: str, accept: str):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": content_type, "Accept": accept},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def serve_requests(servable, batches):
    """`REQUESTS` (one token batch each) as :predict calls over HTTP to a
    ModelServerApp serving `servable`, with the launch counters zeroed
    just before and read just after: (predictions, a row per request,
    the launches)."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving import ModelRepository, ModelServerApp
    from kubeflow_tpu_torch.serving import wire
    from kubeflow_tpu_torch.web import serve

    server, thread = serve(
        ModelServerApp(ModelRepository([servable])), host="127.0.0.1", port=0
    )
    url = f"http://127.0.0.1:{server.server_port}/v1/models/{servable.name}:predict"
    vocab = servable.variables.config.vocab_size
    served, rows = [], []
    try:
        _kernels.launches.clear()
        for (fmt, n, s), tokens in zip(REQUESTS, batches):
            t0 = time.perf_counter()
            if fmt == "json":
                body = json.dumps({"instances": tokens.tolist()}).encode()
                status, ctype, raw = post(url, body, "application/json",
                                          "application/json")
                pred = np.asarray(json.loads(raw)["predictions"], np.float32)
            else:
                status, ctype, raw = post(
                    url, wire.encode_tensor(tokens.astype(np.int32)),
                    wire.TENSOR_CONTENT_TYPE, wire.TENSOR_CONTENT_TYPE,
                )
                pred = wire.decode_tensor(raw)
            latency = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"{fmt} predict answered {status}: {raw[:500]!r}")
            if pred.shape != (n, vocab) or not np.isfinite(pred).all():
                raise AssertionError(f"bad prediction: shape {pred.shape}")
            served.append(pred)
            rows.append({"format": fmt, "batch": n, "seq": s,
                         "status": status, "latency_s": latency,
                         "tokens_per_s": n * s / latency})
        launches = dict(_kernels.launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return served, rows, launches


def serve_phase(torch):
    """The main path: three :predict requests over HTTP at full width.
    Returns (servable, the request batches, the predictions, the result)."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.serving import Servable

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    servable = Servable("lm", last_logits, model, max_batch=4, device=DEVICE)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    servable.warmup_with(rng.integers(0, cfg.vocab_size, 2048))
    warmup_s = time.perf_counter() - t0

    batches = [rng.integers(0, cfg.vocab_size, (n, s)) for _, n, s in REQUESTS]
    served, rows, launches = serve_requests(servable, batches)
    forwards = len(REQUESTS)  # each request fits one bucket: one forward
    want = cfg.n_layers * forwards
    if launches.get("flash_fwd", 0) != want:
        raise AssertionError(
            f"flash_fwd launched {launches.get('flash_fwd', 0)} times over "
            f"{forwards} forwards; expected {want}"
        )
    result = {
        "phase": "serve", "model": {**LM, "dtype": "bfloat16"},
        "model_init_s": init_s, "warmup_s": warmup_s, "requests": rows,
        "launches": launches, "forwards": forwards,
    }
    emit(result)
    return servable, batches, served, result


def check_phase(torch, servable, batches, served) -> None:
    """The served answers against the same module run directly with
    attention through the plain version.

    bf16: the kernel and the plain version round differently (one bf16
    ulp in an attention output, now and then), and 16 bf16 layers carry
    that on, so the bound is a second bf16 path's own distance: the
    served logits must lie within twice the plain path's distance from
    the dense path (dense_attention rounds p to bf16 before PV), as the
    CPU tests hold the port against JAX. f32: the same weights in f32,
    kernel path vs plain path at full width, atol = rtol = 1e-4 (the
    kernel's 5e-5 gate, carried through 16 layers)."""
    import dataclasses

    from kubeflow_tpu_torch.models import TransformerLM

    model = servable.variables
    rows, ok = [], True
    with torch.inference_mode():
        for (fmt, n, s), tokens, pred in zip(REQUESTS, batches, served):
            t = torch.tensor(tokens, device=DEVICE)
            with plain_kernels():
                plain = last_logits(model, t).cpu().numpy()
            with attention_via(dense_attend):
                dense = last_logits(model, t).cpu().numpy()
            err = float(np.abs(pred - plain).max())
            gap = float(np.abs(plain - dense).max())
            ok &= err <= 2 * gap
            rows.append({"dtype": "bfloat16", "batch": n, "seq": s,
                         "max_abs_err_vs_plain_path": err,
                         "plain_vs_dense_gap": gap, "tol": 2 * gap})
        model32 = TransformerLM(
            dataclasses.replace(model.config, dtype=torch.float32),
            device=DEVICE, seed=SEED,
        )
        for tokens in (batches[0], batches[2]):
            t = torch.tensor(tokens, device=DEVICE)
            kernel = last_logits(model32, t)
            with plain_kernels():
                plain = last_logits(model32, t)
            err = float((kernel - plain).abs().max())
            ok &= close(kernel, plain, 1e-4, 1e-4)
            rows.append({"dtype": "float32", "batch": tokens.shape[0],
                         "seq": tokens.shape[1],
                         "max_abs_err_vs_plain_path": err,
                         "tol_atol_rtol": [1e-4, 1e-4]})
        del model32
    emit({"phase": "check", "rows": rows, "ok": ok,
          "logit_std": float(np.std(served[0]))})
    if not ok:
        raise AssertionError(f"served logits off the plain path: {rows}")


LM_GROUPS = ("flash_fwd", "flash_bwd", "matmul", "matmul_f32", "optimizer", "other")
RESNET_GROUPS = ("conv", "batch_norm", "elementwise", "optimizer", "other")


def lm_groups(name: str) -> str:
    """An LM step's kernel → its group. matmul_f32: float32 products on
    the CUDA cores — the tied head's f32 logits (`lm_head`) and their
    gradients."""
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if any(t in low for t in ("flash_delta", "flash_bwd", "flash_dq")):
        return "flash_bwd"
    if "sgemm" in low or "f32f32" in low:
        return "matmul_f32"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    return "other"


def profile_device(torch, fn, classify=lm_groups, names=LM_GROUPS) -> dict:
    """Device time by kernel group (`classify`: kernel name → one of
    `names`) over one call of fn (torch.profiler), after one call to warm
    up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = dict.fromkeys(names, 0.0)
    for name, ms in kernels.items():
        groups[classify(name)] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / wall_ms),
        "device_ms_by_group": groups,
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
        # Which instantiation of each flash kernel ran (e.g. the bf16
        # compact dq: tc::flash_bwd_dq_tc<128, false, true>).
        "flash_kernels_ms": [[name[:90], ms] for name, ms in kernels.items()
                             if "flash_" in name],
    }


def timing_phase(torch, servable, batches) -> None:
    """Forward time per request shape (servable.predict, synchronous),
    the 4 x 2048 bucket with the kernel and with the plain version, and
    where that forward's device time goes."""

    def forward_s(batch, reps: int) -> float:
        servable.predict(batch)
        t0 = time.perf_counter()
        for _ in range(reps):
            servable.predict(batch)
        return (time.perf_counter() - t0) / reps

    per_request = [
        {"batch": n, "seq": s, "forward_s": forward_s(tokens, 3)}
        for (_, n, s), tokens in zip(REQUESTS, batches)
    ]
    full = batches[1][:1].repeat(4, axis=0)
    kernel_s = forward_s(full, 5)
    with plain_kernels():
        plain_s = forward_s(full, 2)
    emit({
        "phase": "forward", "per_request": per_request,
        "forward_4x2048_s": kernel_s,
        "forward_tokens_per_s": 4 * 2048 / kernel_s,
        "plain_path_forward_4x2048_s": plain_s,
        "profile_4x2048": profile_device(torch, lambda: servable.predict(full)),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    })


def flops_per_token(seq: int) -> float:
    """bench.py:3627-3643: 6 FLOP per matmul parameter per token (the
    tied head counted once) plus 6·S·d_attn per layer for causal
    attention; remat recompute is not counted."""
    d_attn = LM["n_heads"] * LM["head_dim"]
    layer_params = LM["n_layers"] * (
        4 * LM["d_model"] * d_attn + 3 * LM["d_model"] * LM["d_ff"]
    )
    head_params = LM["vocab_size"] * LM["d_model"]
    return 6 * (layer_params + head_params) + 6 * LM["n_layers"] * seq * d_attn


def train_model(torch, dtype, seed: int = SEED, guard=None, *, remat: str = "none",
                step_remat=None, widths=None):
    """The bench's LM (remat "none" unless `remat` names a policy, bf16
    or f32 compute over f32 params; `widths` replaces `LM`), random
    weights from `seed`, and its adamw trainer (with the anomaly `guard`,
    if one is given, and the whole-step `step_remat` policy)."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    cfg = TransformerConfig(**(widths or LM), dtype=dtype, remat_policy=remat)
    config = TrainConfig(
        batch_size=TRAIN["batch"], learning_rate=TRAIN["lr"],
        total_steps=10_000, optimizer="adamw", label_smoothing=0.0,
        fsdp_params=False, train_metrics="loss", step_remat=step_remat,
    )
    model = TransformerLM(cfg, device=DEVICE, seed=seed)
    return Trainer(model, config, input_key="tokens", label_key="labels",
                   device=DEVICE, guard=guard)


@contextlib.contextmanager
def two_pass_backward():
    """KFTPU_FLASH_FUSED_BWD=0 meanwhile (read at every backward)."""
    old = os.environ.get("KFTPU_FLASH_FUSED_BWD")
    os.environ["KFTPU_FLASH_FUSED_BWD"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["KFTPU_FLASH_FUSED_BWD"]
        else:
            os.environ["KFTPU_FLASH_FUSED_BWD"] = old


def train_phase(torch, card: str) -> tuple[dict, float]:
    """Main path 2: the bench's train step at full width on one card.
    Returns the launch counts of the timed steps and of the two-pass
    step, and the step's ms."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import SyntheticTokens

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_model(torch, torch.bfloat16)
    state = trainer.init_state()
    data = iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                seed=SEED, device=DEVICE))
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN["warmup_steps"]):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    n = TRAIN["timed_steps"]
    _kernels.launches.clear()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    launches = dict(_kernels.launches)

    _kernels.launches.clear()
    with two_pass_backward():
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        two_pass = dict(_kernels.launches)
        two_pass_profile = profile_device(torch, lambda: step(state, next(data)))

    losses = [float(x) for x in losses]
    layers = LM["n_layers"]
    want = {"flash_fwd": layers * n, "flash_delta": layers * n,
            "flash_bwd_fused": layers * n}
    want_two = {"flash_fwd": layers, "flash_delta": layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if launches != want or two_pass != want_two:
        raise AssertionError(
            f"train launches {launches} over {n} steps (want {want}); "
            f"two-pass step {two_pass} (want {want_two})"
        )
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    tokens_per_s = tokens / step_s
    profile = profile_device(torch, lambda: step(state, next(data)))
    result = {
        "phase": "train", "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "batch": TRAIN["batch"], "seq": TRAIN["seq"], "optimizer": "adamw",
        "learning_rate": TRAIN["lr"], "init_s": init_s, "warmup_s": warmup_s,
        "timed_steps": n, "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "flops_per_token": flops_per_token(TRAIN["seq"]),
        "mfu": tokens_per_s * flops_per_token(TRAIN["seq"]) / PEAK_FLOPS["bfloat16"],
        "losses": losses,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "launches_two_pass_step": two_pass,
        "profile_one_step": profile,
        "profile_one_two_pass_step": two_pass_profile,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card,
    }
    emit(result)
    del trainer, state, step
    torch.cuda.empty_cache()
    return {"train": launches, "train_two_pass": two_pass}, step_s * 1e3


class Tape:
    """A resumable stream that records the position of every batch it
    yields (its batches are a function of seed, salt and position)."""

    def __init__(self, stream):
        self.stream, self.positions = stream, []

    def state_dict(self):
        return self.stream.state_dict()

    def load_state_dict(self, state):
        self.stream.load_state_dict(state)

    def perturb(self, salt):
        self.stream.perturb(salt)

    def __iter__(self):
        for batch in self.stream:
            self.positions.append(self.stream.state_dict()["position"] - 1)
            yield batch


def timed_checkpointer(directory, **kwargs):
    """A `Checkpointer` that records how long each save held the step loop
    (the copy off the card), how long its background write took (files,
    fsync, commit, manifest), and how long each restore took."""
    from kubeflow_tpu_torch.train import Checkpointer

    class Timed(Checkpointer):
        def __init__(self):
            super().__init__(directory, **kwargs)
            self.seconds = {"save_block": [], "save_write": [], "restore": []}

        def save(self, *args, **kw):
            t0 = time.perf_counter()
            saved = super().save(*args, **kw)
            if saved:
                self.seconds["save_block"].append(time.perf_counter() - t0)
            return saved

        def _write(self, *args):
            t0 = time.perf_counter()
            super()._write(*args)
            self.seconds["save_write"].append(time.perf_counter() - t0)

        def restore_latest(self, template):
            t0 = time.perf_counter()
            restored = super().restore_latest(template)
            self.seconds["restore"].append(time.perf_counter() - t0)
            return restored

    return Timed()


def max_abs_diff(torch, a: dict, b: dict) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def fit_phase(torch, card: str) -> dict:
    """Main path 4: the training job's entry point, `fit()`, on the same
    LM and stream as the train phase, with an AnomalyGuard and the
    two-pass backward pinned (a step that repeats bitwise). (a) An
    uninterrupted FIT["steps"]-step run; a run that saves every
    FIT["save_every"] steps and gets a SIGTERM at step FIT["sigterm_at"]
    (from on_metrics), which must return `Preempted` at the next step
    after its save; a third `fit()` that resumes from there to the end,
    under the profiler for one step, and must reach the uninterrupted
    run's parameters bitwise over the same batch positions. (b) One step
    whose embedding output is multiplied by NaN (a forward pre-hook on the
    first block): skipped, parameters and optimizer state unchanged.
    (c) The three storage fault classes of the soak's plan
    (`testing/chaos.apply_checkpoint_fault`: truncate_checkpoint,
    corrupt_checkpoint, corrupt_manifest), in the order a seeded
    `TrainFaultSchedule` draws them, stacked on the phase's one crash
    boundary at offsets 0, 1 and 2 (the newest three of the FIT["keep"]
    steps saved): restore quarantines each damaged step and lands on the
    newest intact one, its parameters bitwise those saved there. (d) Save and
    restore times, the checkpoint's size, and fit()'s step time beside
    the bare guarded and unguarded steps' (and a profile of each).
    Returns the launch counts of the three fit() runs."""
    import shutil
    import signal
    import tempfile

    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.testing.chaos import TrainFaultSchedule, apply_checkpoint_fault
    from kubeflow_tpu_torch.train import (
        AnomalyGuard, Preempted, ProfileSchedule, Profiler, SyntheticTokens,
        Trainer, fit)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = train_model(torch, torch.bfloat16, guard=AnomalyGuard())
    params = lambda: {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    stream = lambda: Tape(SyntheticTokens(
        TRAIN["batch"], TRAIN["seq"], LM["vocab_size"], seed=SEED,
        vary_per_step=True, device=DEVICE))
    root = tempfile.mkdtemp(prefix="kftpu_fit_")
    ckpt_dir = os.path.join(root, "ckpt")
    checks, out = {}, {"phase": "fit", "steps": FIT["steps"],
                       "save_every": FIT["save_every"], "sigterm_at": FIT["sigterm_at"]}

    # The step the storage faults leave as the newest intact one.
    intact_step = FIT["steps"] - 3
    at_save = {}

    def sigterm_at(step, rec):
        if step == intact_step:
            at_save[step] = params()
        if step == FIT["sigterm_at"]:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        with two_pass_backward():
            _kernels.launches.clear()
            tape = stream()
            straight = fit(trainer, tape, FIT["steps"], rng=SEED, log_every=1)
            torch.cuda.synchronize()
            want = params()
            checks["straight_positions"] = tape.positions == list(range(FIT["steps"]))
            step_ms = [TRAIN["batch"] / rec["examples_per_sec"] * 1e3
                       for rec in straight.history[1:]]
            out["straight_losses"] = [rec["loss"] for rec in straight.history]
            del straight

            ckpt = timed_checkpointer(ckpt_dir, save_interval_steps=FIT["save_every"],
                                      max_to_keep=FIT["keep"])
            tape = stream()
            first = fit(trainer, tape, FIT["steps"], rng=SEED, checkpointer=ckpt,
                        log_every=1, on_metrics=sigterm_at)
            # The interval saves up to the preemption's step and its own
            # save there, the newest FIT["keep"] kept.
            saved = sorted(set(range(FIT["save_every"], FIT["sigterm_at"] + 2,
                                     FIT["save_every"])) | {FIT["sigterm_at"] + 1})[-FIT["keep"]:]
            checks["preempted"] = (isinstance(first, Preempted)
                                   and first.signum == signal.SIGTERM
                                   and int(first.state.step) == FIT["sigterm_at"] + 1
                                   and ckpt.all_steps() == saved)
            del first

            ckpt2 = timed_checkpointer(ckpt_dir, save_interval_steps=FIT["save_every"],
                                       max_to_keep=FIT["keep"])
            tape = stream()
            trace_dir = os.path.join(root, "trace")
            profiler = Profiler(trace_dir, ProfileSchedule(start_step=1, num_steps=1))
            resumed = fit(trainer, tape, FIT["steps"], rng=SEED + 1, checkpointer=ckpt2,
                          log_every=1, profiler=profiler)
            torch.cuda.synchronize()
            launches = dict(_kernels.launches)
            resume_diff = max_abs_diff(torch, params(), want)
            checks["resumed"] = (resumed.resumed_from == FIT["sigterm_at"] + 1
                                 and int(resumed.state.step) == FIT["steps"]
                                 and tape.positions == list(range(FIT["sigterm_at"] + 1,
                                                                  FIT["steps"])))
            del resumed
            checks["resume_bitwise"] = resume_diff == 0.0
            checks["trace_written"] = profiler.trace_written and any(
                name.endswith(".json") for name in os.listdir(trace_dir))
            ckpt_bytes = sum(
                os.path.getsize(os.path.join(ckpt_dir, str(FIT["steps"]), name))
                for name in os.listdir(os.path.join(ckpt_dir, str(FIT["steps"]))))
            # The directory at its peak: every kept step, before any fault.
            dir_bytes = sum(os.path.getsize(os.path.join(d, name))
                            for d, _, names in os.walk(ckpt_dir) for name in names)
            on_disk = ckpt2.all_steps()

            # (b) A NaN at the embedding output for one step.
            before = params()
            hook = trainer.model.layers[0].register_forward_pre_hook(
                lambda module, args: (args[0] * float("nan"), *args[1:]))
            try:
                poisoned = fit(trainer, stream(), 1, log_every=1, handle_signals=False)
            finally:
                hook.remove()
            rec = poisoned.history[-1]
            opt_zero = all(int((t != 0).sum()) == 0 for group in ("mu", "nu")
                           for t in poisoned.state.opt_state[group].values())
            checks["poison_skipped"] = (
                rec["guard_skipped_total"] == 1 and not np.isfinite(rec["loss"])
                and max_abs_diff(torch, params(), before) == 0.0 and opt_zero
                and int(poisoned.state.opt_state["count"]) == 0
                and int(poisoned.state.step) == 1)
            del before, poisoned

            # (c) The three storage fault classes, stacked at offsets 0-2.
            plan = TrainFaultSchedule(FIT["fault_seed"], 32, save_interval=4)
            faults = []
            t_faults = time.perf_counter()
            for offset, fault in enumerate(plan.storage_faults):
                desc = apply_checkpoint_fault(ckpt_dir, fault.cls, offset=offset)
                faults.append({"cls": fault.cls, "offset": offset,
                               "step": on_disk[-1 - offset], "damaged": desc})
            fault_s = time.perf_counter() - t_faults
            ckpt3 = timed_checkpointer(ckpt_dir, save_interval_steps=FIT["save_every"])
            restored = ckpt3.restore_latest(trainer.abstract_state())
            trainer.load_state_dict(restored.state)
            torch.cuda.synchronize()
            quarantined = sorted(int(name[len("corrupt-"):]) for name in os.listdir(ckpt_dir)
                                 if name.startswith("corrupt-"))
            damaged = sorted(f["step"] for f in faults)
            checks["storage_faults_applied"] = (
                {f["cls"] for f in faults} == {"truncate_checkpoint", "corrupt_checkpoint",
                                               "corrupt_manifest"}
                and all(f["damaged"] for f in faults)
                and on_disk == list(range(1, FIT["steps"] + 1)))
            checks["corrupt_fell_back"] = (
                restored.step == intact_step and quarantined == damaged
                and ckpt3.all_steps() == [intact_step]
                and max_abs_diff(torch, params(), at_save[intact_step]) == 0.0)
            out.update({"storage_faults": faults, "quarantined_steps": quarantined,
                        "restored_step": restored.step, "storage_faults_s": fault_s,
                        "checkpoint_dir_peak_gb": dir_bytes / 1e9,
                        "steps_on_disk_at_peak": on_disk})
            del restored, at_save, want

            # (d) The bare steps, guarded and not, on the same trainer.
            bare = {}
            for name, tr in (("guarded", trainer),
                             ("unguarded", Trainer(trainer.model, trainer.config,
                                                   input_key="tokens",
                                                   label_key="labels", device=DEVICE))):
                state, step, data = tr.init_state(), tr.make_train_step(), iter(stream())
                state, _ = step(state, next(data))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    state, metrics = step(state, next(data))
                torch.cuda.synchronize()
                bare[name] = (time.perf_counter() - t0) / 3 * 1e3
                out[f"profile_{name}_step"] = profile_device(
                    torch, lambda: step(state, next(data)))
                del state, step, data
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = {key: ckpt.seconds[key] + ckpt2.seconds[key] + ckpt3.seconds[key]
               for key in ckpt.seconds}
    # The preempted run and the resumed one take FIT["steps"] steps
    # between them, as the uninterrupted run does.
    want_launches = {name: LM["n_layers"] * 2 * FIT["steps"] for name in
                     ("flash_fwd", "flash_delta", "flash_bwd_dq", "flash_bwd_dkv")}
    checks["launches"] = launches == want_launches
    out.update({
        "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "optimizer": "adamw", "guard": True, "two_pass_backward": True,
        "checks": checks, "resume_max_abs_diff": resume_diff,
        "fit_step_ms": step_ms, "bare_guarded_step_ms": bare["guarded"],
        "bare_unguarded_step_ms": bare["unguarded"],
        "checkpoint_gb": ckpt_bytes / 1e9,
        "save_block_s": seconds["save_block"], "save_write_s": seconds["save_write"],
        "restore_s": seconds["restore"],
        "launches": launches, "want_launches": want_launches,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    emit(out)
    del trainer
    torch.cuda.empty_cache()
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fit phase checks failed: {failed}")
    return launches


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def step_grads(torch, model, batch):
    """One forward and backward of the train step's loss, the port's
    `softmax_cross_entropy` (plus a MoE's load-balancing losses) as
    Trainer computes it: (loss, its [B, S] float32 per-token cross
    entropies, {name: gradient}), with the parameters left as they
    were."""
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    model.zero_grad(set_to_none=True)
    aux_losses = []
    if getattr(model, "sows_losses", False):  # a MoE's load balancing
        logits, aux_losses = model(batch["tokens"], with_losses=True)
    else:
        logits = model(batch["tokens"])
    loss = softmax_cross_entropy(logits, batch["labels"])
    for aux in aux_losses:
        loss = loss + aux
    with torch.no_grad():
        logits = logits.float()
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, batch["labels"][..., None])[..., 0]
    del logits
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), nll, grads


def ratio(a: float, b: float) -> float:
    return abs(a) / max(abs(b), 1e-30)


def loss_gap(nll_a, nll_b) -> dict:
    """Two paths' per-token losses compared: the difference of their mean
    losses (summed in float64), its standard error (the spread of the
    per-token differences over the square root of the token count), the
    two as a z-score, and the per-token relative norm."""
    d = (nll_a - nll_b).double().flatten()
    mean, se = float(d.mean()), float(d.std() / d.numel() ** 0.5)
    return {"mean_diff": mean, "se": se, "z": mean / max(se, 1e-30),
            "token_rel": rel(nll_a, nll_b)}


def bf16_loss_ok(checked: dict, reference: dict) -> bool:
    """The bf16 loss limits of train_check and ring_check. The checked
    pair's per-token losses lie within twice the reference pair's
    relative norm, and its mean-loss difference within LOSS_Z of its own
    standard errors: a shift of the mean beyond its rounding noise."""
    return (checked["token_rel"] <= 2 * reference["token_rel"]
            and abs(checked["z"]) <= LOSS_Z)


def bf16_path_check(torch, build, batch) -> tuple[bool, dict]:
    """The bf16 half of train_check, for the model `build()` returns: its
    loss and gradients on the kernel path, on the plain versions and on
    dense attention, the first pair held to the second as
    `train_check_phase` says. The row also gives the global gradient
    norms' plain-vs-dense gap, which the remat phase holds its policies
    to."""
    from kubeflow_tpu_torch.train.trainer import global_norm

    ok = True
    model = build()

    def run():
        return step_grads(torch, model, batch)

    loss_k, nll_k, g_k = run()
    with plain_kernels():
        loss_p, nll_p, g_p = run()
    with attention_via(dense_attend):
        loss_d, nll_d, g_d = run()
    kp, pd = loss_gap(nll_k, nll_p), loss_gap(nll_p, nll_d)
    ok &= bf16_loss_ok(kp, pd)
    worst = {"name": None, "ratio": 0.0}
    for name in g_k:
        err, gap = rel(g_k[name], g_p[name]), rel(g_p[name], g_d[name])
        ok &= err <= 2 * gap and bool(torch.isfinite(g_k[name]).all())
        if err / max(gap, 1e-30) > worst["ratio"]:
            worst = {"name": name, "ratio": err / max(gap, 1e-30),
                     "rel_err_vs_plain": err, "plain_vs_dense_rel_gap": gap}
    qkv = [n for n in g_k if n.endswith(("attn.wq", "attn.wk", "attn.wv"))]
    norm_p, norm_d = float(global_norm(g_p.values())), float(global_norm(g_d.values()))
    row = {
        "dtype": "bfloat16", "loss_kernel": float(loss_k),
        "loss_plain": float(loss_p), "loss_dense": float(loss_d),
        "loss_kernel_vs_plain": kp, "loss_plain_vs_dense": pd,
        "loss_tol": {"token_rel": 2 * pd["token_rel"], "abs_z": LOSS_Z},
        "mean_loss_ratio_kp_over_pd": ratio(kp["mean_diff"], pd["mean_diff"]),
        "params": len(g_k), "wq_wk_wv_with_grads": len(qkv),
        "max_rel_err_vs_plain": max(rel(g_k[n], g_p[n]) for n in g_k),
        "max_rel_err_param": max(g_k, key=lambda n: rel(g_k[n], g_p[n])),
        "worst_param_vs_its_tol": worst,
        "grad_norm_plain_vs_dense_rel": abs(norm_p - norm_d) / norm_d,
    }
    del model, g_k, g_p, g_d
    torch.cuda.empty_cache()
    return ok, row


def train_check_phase(torch, seed: int = SEED, strict: bool = True, keep_f32: str | None = None):
    """The kernel path's loss and gradients against the same step with
    attention through the plain versions, on the same weights and batch.

    bf16: kernel and plain versions round differently (one bf16 ulp in an
    attention output or gradient, now and then), and 16 bf16 layers carry
    that on, so the bound is a second bf16 path's own distance, as the
    forward check's: for every parameter's gradient (relative Frobenius
    norm), the kernel path must lie within twice the plain path's
    distance from the dense path; the loss is held by `bf16_loss_ok`,
    against the plain-vs-dense pair. f32: the same weights in f32, kernel
    path vs plain path, |loss difference| <= 1e-4·|loss| and every
    gradient within relative norm 1e-4: the kernels' 5e-5 gate, carried
    through 16 layers forward and back. `keep_f32` names a file that
    gets the f32 kernel path's loss and gradients (on the CPU): the
    one-process step the gang phase holds its ranks to."""
    from kubeflow_tpu_torch.train import SyntheticTokens

    batch = next(iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                      seed=seed, device=DEVICE)))

    def run():
        return step_grads(torch, trainer.model, batch)

    ok, row = bf16_path_check(
        torch, lambda: train_model(torch, torch.bfloat16, seed).model, batch)
    rows = [row]
    trainer = train_model(torch, torch.float32, seed)
    loss_k, _, g_k = run()
    if keep_f32:
        torch.save({"loss": loss_k.cpu(), "grads": {n: g.cpu() for n, g in g_k.items()}},
                   keep_f32)
    with plain_kernels():
        loss_p, _, g_p = run()
    loss_err = abs(float(loss_k - loss_p))
    ok &= loss_err <= 1e-4 * abs(float(loss_p))
    errs = {n: rel(g_k[n], g_p[n]) for n in g_k}
    ok &= max(errs.values()) <= 1e-4
    rows.append({
        "dtype": "float32", "loss_kernel": float(loss_k),
        "loss_plain": float(loss_p), "loss_err_vs_plain": loss_err,
        "loss_tol_rel": 1e-4, "max_rel_err_vs_plain": max(errs.values()),
        "worst_param": max(errs, key=errs.get), "grad_tol_rel": 1e-4,
    })
    del trainer, g_k, g_p
    torch.cuda.empty_cache()
    emit({"phase": "train_check", "seed": seed, "rows": rows, "ok": ok})
    if strict and not ok:
        raise AssertionError(f"train step off the plain path: {rows}")
    return ok, rows


def remat_forwards(block: str, step_remat) -> int:
    """flash_fwd launches in a train step under a block policy and a
    step_remat: one a layer, and one more where the backward recomputes
    the attention without its kept (o, lse) ("full", "dots", "attn")."""
    policy = step_remat or block
    return LM["n_layers"] * (2 if policy in ("full", "dots", "attn") else 1)


def first_step_grad_norm(trainer, state) -> float:
    """The global gradient norm of an adamw trainer's first step: its
    second moment is then (1 - b2)·g², so the norm is
    sqrt(Σ nu / (1 - b2))."""
    total = sum(float(nu.double().sum()) for nu in state.opt_state["nu"].values())
    return (total / (1 - trainer.tx.b2)) ** 0.5


def release(torch) -> None:
    """Give the card's cached memory back and restart the peak count."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def remat_phase(torch, card: str, check_row: dict) -> dict:
    """Main path 2a: the train phase's step under every remat policy
    (`REMAT`), each with its step ms, peak memory, flash launches, and
    its first step's loss and global gradient norm.

    The first step runs with the two-pass backward pinned, which adds in
    a fixed order (the fused one adds dq with float atomics), so that
    the policies, which compute one function, are compared without
    run-to-run noise. Fails where a timed step's launches are not one
    flash_delta and one flash_bwd_fused a layer and `remat_forwards`
    flash_fwd, or where a policy's first step is off "none"'s: the loss
    by more than `LOSS_Z` of train_check's bf16 standard errors, the
    gradient norm by more than twice train_check's plain-vs-dense
    relative gap. Returns the timed steps' launches."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import SyntheticTokens

    data = iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                seed=SEED, device=DEVICE))
    batches = [next(data) for _ in range(1 + REMAT["steps"])]
    runs = ([(block, None) for block in REMAT["block"]]
            + [("none", step) for step in REMAT["step"]])
    loss_tol = LOSS_Z * check_row["loss_kernel_vs_plain"]["se"]
    norm_tol = 2 * check_row["grad_norm_plain_vs_dense_rel"]
    layers, n = LM["n_layers"], REMAT["steps"]
    rows, total, ok = [], {}, True
    for block, step_remat in runs:
        release(torch)
        trainer = train_model(torch, torch.bfloat16, remat=block, step_remat=step_remat)
        state = trainer.init_state()
        step = trainer.make_train_step()
        with two_pass_backward():
            state, metrics = step(state, batches[0])
        loss, grad_norm = float(metrics["loss"]), first_step_grad_norm(trainer, state)
        torch.cuda.synchronize()
        _kernels.launches.clear()
        t0 = time.perf_counter()
        for batch in batches[1:]:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        launches = dict(_kernels.launches)
        want = {"flash_fwd": remat_forwards(block, step_remat) * n,
                "flash_delta": layers * n, "flash_bwd_fused": layers * n}
        row = {"remat": block, "step_remat": step_remat, "step_ms": step_s * 1e3,
               "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / step_s,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "flash_fwd_per_step": launches.get("flash_fwd", 0) / n,
               "launches_per_step": {k: v / n for k, v in launches.items()},
               "loss": loss, "grad_norm": grad_norm, "launches_ok": launches == want}
        if rows:
            none = rows[0]
            row["loss_diff_vs_none"] = abs(loss - none["loss"])
            row["grad_norm_rel_vs_none"] = abs(grad_norm - none["grad_norm"]) / none["grad_norm"]
            row["ok"] = (row["launches_ok"] and row["loss_diff_vs_none"] <= loss_tol
                         and row["grad_norm_rel_vs_none"] <= norm_tol)
        else:
            row["ok"] = row["launches_ok"] and bool(np.isfinite([loss, grad_norm]).all())
        ok &= row["ok"]
        rows.append(row)
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        del trainer, state, step, metrics
    release(torch)
    emit({"phase": "remat", "model": {**LM, "dtype": "bfloat16"}, "batch": TRAIN["batch"],
          "seq": TRAIN["seq"], "timed_steps": n, "rows": rows,
          "tol": {"loss_abs": loss_tol, "grad_norm_rel": norm_tol}, "ok": ok,
          "card": card})
    if not ok:
        raise AssertionError(f"remat policies off their launches or off 'none': {rows}")
    return total


def moe_widths(**changes) -> dict:
    """`LM` with MOE's experts."""
    moe = {k: MOE[k] for k in ("num_experts", "capacity_factor", "aux_loss_coef")}
    return {**LM, **moe, **changes}


def moe_routing(torch, model, tokens) -> dict:
    """The MoE model's load-balancing loss (summed over layers) and the
    share of tokens past their expert's capacity, on `tokens` with its
    current weights: a forward without gradients, each layer's routing
    read on the input it got."""
    dropped, hooks = [], []
    for layer in model.layers:
        hooks.append(layer.moe.register_forward_pre_hook(
            lambda mod, args: dropped.append((~mod.route(args[0]).keep).float().mean())))
    try:
        with torch.no_grad():
            _, losses = model(tokens, with_losses=True)
    finally:
        for hook in hooks:
            hook.remove()
    shares = [float(d) for d in dropped]
    return {"aux_loss": float(sum(losses)), "dropped_share": sum(shares) / len(shares),
            "dropped_share_max_layer": max(shares)}


def moe_check_phase(torch) -> None:
    """One step of the MoE model at `MOE["check_layers"]` layers (the same
    widths, remat "flash") on the kernels against the same step on the
    plain versions, held to train_check's bf16 limits (`bf16_path_check`,
    against the plain-vs-dense pair: the routing of a token near a tie
    moves with the rounding in both pairs)."""
    from kubeflow_tpu_torch.train import SyntheticTokens

    batch = next(iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                      seed=SEED, device=DEVICE)))
    widths = moe_widths(n_layers=MOE["check_layers"])
    ok, row = bf16_path_check(torch, lambda: train_model(
        torch, torch.bfloat16, remat=MOE["remat"], widths=widths).model, batch)
    emit({"phase": "moe_check", "model": {**widths, "dtype": "bfloat16"},
          "remat": MOE["remat"], "rows": [row], "ok": ok})
    if not ok:
        raise AssertionError(f"MoE train step off the plain path: {row}")


def moe_train_phase(torch, card: str):
    """Main path 2b: the switch-MoE LM (`MOE`) trained with
    make_train_step under an AnomalyGuard, as fit() trains (its copies of
    the parameters and the optimizer state count in the peak). Each step
    is timed alone; before it, a forward without gradients on its batch
    reads the load-balancing loss and the dropped share the step sees.
    Then a profile of one step. Fails on a non-finite loss, a step the
    guard skips, or a step whose launches are not one flash_fwd,
    flash_delta and flash_bwd_fused a layer (remat "flash": the backward
    runs no flash forward). Returns (the trained model, the timed
    steps' launches)."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import AnomalyGuard, SyntheticTokens

    release(torch)
    t0 = time.perf_counter()
    trainer = train_model(torch, torch.bfloat16, guard=AnomalyGuard(), remat=MOE["remat"],
                          widths=moe_widths())
    state = trainer.init_state()
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in trainer.model.parameters())
    data = iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                seed=SEED, device=DEVICE))
    layers, rows, total, ok = LM["n_layers"], [], {}, True
    want = {"flash_fwd": layers, "flash_delta": layers, "flash_bwd_fused": layers}
    for i in range(MOE["steps"]):
        batch = next(data)
        routing = moe_routing(torch, trainer.model, batch["tokens"])
        torch.cuda.synchronize()
        _kernels.launches.clear()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        loss = float(metrics["loss"])
        rows.append({"step": i, "step_ms": step_s * 1e3, "loss": loss,
                     "cross_entropy": loss - routing["aux_loss"], **routing,
                     "grad_norm": float(metrics["grad_norm"]),
                     "guard_ok": int(metrics["guard_ok"]), "launches": launches})
        ok &= (launches == want and rows[-1]["guard_ok"] == 1
               and bool(np.isfinite([loss, routing["aux_loss"]]).all()))
        if i:  # the first step is the warm-up
            for name, count in launches.items():
                total[name] = total.get(name, 0) + count
    timed = [r["step_ms"] for r in rows[1:]]
    step_ms = sum(timed) / len(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    profile = profile_device(torch, lambda: step(state, next(data)))
    emit({"phase": "moe_train", "model": {**moe_widths(), "dtype": "bfloat16"},
          "params": params, "remat": MOE["remat"], "batch": TRAIN["batch"],
          "seq": TRAIN["seq"], "optimizer": "adamw", "guard": True, "init_s": init_s,
          "steps": rows, "step_ms": step_ms,
          "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / step_ms * 1e3,
          "peak_memory_gib": peak_gib, "profile_one_step": profile, "ok": ok,
          "card": card})
    if not ok:
        raise AssertionError(f"MoE train steps off their launches or not finite: {rows}")
    model = trainer.model
    del trainer, state, step, metrics
    return model, total


def moe_forward_diagnostic(torch, model, servable, batches, served) -> dict:
    """The module's forward on each served request's padded batch, four
    ways: on this thread and on a second one (cuBLAS keeps a handle and
    a workspace per thread), each under `torch.inference_mode` (as the
    server runs it) and under `torch.no_grad`. Emits each way's largest
    difference from the served answers, per request; decides nothing
    (moe_serve's bitwise check is the gate)."""
    padded = []
    for tokens in batches:
        batch = np.zeros((servable._bucket_for(len(tokens)), tokens.shape[1]), tokens.dtype)
        batch[:len(tokens)] = tokens
        padded.append(batch)

    def forward(mode: str) -> list:
        ctx = torch.inference_mode if mode == "inference_mode" else torch.no_grad
        with ctx():
            return [last_logits(model, torch.tensor(b, device=DEVICE)).float().cpu().numpy()
                    for b in padded]

    diffs = {}
    for mode in ("inference_mode", "no_grad"):
        for where in ("this_thread", "second_thread"):
            if where == "this_thread":
                out = forward(mode)
            else:
                box: dict = {}
                worker = threading.Thread(target=lambda m=mode: box.update(out=forward(m)))
                worker.start()
                worker.join(timeout=600)
                out = box["out"]
            diffs[f"{where}_{mode}"] = [
                float(np.abs(pred - o[:len(tokens)]).max())
                for tokens, pred, o in zip(batches, served, out)]
    line = {"phase": "moe_serve_diagnostic", "max_abs_diff_vs_served": diffs}
    emit(line)
    return line


def moe_serve_phase(torch, card: str, model) -> dict:
    """Main path 2c: the trained MoE module behind Servable ->
    ModelRepository -> ModelServerApp -> HTTP, REQUESTS with the counters
    zeroed just before and read just after (16 flash_fwd a forward).
    Routing groups and capacity span every token of the batch the server
    runs, so each answer is held, bitwise, to the module's own forward on
    that batch: the request padded with zero rows to its bucket. Returns
    the launches."""
    from kubeflow_tpu_torch.serving import Servable

    release(torch)
    servable = Servable("lm-moe", last_logits, model, max_batch=MOE["max_batch"],
                        device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    servable.warmup_with(rng.integers(0, LM["vocab_size"], TRAIN["seq"]))
    batches = [rng.integers(0, LM["vocab_size"], (n, s)) for _, n, s in REQUESTS]
    served, rows, launches = serve_requests(servable, batches)
    ok = launches == {"flash_fwd": LM["n_layers"] * len(REQUESTS)}
    moe_forward_diagnostic(torch, model, servable, batches, served)
    with torch.inference_mode():
        for row, tokens, pred in zip(rows, batches, served):
            padded = np.zeros((servable._bucket_for(len(tokens)), tokens.shape[1]),
                              tokens.dtype)
            padded[:len(tokens)] = tokens
            direct = last_logits(model, torch.tensor(padded, device=DEVICE))
            err = float(np.abs(pred - direct[:len(tokens)].float().cpu().numpy()).max())
            row.update({"bucket": len(padded), "max_abs_diff_vs_module": err})
            ok &= err == 0.0
    emit({"phase": "moe_serve", "requests": rows, "launches": launches, "ok": ok,
          "card": card})
    if not ok:
        raise AssertionError(f"MoE answers off the module's forward or its launches: {rows}")
    return launches


def moe_phases(torch, card: str) -> dict:
    """moe_check, moe_train and moe_serve; the paths' launches."""
    moe_check_phase(torch)
    model, train_launches = moe_train_phase(torch, card)
    serve_launches = moe_serve_phase(torch, card, model)
    del model
    release(torch)
    return {"moe": train_launches, "moe_serve": serve_launches}


def ring_model(torch, dtype, *, mesh=True, remat="none", seed: int = SEED):
    """The LM at full width on an in-process sp ring of RING["sp"] (or
    flat, mesh=False), random weights from `seed`: the same weights
    either way."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = TransformerConfig(**LM, dtype=dtype, remat=remat != "none",
                            remat_policy=remat)
    ring = build_mesh(MeshSpec(sp=RING["sp"])) if mesh else None
    return TransformerLM(cfg, mesh=ring, device=DEVICE, seed=seed)


def ring_tokens(seed: int = SEED):
    from kubeflow_tpu_torch.train import SyntheticTokens

    return iter(SyntheticTokens(RING["batch"], RING["seq"], LM["vocab_size"],
                                seed=seed, device=DEVICE))


def ring_launches_per_step() -> dict:
    """What one ring train step launches, with the ring positions of one
    hop kind folded into one launch: per layer, the diagonal hop (causal
    kernels, fused backward) once and each of the sp - 1 later hops
    (rectangular kernels) once, plus one delta."""
    layers, full = LM["n_layers"], RING["sp"] - 1
    return {"flash_fwd": layers, "flash_fwd_rect": layers * full,
            "flash_delta": layers, "flash_bwd_fused": layers,
            "flash_bwd_dq_rect": layers * full, "flash_bwd_dkv_rect": layers * full}


def ring_train_phase(torch, card: str) -> dict:
    """Main path 3: the LM trained with sequence parallelism, on an
    in-process sp ring of 4 on one card (ring flash attention: every
    hop's kernels), batch 1 at S = 16384, adamw lr 3e-4; one warm-up
    step, then timed steps with the launch counters zeroed just before
    and read just after. Then the flat LM at the same S, for the cost of
    the ring on one card. Returns the launch counts of the timed steps."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    config = TrainConfig(
        batch_size=RING["batch"], learning_rate=RING["lr"], total_steps=10_000,
        optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
        train_metrics="loss",
    )
    tokens = RING["batch"] * RING["seq"]

    def run(model, warmup: int, timed: int):
        trainer = Trainer(model, config, input_key="tokens", label_key="labels",
                          device=DEVICE)
        state, step, data = trainer.init_state(), trainer.make_train_step(), ring_tokens()
        losses = []
        for _ in range(warmup):
            state, metrics = step(state, next(data))
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        _kernels.launches.clear()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, next(data))
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
        return trainer, state, step, data, losses, step_s, dict(_kernels.launches)

    t0 = time.perf_counter()
    model = ring_model(torch, torch.bfloat16)
    init_s = time.perf_counter() - t0
    n = RING["timed_steps"]
    trainer, state, step, data, losses, step_s, launches = run(
        model, RING["warmup_steps"], n)
    want = {k: v * n for k, v in ring_launches_per_step().items()}
    if launches != want:
        raise AssertionError(f"ring train launches {launches} over {n} steps (want {want})")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite ring loss: {losses}")
    profile = profile_device(torch, lambda: step(state, next(data)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainer, state, step, model
    torch.cuda.empty_cache()

    flat = run(ring_model(torch, torch.bfloat16, mesh=False), 1, 2)
    flat_step_s = flat[5]
    del flat
    torch.cuda.empty_cache()
    tokens_per_s = tokens / step_s
    result = {
        "phase": "ring_train",
        "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "mesh": {"sp": RING["sp"], "in_process": True}, "batch": RING["batch"],
        "seq": RING["seq"], "chunk": RING["seq"] // RING["sp"], "optimizer": "adamw",
        "learning_rate": RING["lr"], "init_s": init_s, "timed_steps": n,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "flops_per_token": flops_per_token(RING["seq"]),
        "mfu": tokens_per_s * flops_per_token(RING["seq"]) / PEAK_FLOPS["bfloat16"],
        "losses": losses,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "profile_one_step": profile, "peak_memory_gib": peak,
        "flat_same_seq_step_ms": flat_step_s * 1e3,
        "flat_same_seq_tokens_per_s": tokens / flat_step_s,
        "ring_over_flat_step": step_s / flat_step_s,
        "card": card,
    }
    emit(result)
    return launches


def ring_check_phase(torch, seed: int = SEED, strict: bool = True):
    """One ring train step's loss and every parameter's gradient, on the
    same weights and tokens (batch 1 x 16384), with remat "full" to keep
    the f32 activations in memory.

    f32: the ring (rectangular kernels on full hops, causal kernels on
    the diagonal) against the flat LM (causal kernels over the whole
    sequence): |loss difference| <= 1e-4·|loss| and every gradient within
    relative norm 1e-4 — the kernels' 5e-5 gate carried through 16
    layers, as train_check holds the flat path. bf16: the ring rounds
    each hop's output to bf16 before the merge, as JAX's does, so it is
    not held to the flat path. The ring on the kernels is held against
    the same ring with the plain versions in place of the kernels, with
    the flat kernel path against the flat plain-version path as the
    reference pair (as train_check does): every gradient within twice
    the reference's relative norm, and the loss by `bf16_loss_ok`. The
    ring's distance to the flat path is printed too."""
    batch = next(ring_tokens(seed))
    rows, ok = [], True

    def run(model, plain=False):
        with plain_kernels() if plain else contextlib.nullcontext():
            return step_grads(torch, model, batch)

    ring, flat = (ring_model(torch, torch.float32, mesh=m, remat="full", seed=seed)
                  for m in (True, False))
    loss_r, nll_r, g_r = run(ring)
    loss_f, nll_f, g_f = run(flat)
    loss_r, loss_f = float(loss_r), float(loss_f)
    errs = {n: rel(g_r[n], g_f[n]) for n in g_r}
    ok &= abs(loss_r - loss_f) <= 1e-4 * abs(loss_f) and max(errs.values()) <= 1e-4
    ok &= all(bool(torch.isfinite(g).all()) for g in g_r.values())
    rows.append({
        "dtype": "float32", "layers": LM["n_layers"], "loss_ring": loss_r,
        "loss_flat": loss_f, "loss_err_vs_flat": abs(loss_r - loss_f),
        "loss_tol_rel": 1e-4, "token_loss_rel_err_vs_flat": rel(nll_r, nll_f),
        "max_rel_err_vs_flat": max(errs.values()), "worst_param": max(errs, key=errs.get),
        "grad_tol_rel": 1e-4, "params": len(g_r),
    })
    del ring, flat, g_r, g_f
    torch.cuda.empty_cache()

    ring, flat = (ring_model(torch, torch.bfloat16, mesh=m, remat="full", seed=seed)
                  for m in (True, False))
    loss_rk, nll_rk, g_rk = run(ring)
    loss_rp, nll_rp, g_rp = run(ring, plain=True)
    loss_fk, nll_fk, g_fk = run(flat)
    loss_fp, nll_fp, g_fp = run(flat, plain=True)
    ring_kp, flat_kp = loss_gap(nll_rk, nll_rp), loss_gap(nll_fk, nll_fp)
    ok &= bf16_loss_ok(ring_kp, flat_kp)
    worst = {"name": None, "ratio": 0.0}
    for name in g_rk:
        err, gap = rel(g_rk[name], g_rp[name]), rel(g_fk[name], g_fp[name])
        ok &= err <= 2 * gap and bool(torch.isfinite(g_rk[name]).all())
        if err / max(gap, 1e-30) > worst["ratio"]:
            worst = {"name": name, "ratio": err / max(gap, 1e-30),
                     "rel_err_ring_kernel_vs_plain": err,
                     "rel_gap_flat_kernel_vs_plain": gap}
    rows.append({
        "dtype": "bfloat16", "loss_ring_kernel": float(loss_rk),
        "loss_ring_plain": float(loss_rp), "loss_flat_kernel": float(loss_fk),
        "loss_flat_plain": float(loss_fp),
        "loss_ring_kernel_vs_plain": ring_kp, "loss_flat_kernel_vs_plain": flat_kp,
        "loss_tol": {"token_rel": 2 * flat_kp["token_rel"], "abs_z": LOSS_Z},
        "mean_loss_ratio_ring_over_flat": ratio(ring_kp["mean_diff"], flat_kp["mean_diff"]),
        "max_rel_err_ring_vs_plain": max(rel(g_rk[n], g_rp[n]) for n in g_rk),
        "max_rel_gap_flat_vs_plain": max(rel(g_fk[n], g_fp[n]) for n in g_fk),
        "worst_param_vs_its_tol": worst,
        "loss_ring_vs_flat": loss_gap(nll_rk, nll_fk),
        "max_rel_dist_ring_vs_flat": max(rel(g_rk[n], g_fk[n]) for n in g_rk),
    })
    del ring, flat, g_rk, g_rp, g_fk, g_fp
    torch.cuda.empty_cache()
    emit({"phase": "ring_check", "seed": seed, "rows": rows, "ok": ok})
    if strict and not ok:
        raise AssertionError(f"ring step off its references: {rows}")
    return ok, rows


def ring_inputs(torch, n: int):
    """q, k, v, dO of the hop shape's width over a ring of n chunks:
    [1, n·4096, 8, 128] float32, drawn on the CPU from SEED."""
    b, c, _, h, d, _ = HOP_SHAPE
    gen = torch.Generator().manual_seed(SEED + 3)
    return [torch.randn(b, n * c, h, d, generator=gen) for _ in range(4)]


def ring_nccl_worker(out_dir: str) -> int:
    """One rank of the process ring (chip_smoke.py --ring-nccl-worker DIR,
    with the TPUJOB_* env contract): this rank's chunk of ring_inputs
    through ring_flash_attention on the gang's sp ring, forward and
    backward, saved with what `initialize_from_env` decided (backend,
    card) for the parent as DIR/ring<rank>.pt."""
    import torch

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, distributed, initialize_from_env

    pe = initialize_from_env()
    try:
        mesh = build_mesh(MeshSpec(sp=-1))
        n, r = pe.num_processes, pe.process_id
        c = HOP_SHAPE[1]
        device = distributed.started()["device"]
        q, k, v, do = (x[:, r * c:(r + 1) * c].to(device) for x in ring_inputs(torch, n))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ring_flash_attention(q, k, v, mesh, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        torch.save({"o": o.detach().cpu(), "dq": q.grad.cpu(), "dk": k.grad.cpu(),
                    "dv": v.grad.cpu(), "started": distributed.started()},
                   os.path.join(out_dir, f"ring{r}.pt"))
    finally:
        distributed.shutdown()
    return 0


def ring_nccl_phase(torch) -> None:
    """The sp ring over processes, started through the TPUJOB_* contract
    (`testing/gang.run_gang`): with two or more cards, min(4, count)
    processes, one card each, on NCCL; with one card, GANG["ranks"]
    processes sharing it, on gloo (`parallel/distributed.choose_backend`:
    the ranks outnumber the cards; the ring's send/receive goes through
    host memory). They run ring flash attention at the hop shape's
    chunk, forward and backward, and each rank's output and gradients
    must match the in-process ring's on the same inputs, with the
    backward kernels' f32 tolerance. In f32, because the fused kernel's
    atomics add in an order that changes from run to run: in bf16 each
    hop's dq is rounded before the hops are summed, so that order can
    flip one bf16 ulp of a hop's dq, more than a relative bound on the
    smaller total allows. The backend is the one the workers report."""
    import tempfile

    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh
    from kubeflow_tpu_torch.testing.gang import run_gang

    count = torch.cuda.device_count()
    n = min(4, count) if count > 1 else GANG["ranks"]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        runs = run_gang([sys.executable, os.path.abspath(__file__), "--ring-nccl-worker",
                         out_dir], n, timeout=300)
        seconds = time.perf_counter() - t0
        if any(rc for rc, _ in runs):
            raise AssertionError("ring_nccl workers failed:\n" +
                                 "\n".join(text for _, text in runs))
        parts = [torch.load(os.path.join(out_dir, f"ring{r}.pt"), weights_only=True)
                 for r in range(n)]
    q, k, v, do = (x.cuda() for x in ring_inputs(torch, n))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = ring_flash_attention(q, k, v, build_mesh(MeshSpec(sp=n)), causal=True)
    o.backward(do)
    want = {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    rows, ok = {}, True
    for key, w in want.items():
        got = torch.cat([p[key] for p in parts], dim=1).cuda()
        good, err, atol, rtol = bwd_close(got, w, "float32")
        ok &= good
        rows[key] = {"max_abs_err": err, "tol_atol_rtol": [atol, rtol]}
    emit({"phase": "ring_nccl", "run": True, "gpus": count, "ranks": n,
          "backend": parts[0]["started"]["backend"], "started": [p["started"] for p in parts],
          "shape_b_s_h_d": list(q.shape), "seconds": seconds, "rows": rows, "ok": ok})
    if not ok:
        raise AssertionError(f"process ring off the in-process ring: {rows}")


def gang_worker(out_dir: str) -> int:
    """One rank of the gang phase's parity (chip_smoke.py --gang-worker
    DIR, with the TPUJOB_* env contract): on each of GANG's meshes, the
    full-width f32 LM from SEED, its rows of train_check's batch and one
    gradient step of the Trainer on the process mesh (ZeRO-3 at fsdp);
    the loss and the gradients, gathered whole, against train_check's
    one-process step in DIR/reference.pt; the step's seconds, its
    seconds in collectives, its peak memory and its flash launches; then
    one whole adamw step: its seconds, its peak memory and the memory
    the rank holds after it."""
    import torch

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, distributed, initialize_from_env
    from kubeflow_tpu_torch.train import SyntheticTokens, TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pe = initialize_from_env()
    device = torch.device(distributed.started()["device"])
    ref = torch.load(os.path.join(out_dir, "reference.pt"), weights_only=True)
    out = {"rank": pe.process_id, "started": distributed.started(), "meshes": {}}
    for name, spec in GANG["meshes"].items():
        mesh = build_mesh(MeshSpec(**spec))
        trainer = Trainer(
            TransformerLM(TransformerConfig(**LM, dtype=torch.float32, remat_policy="none"),
                          device=device, seed=SEED, mesh=mesh),
            TrainConfig(batch_size=TRAIN["batch"], learning_rate=TRAIN["lr"],
                        total_steps=10_000, optimizer="adamw", label_smoothing=0.0,
                        fsdp_params=True, train_metrics="loss"),
            input_key="tokens", label_key="labels", device=device)
        state = trainer.init_state()
        batch = next(iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                          seed=SEED, device=device, mesh=mesh)))
        step = trainer.make_grad_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.launches.clear()
        trainer.collective_seconds()
        t0 = time.perf_counter()
        metrics, grads = step(state, batch)
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        collective_s = trainer.collective_seconds()
        grad_peak = torch.cuda.max_memory_allocated()
        grads = trainer.gather_params(grads)
        errs = {n: rel(g, ref["grads"][n].to(device)) for n, g in grads.items()}
        ref_loss = float(ref["loss"])
        del grads
        # A whole adamw step (ZeRO-3's saving is the state kept between
        # steps: the shards and their moments, no whole parameter).
        train_step = trainer.make_train_step()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        adamw_s = time.perf_counter() - t1
        out["meshes"][name] = {
            "rows": list(batch["tokens"].shape), "loss": loss, "loss_one_process": ref_loss,
            "loss_err_rel": abs(loss - ref_loss) / abs(ref_loss),
            "max_grad_rel_err": max(errs.values()), "worst_param": max(errs, key=errs.get),
            "params": len(errs), "sharded": len(trainer.sharded),
            "step_s": seconds, "collective_s": collective_s,
            "peak_memory_gib": grad_peak / 2**30,
            "launches": launches,
            "adamw_step_s": adamw_s,
            "adamw_step_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "between_steps_gib": torch.cuda.memory_allocated() / 2**30,
        }
        # The step closures hold the trainer and its model: drop them too,
        # or the next mesh's readings carry this one's parameters.
        del trainer, state, batch, step, train_step
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{pe.process_id}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def gang_parity_phase(torch, card: str, reference: str) -> dict:
    """The gang phase's parity (a): two ranks started through the
    TPUJOB_* contract (`testing/gang.run_gang`) take one f32 step of the
    full-width LM on their rows of train_check's batch at dp = 2 and at
    fsdp = 2 (ZeRO-3: parameters sharded, gradients reduce-scattered),
    from the same weights; on one card the ranks share it over gloo.
    Each rank's global loss and its gradients, gathered whole, are held
    to train_check's one-process f32 step on the whole batch with
    train_check's f32 limits: |loss difference| <= 1e-4·|loss|, every
    gradient within relative norm 1e-4; every rank launches the flash
    forward, delta and fused backward kernels. Numbers per rank and
    mesh: the step's s, its s in collectives, its peak memory, its
    launches; an adamw step's s and peak memory and the memory held
    between steps, which must be less at fsdp = 2 than at dp = 2.
    Returns the phase's line."""
    from kubeflow_tpu_torch.testing.gang import run_gang

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = os.path.dirname(reference)
    t0 = time.perf_counter()
    runs = run_gang([sys.executable, os.path.abspath(__file__), "--gang-worker", out_dir],
                    GANG["ranks"], timeout=GANG["parity_timeout_s"])
    seconds = time.perf_counter() - t0
    if any(rc for rc, _ in runs):
        raise AssertionError("gang workers failed:\n" + "\n".join(text for _, text in runs))
    ranks = []
    for r in range(GANG["ranks"]):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    checks = {}
    for name in GANG["meshes"]:
        rows = [rk["meshes"][name] for rk in ranks]
        checks[f"{name}_loss"] = all(m["loss_err_rel"] <= 1e-4 for m in rows)
        checks[f"{name}_grads"] = all(m["max_grad_rel_err"] <= 1e-4 for m in rows)
        checks[f"{name}_launches"] = all(
            m["launches"].get(k, 0) == LM["n_layers"]
            for m in rows for k in ("flash_fwd", "flash_delta", "flash_bwd_fused"))
    checks["fsdp2_sharded"] = all(rk["meshes"]["fsdp2"]["sharded"] > 0 for rk in ranks)
    checks["fsdp2_keeps_less_between_steps"] = all(
        rk["meshes"]["fsdp2"]["between_steps_gib"] < rk["meshes"]["dp2"]["between_steps_gib"]
        for rk in ranks)
    line = {"phase": "gang_parity", "card": card, "backend": ranks[0]["started"]["backend"],
            "started": [rk["started"] for rk in ranks], "model": {**LM, "dtype": "float32"},
            "global_batch": [TRAIN["batch"], TRAIN["seq"]],
            "ranks": [rk["meshes"] for rk in ranks],
            "limits": {"loss_rel": 1e-4, "grad_rel": 1e-4}, "checks": checks,
            "seconds": seconds}
    emit(line)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"gang parity checks failed: {failed}")
    return line


def loss_seeds(torch, n: int) -> None:
    """chip_smoke.py --loss-seeds N: train_check and ring_check for the
    seeds 0..N-1 of weights and tokens, none of them raising, then one
    line with each seed's bf16 loss statistics: the z-scores that
    `bf16_loss_ok` holds to LOSS_Z, the per-token norm ratios it holds
    to 2, and the mean-loss ratios of the pairs (checked over reference),
    for the readings LOSS_Z is set from."""
    seeds = []
    for seed in range(n):
        t_ok, (t_row, _) = train_check_phase(torch, seed, strict=False)
        r_ok, (_, r_row) = ring_check_phase(torch, seed, strict=False)
        kp, pd = t_row["loss_kernel_vs_plain"], t_row["loss_plain_vs_dense"]
        rkp, fkp = r_row["loss_ring_kernel_vs_plain"], r_row["loss_flat_kernel_vs_plain"]
        seeds.append({
            "seed": seed, "train_check_ok": t_ok, "ring_check_ok": r_ok,
            "train_z_kernel_vs_plain": kp["z"], "train_z_plain_vs_dense": pd["z"],
            "train_token_rel_ratio": ratio(kp["token_rel"], pd["token_rel"]),
            "train_mean_loss_ratio": ratio(kp["mean_diff"], pd["mean_diff"]),
            "ring_z_kernel_vs_plain": rkp["z"], "flat_z_kernel_vs_plain": fkp["z"],
            "ring_token_rel_ratio": ratio(rkp["token_rel"], fkp["token_rel"]),
            "ring_mean_loss_ratio": ratio(rkp["mean_diff"], fkp["mean_diff"]),
        })
    z_keys = [k for k in seeds[0] if "_z_" in k]
    emit({"phase": "loss_seeds", "seeds": seeds, "loss_z": LOSS_Z,
          "max_abs_z": max(abs(row[k]) for row in seeds for k in z_keys),
          "max_token_rel_ratio": max(max(row["train_token_rel_ratio"],
                                         row["ring_token_rel_ratio"]) for row in seeds)})


# -- ResNet-50: trained through fit(), served from its checkpoint -----------


def resnet_groups(name: str) -> str:
    """A ResNet step's kernel → its group: convolutions (cuDNN's implicit
    GEMMs and their layout transforms, and the Dense's GEMM), batch norm,
    the optimizer's multi-tensor kernels, elementwise kernels (ReLU,
    residual adds, casts, the guard's selects) and the rest (pooling,
    reductions, the loss)."""
    low = name.lower()
    if "batch_norm" in low or "bn_" in low:
        return "batch_norm"
    if any(t in low for t in ("conv", "xmma", "implicit", "cudnn", "gemm", "nvjet",
                              "cutlass", "nhwc", "nchw", "winograd", "fft")):
        return "conv"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def resnet_train_flops(torch, model) -> float:
    """Training FLOPs per image of `model` at RESNET["image"]: 2 per
    multiply-add of every convolution and the Dense in the forward
    (their output shapes read by hooks over one image), times 3 for the
    forward and the two products of the backward. Batch norm, ReLU,
    pooling and the optimizer are not counted."""
    from kubeflow_tpu_torch.models import resnet

    macs = []

    def count(module, args, out):
        w = module.weight
        macs.append(out[0].numel() * w[0].numel())  # per output element: fan-in

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (resnet.Conv, resnet.Dense))]
    try:
        with torch.no_grad():
            side = RESNET["image"]
            model.eval()
            model(torch.zeros(1, side, side, 3, device=model.Dense_0.weight.device))
    finally:
        for hook in hooks:
            hook.remove()
    return 3 * 2 * float(sum(macs))


def resnet_model(torch, dtype, device=None, seed: int = SEED):
    from kubeflow_tpu_torch.models import resnet50

    return resnet50(RESNET["classes"], dtype=dtype, device=device or DEVICE, seed=seed)


def resnet_trainer(torch, batch: int, guard=None):
    """The bench's ResNet-50 training setup (bench.py:343-364): bf16
    compute over f32 params, SGD-Nesterov momentum 0.9, lr 0.4, weight
    decay 1e-4 on matrices, label smoothing 0.1."""
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    config = TrainConfig(batch_size=batch, learning_rate=RESNET["lr"],
                         total_steps=10_000, fsdp_params=False)
    return Trainer(resnet_model(torch, torch.bfloat16), config, device=DEVICE, guard=guard)


def resnet_images(torch, batch: int, vary: bool):
    from kubeflow_tpu_torch.train import SyntheticImages

    return SyntheticImages(batch, RESNET["image"], RESNET["classes"], seed=SEED,
                           dtype=torch.bfloat16, vary_per_step=vary, device=DEVICE)


def resnet_state(torch, model, opt_state) -> dict:
    """Copies of the parameters, the momentum and the running statistics."""
    return {
        "params": {n: p.detach().clone() for n, p in model.named_parameters()},
        "momentum": {n: t.clone() for n, t in opt_state["trace"].items()},
        "batch_stats": {n: b.clone() for n, b in model.named_buffers()},
    }


def same_state(a: dict, b: dict) -> bool:
    return all(bool((a[g][n] == b[g][n]).all()) for g in a for n in a[g])


def resnet_check_model(torch):
    """resnet_check's f32 ResNet-50 on the CPU: flax's initialisation
    from SEED, its BatchNorms moved off their init (`move_batch_norm`)."""
    return move_batch_norm(torch, resnet_model(torch, torch.float32, device="cpu"), SEED)


def move_batch_norm(torch, model, seed: int):
    """`model` with the last BatchNorm of each block scaled to 0.2
    (+-0.05) instead of 0, and every BatchNorm's bias and running
    statistics moved off 0/0/1, drawn from `seed` on the CPU."""
    from kubeflow_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, resnet.BatchNorm):
                shape = bn.weight.shape
                if bn.zero_init:
                    bn.weight.copy_(0.2 + 0.05 * torch.randn(shape, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(shape, generator=gen))
                bn.running_mean.copy_(0.1 * torch.randn(shape, generator=gen))
                bn.running_var.copy_(1 + 0.5 * torch.rand(shape, generator=gen))
    return model


def resnet_check_batch(n: int):
    """resnet_check's NHWC f32 images (standard normal) and labels, from
    SEED."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, RESNET["image"], RESNET["image"], 3)).astype(np.float32)
    return x, rng.integers(0, RESNET["classes"], n)


def resnet_check_phase(torch, card: str) -> None:
    """ResNet-50 at full width in f32, batch RESNET_CHECK["batch"] at
    224, one training-mode forward and backward of the train step's loss
    (smoothing 0.1) on the card (TF32 off) and on the CPU in this process
    (the CPU path is the one the tier-1 tests hold to JAX), on
    `resnet_check_model`'s weights, so that every block and every
    gradient takes part. Limits, card against CPU: logits, loss and
    the updated running statistics atol = rtol = 1e-3 (both f32; cuDNN
    and oneDNN sum in other orders). Gradients: the same step in float64
    on the CPU is the reference, since f32 itself lies ~2e-3 from it by
    relative norm: a ReLU whose input lies within f32's rounding of 0
    takes the other side in f32 (one of the ~1e5 active units of a layer
    moves that layer's input gradient by ~1/sqrt(1e5)), and batch norm's
    backward spreads that to every gradient below it. The card's
    gradients, by relative norm to float64, lie within twice the CPU
    f32's, tensor for tensor at the worst and at the median. The bf16
    model on the same weights: its training-mode logits lie within twice
    the CPU bf16 forward's distance from the CPU f32 forward (relative
    norm), the rule the tier-1 tests hold the CPU's bf16 to JAX's by."""
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    t0 = time.perf_counter()
    n = RESNET_CHECK["batch"]
    cpu = resnet_check_model(torch)
    card_model = resnet_model(torch, torch.float32)
    card_model.load_state_dict(cpu.state_dict())
    exact = resnet_model(torch, torch.float64, device="cpu").double()
    exact.load_state_dict({k: v.double() for k, v in cpu.state_dict().items()})
    x, y = resnet_check_batch(n)

    def step(model, device):
        model.train()
        model.zero_grad(set_to_none=True)
        logits = model(torch.tensor(x, device=device))
        loss = softmax_cross_entropy(logits, torch.tensor(y, device=device), 0.1)
        loss.backward()
        out = {"logits": logits.detach().cpu(), "loss": loss.detach().cpu(),
               "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
               "stats": {k: b.cpu() for k, b in model.named_buffers()}}
        model.zero_grad(set_to_none=True)
        return out

    t_cpu = time.perf_counter()
    want = step(cpu, "cpu")
    cpu_s = time.perf_counter() - t_cpu
    got = step(card_model, DEVICE)
    ref = step(exact, "cpu")

    def rel64(a, b):
        return float((a.double() - b).norm() / b.norm())

    zero_grads = [k for k, g in ref["grads"].items() if float(g.norm()) == 0]
    card_rel = {k: rel64(got["grads"][k], g) for k, g in ref["grads"].items()}
    cpu_rel = {k: rel64(want["grads"][k], g) for k, g in ref["grads"].items()}
    grad_rel = {k: rel(got["grads"][k], g) for k, g in want["grads"].items()}
    stat_err = max(float((got["stats"][k] - s).abs().max()) for k, s in want["stats"].items())
    median = lambda d: float(np.median(list(d.values())))
    checks = {
        "logits": close(got["logits"], want["logits"], 1e-3, 1e-3),
        "loss": close(got["loss"], want["loss"], 1e-3, 1e-3),
        "stats": all(close(got["stats"][k], s, 1e-3, 1e-3) for k, s in want["stats"].items()),
        "grads": (not zero_grads and max(card_rel.values()) <= 2 * max(cpu_rel.values())
                  and median(card_rel) <= 2 * median(cpu_rel)),
    }
    # The bf16 model on the same weights, training-mode forward, on the
    # card and on the CPU (whose bf16 the tier-1 tests hold to JAX's).
    bf16 = resnet_model(torch, torch.bfloat16)
    bf16.load_state_dict(cpu.state_dict())
    bf16.train()
    bf16_cpu = resnet_model(torch, torch.bfloat16, device="cpu")
    bf16_cpu.load_state_dict(cpu.state_dict())
    bf16_cpu.train()
    with torch.no_grad():
        logits16 = bf16(torch.tensor(x, device=DEVICE)).cpu()
        logits16_cpu = bf16_cpu(torch.tensor(x)).cpu()
    bf16_gap = rel(logits16, got["logits"])
    bf16_limit = 2 * rel(logits16_cpu, want["logits"])
    checks["bf16_logits"] = bf16_gap <= bf16_limit
    worst = max(card_rel, key=card_rel.get)
    out = {
        "phase": "resnet_check", "model": "resnet50", "dtype": "float32", "batch": n,
        "image": RESNET["image"], "tf32": False,
        "logits_max_abs_err": float((got["logits"] - want["logits"]).abs().max()),
        "logits_max_abs": float(want["logits"].abs().max()),
        "loss": float(want["loss"]), "loss_abs_err": float((got["loss"] - want["loss"]).abs()),
        "grad_vs_f64_card_max": card_rel[worst], "grad_worst": worst,
        "grad_vs_f64_cpu_max": max(cpu_rel.values()),
        "grad_vs_f64_card_median": median(card_rel),
        "grad_vs_f64_cpu_median": median(cpu_rel),
        "grad_card_vs_cpu_max": max(grad_rel.values()),
        "grads_checked": len(card_rel), "zero_grads": zero_grads,
        "stats_max_abs_err": stat_err,
        "bf16_vs_f32_logits_max_abs": float((logits16 - got["logits"]).abs().max()),
        "bf16_vs_f32_logits_rel_norm": bf16_gap,
        "cpu_bf16_vs_f32_logits_rel_norm": rel(logits16_cpu, want["logits"]),
        "cpu_f32_vs_f64_logits_rel_norm": rel(want["logits"], ref["logits"]),
        "limits": {"logits_stats_loss_atol_rtol": [1e-3, 1e-3],
                   "grad_vs_f64": "card <= 2x cpu f32, max and median",
                   "bf16_logits_rel_norm": bf16_limit},
        "checks": checks, "cpu_step_s": cpu_s,
        "seconds": time.perf_counter() - t0, "card": card,
    }
    emit(out)
    del cpu, card_model, bf16, bf16_cpu, exact
    torch.cuda.empty_cache()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resnet_check failed: {failed}")


def resnet_train_phase(torch, card: str) -> float:
    """ResNet-50 trained as `bench.py`'s default run trains it: batch
    RESNET["batch"] of bf16 SyntheticImages (one batch, as the bench),
    SGD; RESNET["warmup_steps"] warm-up steps, then RESNET["timed_steps"]
    timed steps ending in a sync; step time, images/s, peak memory and a
    profile of one step with device time by group (`resnet_groups`). The
    flash kernels' counters are read too: the ResNet path launches none.
    Returns the step's ms."""
    from kubeflow_tpu_torch.ops import _kernels

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = RESNET["batch"]
    trainer = resnet_trainer(torch, batch)
    flops_per_image = resnet_train_flops(torch, trainer.model)
    state, step = trainer.init_state(), trainer.make_train_step()
    data = iter(resnet_images(torch, batch, vary=False))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _kernels.launches.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(RESNET["warmup_steps"]):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    n = RESNET["timed_steps"]
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    profile = profile_device(torch, lambda: step(state, next(data)), resnet_groups,
                             RESNET_GROUPS)
    launches = dict(_kernels.launches)
    losses = [float(v) for v in losses]
    out = {
        "phase": "resnet_train", "model": "resnet50", "dtype": "bfloat16",
        "batch": batch, "image": RESNET["image"], "optimizer": "sgd",
        "learning_rate": RESNET["lr"], "init_s": init_s, "warmup_s": warmup_s,
        "timed_steps": n, "step_ms": step_s * 1e3, "images_per_s": batch / step_s,
        "flops_per_image": flops_per_image,
        "tflops_per_s": batch * flops_per_image / step_s / 1e12,
        "mfu": batch * flops_per_image / step_s / PEAK_FLOPS["bfloat16"],
        "losses": losses, "flash_launches": launches,
        "profile_one_step": profile,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card,
    }
    emit(out)
    del trainer, state, step
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite ResNet loss: {losses}")
    if launches:
        raise AssertionError(f"the ResNet path launched flash kernels: {launches}")
    return step_s * 1e3


def resnet_fit_phase(torch, card: str, root: str) -> int:
    """ResNet-50 through `fit()` at batch RESNET_FIT["batch"] with an
    AnomalyGuard and a Checkpointer in `root` (cuDNN pinned to
    deterministic algorithms for the phase, so that a step repeats
    bitwise): an uninterrupted RESNET_FIT["steps"]-step run; a run that
    saves every RESNET_FIT["save_every"] steps and gets a SIGTERM at step
    RESNET_FIT["sigterm_at"] (`Preempted` at the next step, after its
    save); a resumed run to the end, bitwise equal to the uninterrupted
    one in parameters, momentum and running statistics; then one more
    step through fit() whose input is multiplied by NaN: skipped, with
    parameters, momentum and running statistics bitwise unchanged. Save
    and restore seconds and the checkpoint's size. Returns the newest
    step in `root`/ckpt, which resnet_serve serves."""
    import signal

    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import AnomalyGuard, Preempted, fit

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    steps, save_every, sigterm_at = (RESNET_FIT[k] for k in ("steps", "save_every",
                                                             "sigterm_at"))
    trainer = resnet_trainer(torch, RESNET_FIT["batch"], guard=AnomalyGuard())
    stream = lambda: Tape(resnet_images(torch, RESNET_FIT["batch"], vary=True))
    ckpt_dir = os.path.join(root, "ckpt")
    checks = {}

    def sigterm(step, rec):
        if step == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _kernels.launches.clear()
        straight = fit(trainer, stream(), steps, rng=SEED, log_every=1)
        want = resnet_state(torch, trainer.model, straight.state.opt_state)
        step_ms = [RESNET_FIT["batch"] / rec["examples_per_sec"] * 1e3
                   for rec in straight.history[1:]]
        losses = [rec["loss"] for rec in straight.history]
        del straight

        ckpt = timed_checkpointer(ckpt_dir, save_interval_steps=save_every, max_to_keep=2)
        first = fit(trainer, stream(), steps, rng=SEED, checkpointer=ckpt, log_every=1,
                    on_metrics=sigterm)
        checks["preempted"] = (isinstance(first, Preempted)
                               and first.signum == signal.SIGTERM
                               and int(first.state.step) == sigterm_at + 1
                               and ckpt.all_steps() == [sigterm_at + 1])
        del first
        ckpt2 = timed_checkpointer(ckpt_dir, save_interval_steps=save_every, max_to_keep=2)
        tape = stream()
        resumed = fit(trainer, tape, steps, rng=SEED + 1, checkpointer=ckpt2, log_every=1)
        got = resnet_state(torch, trainer.model, resumed.state.opt_state)
        checks["resumed"] = (resumed.resumed_from == sigterm_at + 1
                             and int(resumed.state.step) == steps
                             and tape.positions == list(range(sigterm_at + 1, steps)))
        checks["resume_bitwise"] = same_state(got, want)
        del resumed, got
        step_dir = os.path.join(ckpt_dir, str(steps))
        ckpt_bytes = {name: os.path.getsize(os.path.join(step_dir, name))
                      for name in os.listdir(step_dir)}

        # One step through fit() with its input multiplied by NaN.
        hook = trainer.model.register_forward_pre_hook(
            lambda module, args: (args[0] * float("nan"),))
        ckpt3 = timed_checkpointer(ckpt_dir, save_interval_steps=save_every, max_to_keep=2)
        try:
            poisoned = fit(trainer, stream(), steps + 1, checkpointer=ckpt3, log_every=1,
                           handle_signals=False)
        finally:
            hook.remove()
        rec = poisoned.history[-1]
        after = resnet_state(torch, trainer.model, poisoned.state.opt_state)
        checks["poison_skipped"] = (
            poisoned.resumed_from == steps and rec["guard_skipped_total"] == 1
            and not np.isfinite(rec["loss"]) and int(poisoned.state.step) == steps + 1
            and same_state(after, want))
        newest = ckpt3.latest_step()
        del poisoned, after, want
        launches = dict(_kernels.launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = {key: ckpt.seconds[key] + ckpt2.seconds[key] + ckpt3.seconds[key]
               for key in ckpt.seconds}
    checks["no_flash_launches"] = not launches
    out = {
        "phase": "resnet_fit", "model": "resnet50", "dtype": "bfloat16",
        "batch": RESNET_FIT["batch"], "steps": steps, "save_every": save_every,
        "sigterm_at": sigterm_at, "optimizer": "sgd", "guard": True,
        "cudnn_deterministic": True, "checks": checks, "losses": losses,
        "fit_step_ms": step_ms, "checkpoint_mb": sum(ckpt_bytes.values()) / 1e6,
        "checkpoint_files_mb": {k: v / 1e6 for k, v in ckpt_bytes.items()},
        "save_block_s": seconds["save_block"], "save_write_s": seconds["save_write"],
        "restore_s": seconds["restore"], "newest_step": newest,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.perf_counter() - t_phase, "card": card,
    }
    emit(out)
    del trainer
    torch.cuda.empty_cache()
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resnet_fit checks failed: {failed}")
    return newest


def record_spec():
    from kubeflow_tpu_torch.train.records import RecordSpec

    side = RESNET["image"]
    return RecordSpec.of(image=("uint8", (side, side, 3)), label=("int32", ()))


def write_record_file(path: str) -> dict:
    """RECORDS["records"] records of `record_spec()` from SEED (uniform
    uint8 pixels, labels in [0, RESNET["classes"])) through the port's
    writer; returns the seconds and the file's size."""
    from kubeflow_tpu_torch.native.dataloader import RecordWriter

    spec, side, chunk = record_spec(), RESNET["image"], RECORDS["batch"]
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    with RecordWriter(path, spec.record_bytes) as writer:
        for start in range(0, RECORDS["records"], chunk):
            n = min(chunk, RECORDS["records"] - start)
            images = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
            labels = rng.integers(0, RESNET["classes"], n).astype(np.int32)
            for i in range(n):
                writer.append(spec.encode({"image": images[i], "label": labels[i]}))
    return {"write_s": time.perf_counter() - t0, "file_mb": os.path.getsize(path) / 1e6}


def records_dataset(path: str):
    from kubeflow_tpu_torch.train.records import RecordDataset

    return RecordDataset(path, record_spec(), RECORDS["batch"],
                         shuffle_buffer=RECORDS["shuffle_buffer"], seed=SEED, epochs=0)


def records_iter(path: str):
    """The records' batches on DEVICE."""
    return records_dataset(path).device_iter(DEVICE)


def records_fit_phase(torch, card: str, root: str, synthetic_step_ms: float) -> tuple:
    """ResNet-50 trained from record files on disk (main path 6a): the
    file written from SEED into `root`, read by the port's compiled
    loader through `RecordDataset.device_iter()` (pinned host buffers,
    one non-blocking copy a batch, the fields split on the card).

    The loader alone drains RECORDS["loader_batches"] batches into one
    host buffer (batches/s, MB/s); the pinned copy of one batch to the
    card is timed by CUDA events. Then `fit()` at batch 256 with an
    AnomalyGuard, cuDNN deterministic as in resnet_fit: a straight
    RECORDS["steps"]-step run (it crosses an epoch and reshuffles); a
    run that saves every RECORDS["save_every"] steps and gets a SIGTERM
    at RECORDS["sigterm_at"] (`Preempted` at the next step after its
    save); a run resumed from that save, whose fast-forward crosses the
    first epoch's end, bitwise equal to the straight run in parameters,
    momentum and running statistics. The dataset's position equals the
    step at every step of the three runs, and no flash kernel launches.
    Then resnet_train's loop on the records (no guard, cuDNN as
    resnet_train runs it): step ms beside resnet_train's synthetic step
    (`synthetic_step_ms`), and a profile of RECORDS["profiled_steps"]
    steps by group with the device's idle share. Returns the straight
    run's losses and the launch counts."""
    import signal

    from kubeflow_tpu_torch.native.dataloader import RecordLoader
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import AnomalyGuard, Preempted, fit

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch, steps, save_every, sigterm_at = (RECORDS[k] for k in (
        "batch", "steps", "save_every", "sigterm_at"))
    path = os.path.join(root, "train.rec")
    written = write_record_file(path)
    record_bytes = record_spec().record_bytes
    batch_mb = batch * record_bytes / 1e6

    loader = RecordLoader(path, batch, shuffle_buffer=RECORDS["shuffle_buffer"], seed=SEED)
    host = np.empty((batch, record_bytes), np.uint8)
    loader.next(out=host)  # the first batch carries the loader's start
    t0 = time.perf_counter()
    for _ in range(RECORDS["loader_batches"]):
        loader.next(out=host)
    loader_s = time.perf_counter() - t0
    del loader
    pinned = torch.empty((batch, record_bytes), dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = host
    on_card = torch.empty((batch, record_bytes), dtype=torch.uint8, device=DEVICE)
    h2d_ms = cuda_ms(torch, lambda: on_card.copy_(pinned, non_blocking=True), iters=20)
    del pinned, on_card, host

    checks, positions = {}, []

    def track(it, sigterm_at=None):
        def on_metrics(step, rec):
            positions.append((step, it.state_dict()["batches_delivered"]))
            if step == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_metrics

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _kernels.launches.clear()
        trainer = resnet_trainer(torch, batch, guard=AnomalyGuard())
        it = records_iter(path)
        straight = fit(trainer, it, steps, rng=SEED, log_every=1, on_metrics=track(it))
        want = resnet_state(torch, trainer.model, straight.state.opt_state)
        losses = [rec["loss"] for rec in straight.history]
        fit_step_ms = [batch / rec["examples_per_sec"] * 1e3 for rec in straight.history[1:]]
        del straight, it

        ckpt_dir = os.path.join(root, "records-ckpt")
        ckpt = timed_checkpointer(ckpt_dir, save_interval_steps=save_every, max_to_keep=2)
        it = records_iter(path)
        first = fit(trainer, it, steps, rng=SEED, checkpointer=ckpt, log_every=1,
                    on_metrics=track(it, sigterm_at))
        checks["preempted"] = (isinstance(first, Preempted)
                               and first.signum == signal.SIGTERM
                               and int(first.state.step) == sigterm_at + 1
                               and ckpt.all_steps()[-1] == sigterm_at + 1)
        del first, it
        ckpt2 = timed_checkpointer(ckpt_dir, save_interval_steps=save_every, max_to_keep=2)
        it = records_iter(path)
        reposition, fast_forward = it.load_state_dict, {}

        def timed_reposition(state):
            t0 = time.perf_counter()
            reposition(state)
            fast_forward[int(state["batches_delivered"])] = time.perf_counter() - t0

        it.load_state_dict = timed_reposition
        resumed = fit(trainer, it, steps, rng=SEED + 1, checkpointer=ckpt2, log_every=1,
                      on_metrics=track(it))
        got = resnet_state(torch, trainer.model, resumed.state.opt_state)
        epoch_batches = RECORDS["records"] // batch
        checks["resumed"] = (resumed.resumed_from == sigterm_at + 1
                             and int(resumed.state.step) == steps
                             and list(fast_forward) == [sigterm_at + 1])
        checks["fast_forward_crosses_an_epoch"] = sigterm_at + 1 > epoch_batches
        checks["straight_run_crosses_an_epoch"] = steps > epoch_batches
        checks["resume_bitwise"] = same_state(got, want)
        checks["position_is_the_step"] = (
            len(positions) == steps + (sigterm_at + 1) + (steps - sigterm_at - 1)
            and all(step == delivered for step, delivered in positions))
        del resumed, got, want, trainer, it
        launches = dict(_kernels.launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    checks["finite_losses"] = all(np.isfinite(losses))
    checks["no_flash_launches"] = not launches
    torch.cuda.empty_cache()

    # resnet_train's loop, on the records.
    trainer = resnet_trainer(torch, batch)
    state, step = trainer.init_state(), trainer.make_train_step()
    data = iter(records_iter(path))
    for _ in range(RECORDS["warmup_steps"]):
        state, _ = step(state, next(data))
    torch.cuda.synchronize()
    n = RECORDS["timed_steps"]
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, next(data))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    profile = profile_device(
        torch, lambda: [step(state, next(data)) for _ in range(RECORDS["profiled_steps"])],
        resnet_groups, RESNET_GROUPS)
    checks["timed_loss_finite"] = bool(torch.isfinite(metrics["loss"]))
    del trainer, state, step, data
    torch.cuda.empty_cache()
    os.remove(path)
    seconds = {key: ckpt.seconds[key] + ckpt2.seconds[key] for key in ckpt.seconds}
    out = {
        "phase": "records_fit", "model": "resnet50", "dtype": "bfloat16", "batch": batch,
        "records": RECORDS["records"], "record_bytes": record_bytes,
        "shuffle_buffer": RECORDS["shuffle_buffer"], "file": written,
        "loader_batches": RECORDS["loader_batches"],
        "loader_batches_per_s": RECORDS["loader_batches"] / loader_s,
        "loader_mb_per_s": RECORDS["loader_batches"] * batch_mb / loader_s,
        "batch_mb": batch_mb, "h2d_ms": h2d_ms, "h2d_gb_per_s": batch_mb / h2d_ms,
        "steps": steps, "save_every": save_every, "sigterm_at": sigterm_at,
        "cudnn_deterministic_fit": True, "checks": checks, "losses": losses,
        "fit_step_ms": fit_step_ms, "fast_forward_s": fast_forward,
        "save_block_s": seconds["save_block"], "save_write_s": seconds["save_write"],
        "restore_s": seconds["restore"],
        "records_step_ms": step_ms, "synthetic_step_ms": synthetic_step_ms,
        "records_vs_synthetic_step": step_ms / synthetic_step_ms,
        "images_per_s": batch / step_ms * 1e3,
        "profile_steps": RECORDS["profiled_steps"], "profile": profile,
        "flash_launches": launches,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.perf_counter() - t_phase, "card": card,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"records_fit checks failed: {failed}")
    return losses, launches


def percentiles(seconds: list) -> dict:
    ms = sorted(s * 1e3 for s in seconds)
    return {"p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))]}


def serve_instances(n: int, side: int) -> np.ndarray:
    """resnet_serve's `n` distinct float32 instances, side x side x 3,
    from SEED: standard normal images (SyntheticImages' distribution),
    each shifted by a colour offset of its own in [-1, 1], so that the
    served model's answers to any two of them lie far apart."""
    rng = np.random.default_rng(SEED)
    images = rng.standard_normal((n, side, side, 3), dtype=np.float32)
    return images + rng.uniform(-1, 1, (n, 1, 1, 3)).astype(np.float32)


def serve_load_worker(url: str, clients: str, distinct: str, side: str, windows: str,
                      out: str) -> int:
    """chip_smoke.py --serve-load-worker URL CLIENTS DISTINCT SIDE
    WARMUP,WINDOW,PROFILE OUT.npz: in a process of its own (so that the
    clients share no interpreter lock with the server), `clients`
    threads each post one-instance :predict requests (binary frames),
    one after another over `serve_instances(DISTINCT, SIDE)`, from the
    start until WARMUP + WINDOW + 2 x PROFILE seconds have passed. Prints
    "measure" when the warm-up ends, "profile" when the measured window
    ends and "stop" at the end, each on a line of its own, so that the
    server's process can read its counters and run its profiler for
    PROFILE seconds (the other PROFILE seconds leave room for the
    profiler's start). Writes each request's start and end
    (seconds from the start), instance and answer, the windows' bounds
    and the start's `time.perf_counter()` (the system's monotonic clock,
    which the server's process reads too) to OUT.npz."""
    import threading

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.serving import wire

    clients = int(clients)
    warmup, window, profiled = (float(v) for v in windows.split(","))
    bounds = np.cumsum([0.0, warmup, window, 2 * profiled])
    instances = serve_instances(int(distinct), int(side))
    records, failures = [[] for _ in range(clients)], []
    stop = threading.Event()
    t0 = time.perf_counter()

    def client(c):
        k = c
        while not stop.is_set():
            i = k % len(instances)
            k += clients
            body = wire.encode_tensor(instances[i:i + 1])
            start = time.perf_counter() - t0
            try:
                status, _, raw = post(url, body, wire.TENSOR_CONTENT_TYPE,
                                      wire.TENSOR_CONTENT_TYPE)
            except OSError as e:
                failures.append(repr(e))
                return
            if status != 200:
                failures.append(status)
                return
            records[c].append((start, time.perf_counter() - t0, i,
                               wire.decode_tensor(raw)[0]))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for mark, at in zip(("measure", "profile", "stop"), bounds[1:]):
        time.sleep(max(0.0, t0 + at - time.perf_counter()))
        print(mark, flush=True)
    stop.set()
    for t in threads:
        t.join(timeout=600)
    flat = [r for rs in records for r in rs]
    if failures or any(t.is_alive() for t in threads) or not flat:
        print(f"serve load worker: failures {failures[:5]}", file=sys.stderr)
        return 1
    start, end, which, answers = zip(*flat)
    np.savez(out, start=np.array(start), end=np.array(end), which=np.array(which),
             answers=np.stack(answers), bounds=bounds, t0=t0)
    return 0


def window_stats(start, end, lo: float, hi: float) -> dict:
    """Requests in [lo, hi): latency p50/p99 of those that started in
    it, and predictions/s of those that ended in it."""
    began = (start >= lo) & (start < hi)
    done = int(((end >= lo) & (end < hi)).sum())
    return {"seconds": hi - lo, "requests_started": int(began.sum()),
            "predictions_per_s": done / (hi - lo),
            **percentiles(list(end[began] - start[began]))}


def concurrent_load(torch, url: str, clients: int, out: str, queue=None) -> dict:
    """`serve_load_worker` against `url` in a child process, with
    RESNET_SERVE's windows. The measured window gives latency p50/p99,
    predictions/s and (batching on: `queue`) the executions and their
    mean batch. Over the profiled window torch.profiler traces the
    device's activity from this process, where the server runs: its
    busy ms (kernels and copies) and idle share of the time the profiler
    ran, and the predictions/s in that time. Returns those numbers, and the answers with the
    instance each was for."""
    from torch.profiler import ProfilerActivity, profile

    cfg = RESNET_SERVE
    windows = f"{cfg['warmup_s']},{cfg['window_s']},{cfg['profile_s']}"
    counters = lambda: (queue.batches_total.value(model="resnet"),
                        queue.batched_instances_total.value(model="resnet"))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-load-worker", url,
         str(clients), str(cfg["distinct"]), str(RESNET["image"]), windows, out],
        stdout=subprocess.PIPE, stderr=err, text=True,
    )
    marks, prof, profiling = {}, None, False
    try:
        for line in proc.stdout:
            mark = line.strip()
            marks[mark] = counters() if queue is not None else None
            if mark == "profile":
                # The device's activity only: tracing every operator of
                # 64 handler threads would slow the host that bounds them.
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                profiling, t_prof = True, time.perf_counter()
                time.sleep(cfg["profile_s"])
                torch.cuda.synchronize()
                t_stop = time.perf_counter()
                profiling = False
                prof.stop()
        rc = proc.wait(timeout=900)
    finally:
        if profiling:
            prof.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err.seek(0)
    if rc or set(marks) != {"measure", "profile", "stop"}:
        raise AssertionError(f"serve load worker failed: rc {rc}, marks {sorted(marks)}: "
                             f"{err.read()[-2000:]}")
    got = np.load(out)
    start, end, bounds = got["start"], got["end"], got["bounds"]
    result = {"clients": clients, "window": window_stats(start, end, bounds[1], bounds[2])}
    if queue is not None:
        (b0, i0), (b1, i1) = marks["measure"], marks["profile"]
        result["window"]["executions"] = b1 - b0
        result["window"]["mean_batch"] = (i1 - i0) / max(1.0, b1 - b0)
    busy = sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    # The profiler ran from t_prof to t_stop on the worker's clock too.
    lo, hi = t_prof - float(got["t0"]), t_stop - float(got["t0"])
    profiled_ms = (t_stop - t_prof) * 1e3
    result["profiled_window"] = {
        "wall_ms": profiled_ms,
        "predictions_per_s": int(((end >= lo) & (end < hi)).sum()) / (hi - lo),
        "device_busy_ms": busy if busy else "not measured",
        "device_idle_share": max(0.0, 1 - busy / profiled_ms) if busy else "not measured",
    }
    result["answers"] = list(zip(got["which"], got["answers"]))
    return result


def resnet_serve_phase(torch, card: str, ckpt_dir: str, step: int) -> None:
    """The model-server binary's app (`serving.__main__.build_app`, as
    `python -m kubeflow_tpu_torch.serving --model resnet=CKPT_DIR
    --batch-timeout-ms 5` builds it) on resnet_fit's checkpoint, with
    batching on (max_batch RESNET_SERVE["max_batch"], 5 ms), over HTTP
    on a localhost port. Its version must be the checkpoint's step, and
    every answer must match the restored model's own eval forward on the
    same instances: within twice that forward's distance from the same
    weights' f32 forward (bf16 rounds differently at other batch sizes);
    and the closest two instances' answers must lie at least 4x that
    limit apart (2x is what it takes for an answer sent to the wrong
    caller to fail the check). Then `bench.py --workload serving`'s
    numbers: single-instance p50/p99 (Servable.predict), batch-64
    predictions/s on the device path (the model on a batch already on the
    card) and the host path (predict() with the copy in and the logits
    out), and, under RESNET_SERVE["clients"] concurrent one-instance
    clients over HTTP (in a child process: `serve_load_worker`) with
    batching on and off, p50/p99 and predictions/s over the measured
    window and the device's busy time and idle share over the profiled
    one (`concurrent_load`)."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving import ModelServerApp, wire
    from kubeflow_tpu_torch.serving.__main__ import build_app
    from kubeflow_tpu_torch.web import serve

    t_phase = time.perf_counter()
    cfg = RESNET_SERVE
    side = RESNET["image"]
    t0 = time.perf_counter()
    app = build_app([("resnet", ckpt_dir)], max_batch=cfg["max_batch"],
                    batch_timeout_ms=cfg["timeout_ms"], device=DEVICE)
    load_s = time.perf_counter() - t0
    servable = app.repository.get("resnet")
    model = servable.variables
    rng = np.random.default_rng(SEED)
    instances = serve_instances(cfg["distinct"], side)
    with torch.inference_mode():
        direct = model(torch.tensor(instances, device=DEVICE)).float().cpu().numpy()
        f32 = resnet_model(torch, torch.float32)
        f32.load_state_dict(model.state_dict())
        f32.eval()
        exact = f32(torch.tensor(instances, device=DEVICE)).cpu().numpy()
        del f32
    limit = 2 * float(np.abs(direct - exact).max())
    # The closest two instances' answers: an answer that went to the
    # wrong caller lies at least `separation - limit` from the caller's
    # own, so the check below fails it wherever separation > 2 x limit.
    gaps = np.abs(direct[:, None, :] - direct[None, :, :]).max(axis=-1)
    np.fill_diagonal(gaps, np.inf)
    separation = float(gaps.min())

    _kernels.launches.clear()
    servers = {}
    results = {}
    work = tempfile.mkdtemp(prefix="kftpu_serve_")
    try:
        for mode, serving_app in (("batching_on", app),
                                  ("batching_off", ModelServerApp(app.repository))):
            server, thread = serve(serving_app, host="127.0.0.1", port=0)
            servers[mode] = (server, thread)
            url = f"http://127.0.0.1:{server.server_port}/v1/models/resnet:predict"
            if mode == "batching_on":
                # One request makes the model's queue, whose counters the
                # windows read.
                post(url, wire.encode_tensor(instances[:1]), wire.TENSOR_CONTENT_TYPE,
                     wire.TENSOR_CONTENT_TYPE)
            queue = (app._batchers[("resnet", servable.version)]
                     if mode == "batching_on" else None)
            results[mode] = concurrent_load(torch, url, cfg["clients"],
                                            os.path.join(work, f"{mode}.npz"), queue)
    finally:
        for server, thread in servers.values():
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        app.close_batchers()
        shutil.rmtree(work, ignore_errors=True)
    errs = []
    for mode, res in results.items():
        for i, pred in res.pop("answers"):
            errs.append(float(np.abs(pred - direct[i]).max()))
    answers_ok = max(errs) <= limit

    one = rng.random((1, side, side, 3), dtype=np.float32)
    single = []
    for _ in range(cfg["single"]):
        t0 = time.perf_counter()
        servable.predict(one)
        single.append(time.perf_counter() - t0)
    batch = rng.random((cfg["max_batch"], side, side, 3), dtype=np.float32)
    servable.predict(batch)
    device_batch = torch.tensor(batch, device=DEVICE)
    with torch.inference_mode():
        device_ms = cuda_ms(torch, lambda: servable.apply_fn(model, device_batch),
                            cfg["device_reps"])
    t0 = time.perf_counter()
    for _ in range(cfg["host_reps"]):
        servable.predict(batch)
    host_s = (time.perf_counter() - t0) / cfg["host_reps"]
    launches = dict(_kernels.launches)
    checks = {"version": servable.version == step, "answers": answers_ok,
              "answers_told_apart": separation >= 4 * limit,
              "no_flash_launches": not launches}
    out = {
        "phase": "resnet_serve", "model": "resnet50", "dtype": "bfloat16",
        "checkpoint_step": step, "version": servable.version,
        "max_batch": cfg["max_batch"], "batch_timeout_ms": cfg["timeout_ms"],
        "load_and_warmup_s": load_s, "answers_max_abs_err": max(errs),
        "answers_limit": limit, "answers_checked": len(errs),
        "answers_min_separation": separation,
        "single_instance": percentiles(single),
        "device_path_predictions_per_s": cfg["max_batch"] / (device_ms / 1e3),
        "device_path_batch_ms": device_ms,
        "host_path_predictions_per_s": cfg["max_batch"] / host_s,
        "concurrent": results, "checks": checks,
        "seconds": time.perf_counter() - t_phase, "card": card,
    }
    emit(out)
    del app, servable, model
    torch.cuda.empty_cache()
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resnet_serve checks failed: {failed}")



# -- the multi-model front door ------------------------------------------------


def memory_point(torch) -> dict:
    """The caching allocator's allocated and reserved MiB on the card,
    after the device has finished what was queued; then the allocated
    MiB once cuBLAS's workspaces are let go ("tensors_mib"). cuBLAS keeps
    a workspace from the allocator for every thread's handle that has
    run a product, for as long as the process lives: the fleet's request
    and scheduler threads add some, which are not weights. Call only
    while no product runs."""
    torch.cuda.synchronize()
    point = {"allocated_mib": torch.cuda.memory_allocated() / 2**20,
             "reserved_mib": torch.cuda.memory_reserved() / 2**20}
    torch._C._cuda_clearCublasWorkspaces()
    point["tensors_mib"] = torch.cuda.memory_allocated() / 2**20
    return point


def frontdoor_checkpoints(torch, root: str) -> list:
    """FRONTDOOR["resnets"] distinct ResNet-50s (resnet_train's
    configuration, weights from seeds 0, 1, ... with their BatchNorms
    moved off their init, `move_batch_norm`), each written once by the
    port's Checkpointer as step 1 of its own directory, in the layout
    `Servable.from_checkpoint` reads. Returns the directories."""
    from kubeflow_tpu_torch.train import Checkpointer
    from kubeflow_tpu_torch.train.trainer import batch_stats

    dirs = []
    for seed in range(FRONTDOOR["resnets"]):
        model = move_batch_norm(torch, resnet_model(torch, torch.bfloat16, seed=seed), seed)
        directory = os.path.join(root, f"resnet-{seed}")
        ckpt = Checkpointer(directory, save_interval_steps=1)
        ckpt.save(1, {"params": dict(model.named_parameters()),
                      "batch_stats": batch_stats(model)}, force=True)
        ckpt.close()
        dirs.append(directory)
        del model
    return dirs


def frontdoor_lm_tokens():
    """The `lm` probe: one seeded sequence of 2048 tokens, [1, 2048]."""
    return np.random.default_rng(SEED + 1).integers(0, LM["vocab_size"], (1, 2048))


def frontdoor_factory(torch, page_ins: list):
    """The fleet's servable factory, as `bench.py:1100-1110`'s is the
    bench's: "lm" builds serve_phase's LM (bf16, seed SEED, `last_logits`,
    max_batch FRONTDOOR["lm_max_batch"], every bucket warmed at S = 2048:
    3 forwards); every other model goes to the binary's
    `build_servable_from_rspec` (its checkpoint restored into
    `resnet50()`, every bucket up to 64 warmed). Each call's model and
    seconds are appended to `page_ins`."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.serving import Servable
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec

    def factory(rspec):
        t0 = time.perf_counter()
        if rspec["model"] == "lm":
            model = TransformerLM(TransformerConfig(**LM, dtype=torch.bfloat16),
                                  device=DEVICE, seed=SEED)
            servable = Servable("lm", last_logits, model,
                                max_batch=FRONTDOOR["lm_max_batch"], device=DEVICE)
            servable.warmup_with(frontdoor_lm_tokens()[0])
        else:
            servable = build_servable_from_rspec(rspec, device=DEVICE)
        page_ins.append((rspec["model"], time.perf_counter() - t0))
        return servable

    return factory


def frontdoor_references(torch, dirs: list, instance, tokens) -> dict:
    """Each model's answer from a direct eval forward, and its limit.
    ResNet i: a module restored from its checkpoint (the binary's
    factory at max_batch 1) on `instance`; limit: 2x that answer's
    distance from the same weights' f32 forward (resnet_serve's rule).
    The LM: the kernel path, the plain path and the dense path on
    `tokens` (check_phase's rule: 2x the plain-vs-dense gap, held
    against the plain path)."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec

    refs = {}
    x = torch.tensor(instance, device=DEVICE)
    with torch.inference_mode():
        for i, directory in enumerate(dirs):
            name = f"resnet-{i}"
            model = build_servable_from_rspec(
                {"model": name, "checkpointDir": directory, "maxBatch": 1},
                device=DEVICE).variables
            direct = model(x).float().cpu().numpy()
            f32 = resnet_model(torch, torch.float32)
            f32.load_state_dict(model.state_dict())
            exact = f32.eval()(x).cpu().numpy()
            refs[name] = {"answer": direct,
                          "limit": 2 * float(np.abs(direct - exact).max())}
            del model, f32
        model = TransformerLM(TransformerConfig(**LM, dtype=torch.bfloat16),
                              device=DEVICE, seed=SEED)
        t = torch.tensor(tokens, device=DEVICE)
        kernel = last_logits(model, t).float().cpu().numpy()
        with plain_kernels():
            plain = last_logits(model, t).float().cpu().numpy()
        with attention_via(dense_attend):
            dense = last_logits(model, t).float().cpu().numpy()
        refs["lm"] = {"answer": plain, "kernel_path": kernel,
                      "limit": 2 * float(np.abs(plain - dense).max())}
        del model
    return refs


def frontdoor_probe(url: str, model: str, x):
    """One binary-frame :predict through the front door: (answer, s)."""
    from kubeflow_tpu_torch.serving import wire

    t0 = time.perf_counter()
    status, _, raw = post(f"{url}/v1/models/{model}:predict", wire.encode_tensor(x),
                          wire.TENSOR_CONTENT_TYPE, wire.TENSOR_CONTENT_TYPE)
    seconds = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"{model} probe answered {status}: {raw[:300]!r}")
    return wire.decode_tensor(raw), seconds


def lm_page_ins(registries) -> int:
    return sum(r.stats()["models"]["lm"]["page_ins"] for r in registries)


def frontdoor_lm_probe(torch, url: str, registries, tokens) -> dict:
    """Probe `lm` with the launch counters zeroed just before and read
    just after; the flash_fwd launches must be 16 x (forwards served +
    3 warm-up buckets x LM page-ins)."""
    from kubeflow_tpu_torch.ops import _kernels

    before = lm_page_ins(registries)
    _kernels.launches.clear()
    answer, seconds = frontdoor_probe(url, "lm", tokens)
    launches = dict(_kernels.launches)
    page_ins = lm_page_ins(registries) - before
    want = LM["n_layers"] * (1 + 3 * page_ins)
    if launches.get("flash_fwd", 0) != want or set(launches) != {"flash_fwd"}:
        raise AssertionError(f"lm probe launched {launches}; expected flash_fwd {want} "
                             f"(1 forward, {page_ins} page-ins)")
    return {"answer": answer, "seconds": seconds, "page_ins": page_ins,
            "launches": launches}


def frontdoor_load(torch, router, registries, addr: str, total: int, seed: int,
                   measured: bool) -> dict:
    """`testing/loadgen.run_open_loop` against the front door: Poisson
    arrivals at FRONTDOOR["rate"], `total` of them, 4 spawned workers,
    one f32 1 x 224 x 224 x 3 instance per request, the traffic classes
    of `bench.py:1150-1155` (resnet-0..3 hot at weight 4, resnet-4..6
    cold at weight 1, lm not in the mix). The run goes on in a thread
    while this one polls every 20 ms: the residency of each registry,
    and, when `measured`, a `ReplicaKillSchedule(seed, kills=1,
    replicas=2)` whose fraction is the share of this run's requests
    completed (`bench.py:1163-1186`), and the device's busy time in a
    window of FRONTDOOR["profile_s"] from a quarter of the requests on,
    cut from a torch.profiler trace of the device's activity only."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.testing import loadgen
    from kubeflow_tpu_torch.testing.chaos import ReplicaKillSchedule

    cfg = FRONTDOOR
    classes = [loadgen.TrafficClass(f"resnet-{i}", weight=4.0 if i < cfg["hot"] else 1.0)
               for i in range(cfg["resnets"])]
    counters = lambda: {name: getattr(router, f"{name}_total").value()
                        for name in ("acked", "completed", "failed", "shed", "retried")}
    start = counters()
    sched = ReplicaKillSchedule(seed, kills=1, replicas=cfg["replicas"]) if measured else None
    out, kills = {}, []

    def drive():
        try:
            out["report"] = loadgen.run_open_loop(
                {"mode": "http", "addr": addr, "shape": [1, RESNET["image"], RESNET["image"], 3],
                 "timeout_s": 120.0},
                classes, rate=cfg["rate"], total=total, seed=seed, workers=cfg["workers"],
                concurrency=cfg["concurrency"], timeout_s=600.0)
        except BaseException as e:  # surfaced below, on this thread
            out["error"] = e

    t0 = time.perf_counter()
    done = lambda: (router.completed_total.value() - start["completed"]) / total
    seen = {"max_resident": 0}

    def watch():
        # Kills and residency on a thread of their own, polled while
        # this one keeps the profiled window.
        while load.is_alive():
            frac = done()
            kill = sched.due(frac) if sched is not None else None
            if kill is not None:
                ready = router.ready_names()
                victim = ready[kill.victim % len(ready)]
                router.replica(victim).kill()
                sched.mark_injected(kill)
                kills.append({"replica": victim, "at_fraction": frac,
                              "s": time.perf_counter() - t0})
            seen["max_resident"] = max(
                [seen["max_resident"]] + [r.stats()["resident"] for r in registries])
            time.sleep(0.02)

    load = threading.Thread(target=drive, name="frontdoor-load")
    watcher = threading.Thread(target=watch, name="frontdoor-watch")
    window = None
    if measured:
        # Started while the server idles: a start under this load held
        # every CUDA call of the process for seconds. The trace runs
        # through the load; the window is cut from it below.
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        origin = time.perf_counter()
    try:
        load.start()
        watcher.start()
        if measured:
            while load.is_alive() and done() < 0.25:
                time.sleep(0.02)
            window = {"t0": time.perf_counter(), "c0": router.completed_total.value()}
            time.sleep(cfg["profile_s"])
            window["t1"] = time.perf_counter()
            window["c1"] = router.completed_total.value()
    finally:
        load.join()
        watcher.join()
        if measured:
            torch.cuda.synchronize()
            prof.stop()
    max_resident = seen["max_resident"]
    if "error" in out:
        raise out["error"]
    report = out["report"]
    end = counters()
    delta = {name: int(end[name] - start[name]) for name in start}
    hot = [c for c in report.classes if int(c.model.split("-")[1]) < cfg["hot"]]
    cold = [c for c in report.classes if c not in hot]
    result = {
        "offered_rate": report.offered_rate, "achieved_rate": report.achieved_rate,
        "offered_rate_error": report.offered_rate_error, "fired": report.fired,
        "ok": report.ok, "shed": report.shed, "client_errors": report.error,
        "duration_s": report.duration_s, "fire_lag_p99_ms": report.fire_lag_p99_ms,
        "goodput_per_s": report.ok / report.duration_s if report.duration_s else 0.0,
        "goodput_share": report.ok / report.fired if report.fired else 0.0,
        "p50_ms": report.p50_ms, "p99_ms": report.p99_ms,
        # Per-class percentiles; a group's is its worst class's.
        "hot": {"p50_ms": max(c.p50_ms for c in hot), "p99_ms": max(c.p99_ms for c in hot)},
        "cold": {"p50_ms": max(c.p50_ms for c in cold),
                 "p99_ms": max(c.p99_ms for c in cold)},
        "classes": [{"model": c.model, "count": c.count, "ok": c.ok, "shed": c.shed,
                     "error": c.error, "p50_ms": c.p50_ms, "p99_ms": c.p99_ms}
                    for c in report.classes],
        "router": delta, "max_resident_seen": max_resident, "kills": kills,
    }
    if sched is not None:
        result["kill_plan_exhausted"] = sched.exhausted
        result["kill_coverage"] = sched.coverage()
    if measured:
        # Device time inside the window: each kernel's or copy's overlap
        # with it, on the trace's clock (microseconds from its start,
        # which `origin` marks on the host's).
        lo, hi = ((window[k] - origin) * 1e6 for k in ("t0", "t1"))
        busy = sum(max(0.0, min(evt.time_range.end, hi) - max(evt.time_range.start, lo))
                   for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        wall_ms = (window["t1"] - window["t0"]) * 1e3
        result["profiled_window"] = {
            "wall_ms": wall_ms,
            "completed_per_s": (window["c1"] - window["c0"]) / (wall_ms / 1e3),
            "device_busy_ms": busy if busy else "not measured",
            "device_idle_share": max(0.0, 1 - busy / wall_ms) if busy else "not measured",
        }
    return result


def page_in_seconds(page_ins: list) -> dict:
    """Mean and max factory seconds of the page-ins, ResNet-50 and LM."""
    out = {}
    for kind, pick in (("resnet50", lambda m: m != "lm"), ("lm", lambda m: m == "lm")):
        seconds = [s for m, s in page_ins if pick(m)]
        out[kind] = {"count": len(seconds),
                     "mean_s": sum(seconds) / len(seconds) if seconds else None,
                     "max_s": max(seconds) if seconds else None}
    return out


def frontdoor_phase(torch, card: str) -> dict:
    """The multi-model front door at full width on the card, as
    `bench.py:1057-1240` runs it on the TPU: FRONTDOOR["resnets"]
    ResNet-50s from `frontdoor_checkpoints` and serve_phase's LM behind
    FRONTDOOR["replicas"] `MultiModelReplica`s, each its own
    `ServableRegistry` at `PagingConfig(max_resident=5)` with batching at
    64 / 5 ms, brought up through `LocalReplicaRuntime.ensure` from an
    rspec with ``models`` and ``paging.maxResident`` as a controller
    renders it, behind one `Router` (seeded jitter) and one `FrontDoorApp`
    over HTTP on localhost. Every page-in is a real restore through the
    factory (`frontdoor_factory`).

    Every page-in runs on the thread that claimed it: the request's
    HTTP handler thread under load, this one in the page cycles; one
    more page-in from a fresh thread after them shows what a thread's
    first run of the model costs.

    Probes: each model once through the front door (binary frames; a
    ResNet the instance `serve_instances(1, 224)`, the LM
    `frontdoor_lm_tokens`), each held against its direct forward within
    its limit (`frontdoor_references`); the closest two ResNets' answers
    at least 4x the largest limit apart; the LM's flash launches counted
    (`frontdoor_lm_probe`). Load: a 2 s warm-up and an 8 s measured run
    at 150 requests/s (`frontdoor_load`) with one replica killed; failed
    = 0, acked = completed, no client error, the kill plan exhausted, at
    most 5 models resident on a replica, offered-rate error <= 5%. Then
    `lm` and a cold ResNet probed again, each a page-in, equal to their
    first answers within the same limits. Memory (`memory_point`)
    before the phase, with the fleet up, after the load and after the
    fleet closed (gc run): the live tensors at the last within 64 MiB of
    the first. Last, every model paged in twice through one registry at
    max_resident=2: the live tensors after the second cycle within 64
    MiB of the first's. Returns the probes' kernel launches."""
    import threading

    from kubeflow_tpu_torch.serving import FrontDoorApp, LocalReplicaRuntime, Router
    from kubeflow_tpu_torch.serving import BatchingConfig, PagingConfig, ServableRegistry
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
    from kubeflow_tpu_torch.web import serve

    t_phase = time.perf_counter()
    cfg = FRONTDOOR
    # Garbage of the earlier phases (a reference cycle can hold a model)
    # goes now, not inside this phase's readings.
    gc.collect()
    memory = {"before": memory_point(torch)}
    slack = cfg["memory_slack_mib"]
    root = tempfile.mkdtemp(prefix="kftpu_frontdoor_")
    checks, out = {}, {"phase": "frontdoor", "card": card}
    try:
        t0 = time.perf_counter()
        dirs = frontdoor_checkpoints(torch, root)
        out["checkpoints_s"] = time.perf_counter() - t0
        instance = serve_instances(1, RESNET["image"])
        tokens = frontdoor_lm_tokens()
        t0 = time.perf_counter()
        refs = frontdoor_references(torch, dirs, instance, tokens)
        out["references_s"] = time.perf_counter() - t0
        names = [f"resnet-{i}" for i in range(cfg["resnets"])]
        limit = max(refs[n]["limit"] for n in names)
        separation = min(float(np.abs(refs[a]["answer"] - refs[b]["answer"]).max())
                         for i, a in enumerate(names) for b in names[i + 1:])
        checks["resnets_told_apart"] = separation >= 4 * limit
        memory["references_dropped"] = memory_point(torch)

        rspec = {
            "maxBatch": cfg["max_batch"],
            "batching": {"timeoutMs": cfg["timeout_ms"], "maxPending": 1024},
            "models": [{"name": n, "checkpointDir": d} for n, d in zip(names, dirs)]
            + [{"name": "lm"}],
            "paging": {"maxResident": cfg["max_resident"]},
        }
        page_ins: list = []
        factory = frontdoor_factory(torch, page_ins)
        metrics = MetricsRegistry()
        router = Router(metrics, dispatch_timeout_s=120.0, retry_jitter_seed=SEED)
        runtime = LocalReplicaRuntime(router, factory, metrics)
        for r in range(cfg["replicas"]):
            runtime.ensure(f"replica-{r}", rspec)
        registries = [router.replica(n).registry for n in router.replica_names()]
        server, thread = serve(FrontDoorApp(router, metrics=metrics), host="127.0.0.1", port=0)
        addr = f"127.0.0.1:{server.server_port}"
        url = f"http://{addr}"
        try:
            probes, errs = {}, {}
            for name in names:
                answer, seconds = frontdoor_probe(url, name, instance)
                probes[name] = {"answer": answer, "seconds": seconds}
                errs[name] = float(np.abs(answer - refs[name]["answer"]).max())
            lm = frontdoor_lm_probe(torch, url, registries, tokens)
            launches = dict(lm["launches"])
            probes["lm"] = lm
            errs["lm"] = float(np.abs(lm["answer"] - refs["lm"]["answer"]).max())
            checks["probes"] = all(errs[n] <= refs[n]["limit"] for n in names + ["lm"])
            checks["lm_first_probe_paged_in"] = lm["page_ins"] == 1
            out["probes"] = {
                n: {"max_abs_err": errs[n], "limit": refs[n]["limit"],
                    "seconds": probes[n]["seconds"]} for n in names + ["lm"]}
            out["lm_served_vs_kernel_path_bitwise"] = bool(
                np.array_equal(lm["answer"], refs["lm"]["kernel_path"]))
            out["resnet_min_separation"] = separation
            out["resnet_limit"] = limit
            memory["fleet_up"] = memory_point(torch)

            warm = frontdoor_load(torch, router, registries, addr,
                                  int(cfg["rate"] * cfg["warmup_s"]), SEED + 1, measured=False)
            page_ins_before = len(page_ins)
            load = frontdoor_load(torch, router, registries, addr,
                                  int(cfg["rate"] * cfg["window_s"]), SEED, measured=True)
            memory["after_load"] = memory_point(torch)
            out["warmup"] = {k: warm[k] for k in ("ok", "shed", "client_errors", "p99_ms",
                                                  "offered_rate_error")}
            out["load"] = load
            out["page_in_seconds_during_load"] = page_in_seconds(page_ins[page_ins_before:])
            checks.update({
                "failed_0": load["router"]["failed"] == 0 and warm["router"]["failed"] == 0,
                "acked_eq_completed": load["router"]["acked"] == load["router"]["completed"],
                "client_errors_0": load["client_errors"] == 0 and warm["client_errors"] == 0,
                "kill_plan_exhausted": load["kill_plan_exhausted"]
                and load["kill_coverage"] == {"replica_kill": 1},
                "resident_le_max": max(warm["max_resident_seen"], load["max_resident_seen"])
                <= cfg["max_resident"],
                "offered_rate_error_le_5pct": load["offered_rate_error"] <= 0.05,
            })

            # After the load: lm and a cold ResNet again, each a page-in.
            alive = [router.replica(n).registry for n in router.ready_names()]
            lm2 = frontdoor_lm_probe(torch, url, registries, tokens)
            for name, count in lm2["launches"].items():
                launches[name] = launches.get(name, 0) + count
            rows = alive[0].stats()["models"]
            cold = [n for n in names[cfg["hot"]:] if rows[n]["state"] != "resident"]
            if not cold:  # every cold model resident: page one out by hand
                cold = [names[-1]]
                alive[0].kill(cold[0])
            before = sum(r.stats()["models"][cold[0]]["page_ins"] for r in registries)
            again, _ = frontdoor_probe(url, cold[0], instance)
            cold_page_ins = sum(
                r.stats()["models"][cold[0]]["page_ins"] for r in registries) - before
            checks["again_paged_in"] = lm2["page_ins"] == 1 and cold_page_ins == 1
            checks["again_equal"] = (
                float(np.abs(lm2["answer"] - lm["answer"]).max()) <= refs["lm"]["limit"]
                and float(np.abs(again - probes[cold[0]]["answer"]).max())
                <= refs[cold[0]]["limit"])
            out["again"] = {
                "lm_bitwise_equal": bool(np.array_equal(lm2["answer"], lm["answer"])),
                "lm_max_abs_diff": float(np.abs(lm2["answer"] - lm["answer"]).max()),
                "cold_model": cold[0],
                "cold_bitwise_equal": bool(np.array_equal(again, probes[cold[0]]["answer"])),
                "cold_max_abs_diff": float(np.abs(again - probes[cold[0]]["answer"]).max()),
            }
            out["launches"] = launches
            out["page_ins_by_model"] = {
                n: sum(r.stats()["models"][n]["page_ins"] for r in registries)
                for n in names + ["lm"]}
            out["page_outs_by_model"] = {
                n: int(registries[0].page_outs_total.value(model=n)) for n in names + ["lm"]}
            out["page_in_seconds"] = page_in_seconds(page_ins)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            for name in runtime.names():
                runtime.stop(name)
        del router, runtime, registries, factory, server, thread
        gc.collect()
        memory["fleet_closed"] = memory_point(torch)
        checks["memory_back"] = abs(memory["fleet_closed"]["tensors_mib"]
                                    - memory["before"]["tensors_mib"]) <= slack

        # Page cycles: every model in twice through one registry.
        cycle_page_ins: list = []
        registry = ServableRegistry(
            frontdoor_factory(torch, cycle_page_ins),
            batching=BatchingConfig(max_batch=cfg["max_batch"], timeout_ms=cfg["timeout_ms"]),
            paging=PagingConfig(max_resident=cfg["cycle_resident"]))
        try:
            for mspec in rspec["models"]:
                registry.ensure(LocalReplicaRuntime.model_rspec(rspec, mspec))
            for cycle in (1, 2):
                for name in names + ["lm"]:
                    registry.predict(name, tokens if name == "lm" else instance)
                memory[f"page_cycle_{cycle}"] = memory_point(torch)
            # One more page-in, from a thread that never ran the model:
            # PyTorch keeps cuDNN's execution plans per thread.
            fresh = threading.Thread(target=registry.predict, args=(names[0], instance))
            fresh.start()
            fresh.join()
        finally:
            registry.close()
        del registry
        memory["page_cycles_closed"] = memory_point(torch)
        checks["no_growth_across_page_cycles"] = abs(
            memory["page_cycle_2"]["tensors_mib"]
            - memory["page_cycle_1"]["tensors_mib"]) <= slack
        out["page_cycles"] = {"page_ins": len(cycle_page_ins) - 1,
                              "page_in_seconds": page_in_seconds(cycle_page_ins[:-1]),
                              "fresh_thread_page_in_s": cycle_page_ins[-1][1]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update({"memory": memory, "memory_slack_mib": slack, "checks": checks,
                "seconds": time.perf_counter() - t_phase})
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"frontdoor checks failed: {failed}")
    return out["launches"]


# -- the serving control plane -------------------------------------------------


class ClosedLoop:
    """`clients` threads, each sending one-instance requests through
    `router.predict` one after another (instance c, c + clients, ... of
    `instances`) from `start()` until `stop()`. A shed (`Overloaded`)
    waits out its Retry-After and counts; any other exception is a
    client error. Records each request's start and end (seconds from
    `start()`), instance and answer."""

    def __init__(self, router, instances, clients: int):
        self.router, self.instances, self.clients = router, instances, clients
        self.records = [[] for _ in range(clients)]
        self.errors, self.shed = [], [0] * clients
        self._stop = None
        self._threads = []

    def _client(self, c: int) -> None:
        from kubeflow_tpu_torch.serving import Overloaded

        k = c
        while not self._stop.is_set():
            i = k % len(self.instances)
            k += self.clients
            start = time.perf_counter() - self.t0
            try:
                answer = np.asarray(self.router.predict(self.instances[i:i + 1]))[0]
            except Overloaded as e:
                self.shed[c] += 1
                time.sleep(min(e.retry_after, 0.1))
                continue
            except Exception as e:  # a client error: counted, the loop goes on
                self.errors.append(repr(e))
                continue
            self.records[c].append((start, time.perf_counter() - self.t0, i, answer))

    def start(self) -> "ClosedLoop":
        import threading

        self._stop = threading.Event()
        self.t0 = time.perf_counter()
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True)
                         for c in range(self.clients)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> dict:
        """Stop the clients; returns the records as arrays."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in self._threads):
            raise AssertionError("closed-loop clients did not stop")
        flat = [r for rs in self.records for r in rs]
        start, end, which, answers = zip(*flat) if flat else ((), (), (), ())
        return {"start": np.array(start), "end": np.array(end), "which": np.array(which),
                "answers": list(answers), "errors": list(self.errors), "shed": sum(self.shed)}


def router_counts(router) -> dict:
    return {name: int(getattr(router, f"{name}_total").value())
            for name in ("acked", "completed", "failed", "shed", "retried")}


def controller_reference(torch, rspec: dict, instances) -> dict:
    """What the spec's replicas must answer: the servable the binary's
    factory restores from the spec (`build_servable_from_rspec`, the
    checkpoint directory's newest step), its own eval forward on
    `instances` on the card, and resnet_serve's limit: twice that
    forward's distance from the same weights' f32 forward."""
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec

    servable = build_servable_from_rspec(rspec, device=DEVICE)
    model = servable.variables
    with torch.inference_mode():
        x = torch.tensor(instances, device=DEVICE)
        direct = model(x).float().cpu().numpy()
        f32 = resnet_model(torch, torch.float32)
        f32.load_state_dict(model.state_dict())
        f32.eval()
        exact = f32(x).cpu().numpy()
    ref = {"version": servable.version, "answers": direct,
           "limit": 2 * float(np.abs(direct - exact).max())}
    del servable, model, f32, x
    torch.cuda.empty_cache()
    return ref


def held_to(ref: dict, which, answers) -> float:
    """The largest distance of `answers` (to instances `which`) from
    the reference's."""
    return max((float(np.abs(a - ref["answers"][i]).max()) for i, a in zip(which, answers)),
               default=float("inf"))


def probe(router, instances) -> tuple:
    """Every instance once through the router, one request each."""
    which = list(range(len(instances)))
    return which, [np.asarray(router.predict(instances[i:i + 1]))[0] for i in which]


def commit_step(torch, ckpt_dir: str) -> int:
    """One more step of resnet_fit's run (its trainer, guard and stream)
    through `fit()`, resumed from the newest step in `ckpt_dir` and saved
    there: training that goes on beside the fleet. The trainer is let go
    before it returns, so that memory readings see only the fleet.
    Returns the new step."""
    from kubeflow_tpu_torch.train import AnomalyGuard, Checkpointer, fit

    trainer = resnet_trainer(torch, RESNET_FIT["batch"], guard=AnomalyGuard())
    ckpt = Checkpointer(ckpt_dir, save_interval_steps=RESNET_FIT["save_every"], max_to_keep=3)
    stream = Tape(resnet_images(torch, RESNET_FIT["batch"], vary=True))
    result = fit(trainer, stream, ckpt.latest_step() + 1, rng=SEED, checkpointer=ckpt,
                 log_every=1, handle_signals=False)
    ckpt.wait()
    step = int(result.state.step)
    del trainer, result, stream
    torch.cuda.empty_cache()
    return step


def nvidia_smi(query: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    return [line.strip() for line in out.strip().splitlines() if line.strip()]


def compute_apps() -> dict:
    """nvidia-smi's compute processes on the card: pid -> used MiB (as
    nvidia-smi prints it). Empty where the machine hides them (a
    container's own pids are not the host's)."""
    apps = {}
    for line in nvidia_smi("--query-compute-apps=pid,used_memory"):
        pid, _, used = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = used.strip()
    return apps


def compute_app_rows() -> int:
    """How many compute processes nvidia-smi lists on the card (rows, not
    pids: a container may show its processes under one host pid)."""
    return len(nvidia_smi("--query-compute-apps=pid,used_memory"))


def card_used_mib(torch) -> float:
    """nvidia-smi's memory.used of the card, after this process has
    handed its cached blocks and cuBLAS's workspaces back: what the
    other processes on the card hold, beside this one's context and
    live tensors."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return float(nvidia_smi("--query-gpu=memory.used")[0])


def rolled_out_seconds(api, name: str) -> dict:
    """Each ReplicaRolled event's seconds out of rotation, by replica
    (the controller writes them into the event's message)."""
    import re

    out = {}
    for ev in api.list("Event", "default"):
        if ev.spec.get("reason") != "ReplicaRolled" or \
                ev.spec["involvedObject"]["name"] != name:
            continue
        m = re.match(r"(\S+) .*\(([0-9.]+)s out of rotation\)", ev.spec["message"])
        if m:
            out.setdefault(m.group(1), []).append(float(m.group(2)))
    return out


def edit_spec(api, name: str, **changes) -> None:
    from kubeflow_tpu_torch.api import serving as serving_api

    dep = api.get(serving_api.KIND, name, "default").thaw()
    dep.spec = {**dep.spec, **changes}
    api.update(dep)


def wait_for(predicate, timeout: float, what: str, tick=None) -> float:
    """Poll every 20 ms (calling `tick` first) until `predicate()` holds;
    returns the seconds it took. Raises after `timeout`."""
    t0 = time.perf_counter()
    while True:
        if tick is not None:
            tick()
        if predicate():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"controller: timed out after {timeout} s waiting for {what}")
        time.sleep(0.02)


def controller_phase(torch, card: str, ckpt_dir: str, step: int) -> None:
    """The serving control plane at full width on the card, as
    `bench.py:727-1050` drives it with tiny CPU models: a ServingDeployment
    CR reconciled by the port's `ServingDeploymentController` into
    ResNet-50 replicas restored from resnet_fit's checkpoint directory.

    Local fleet (`LocalReplicaRuntime`, the binary's factory on the
    card): the CR at ``modelVersion`` = `step`, 2 replicas, batching 64 /
    5 ms must give 2 owned ServingReplica objects, 2 ready replicas
    serving `step` (runtime and status), and answers through the router
    within resnet_serve's limit of the restored model's own forward.
    Steady: CONTROLLER["clients"] closed-loop clients (`ClosedLoop`) for
    a warm-up and a measured window (p50/p99, predictions/s, the device's
    idle share over a window cut from a trace), no client error, no
    failure. Roll: a second step committed by `fit()`, the spec bumped
    to it, the controller threaded (`ControllerManager`) under the same
    load: both replicas at the new step within 120 s, no failure, at
    least one replica admitting at every 20 ms sample, answers after it
    within the limit of the new step's forward; roll seconds and each
    replica's seconds out of rotation. The endless roll: a third step
    committed after the bump, 10 reconciles, no roll and every replica
    at the spec's step. Scale 2 -> 3 -> 1: replicas start and stop (the
    added one at the spec's step, not the newest), the stopped ones'
    objects are deleted and their weights' memory given back; the CR
    deleted, the live tensors within 64 MiB of the phase's start
    (`memory_point`).

    Process fleet (`ProcessReplicaRuntime` behind `ApiServerApp` over
    HTTP): 2 workers, each `python -m kubeflow_tpu_torch.serving
    --apiserver URL --replica NAME` on the card restoring the newest
    step and batching as the CR says, admitted as `HttpReplica`s (binary
    frames) within 120 s, their answers within the limit, each stamping
    its card memory (`cudaMemoryMiB`); CONTROLLER["process_clients"]
    clients through both workers and then through one (the other
    drained), CONTROLLER["process_compare_s"] each; the same clients for
    CONTROLLER["process_load_s"] with a seeded `ReplicaKillSchedule`
    SIGKILLing one worker: acked = completed, no failure, no client
    error, the worker respawned (a new pid) and admitted; a fourth step
    and a bump: both workers load it themselves (same pids) and answer
    within its limit; a roll back to the third step, the same; after
    each roll each worker's allocated card memory back within 64 MiB of
    its reading at rest after the two-against-one load, and its reserved
    memory not grown by the roll back; the CR deleted: every worker exits, no compute process
    beyond those before them is left in nvidia-smi, and the card's
    memory.used is back within 64 MiB of its reading before them
    (`card_used_mib`). Startup seconds per worker; on a failure, each
    worker's exit code and its ServingReplica's last status go to
    stderr."""
    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.controllers import ControllerManager, ServingDeploymentController
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving import LocalReplicaRuntime, ProcessReplicaRuntime, Router
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec
    from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
    from kubeflow_tpu_torch.web import serve
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg = CONTROLLER
    gc.collect()
    memory = {"before": memory_point(torch)}
    slack = cfg["memory_slack_mib"]
    instances = serve_instances(cfg["distinct"], RESNET["image"])
    checks, out = {}, {"phase": "controller", "card": card, "checkpoint_step": step}
    _kernels.launches.clear()

    api = FakeApiServer()
    facade, facade_thread = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    metrics = MetricsRegistry()
    router = Router(metrics, dispatch_timeout_s=120.0, retry_jitter_seed=SEED)
    runtime = LocalReplicaRuntime(
        router, lambda rspec: build_servable_from_rspec(rspec, device=DEVICE), metrics)
    proc_router = Router(MetricsRegistry(), dispatch_timeout_s=120.0, retry_jitter_seed=SEED)
    procs = ProcessReplicaRuntime(api, f"http://127.0.0.1:{facade.server_port}",
                                  router=proc_router, extra_env={"PYTHONPATH": ROOT})
    controller = ServingDeploymentController(api, runtime=runtime, metrics=metrics,
                                             resync_seconds=0.1, process_runtime=procs)
    reconcile = controller.controller.run_until_idle
    rspec = {"model": "resnet", "checkpointDir": ckpt_dir, "maxBatch": cfg["max_batch"]}
    names = [serving_api.replica_name("fleet", i) for i in range(cfg["replicas"])]
    versions = lambda: [(runtime.stats(n) or {}).get("version") for n in names]
    status = lambda name="fleet": api.get(serving_api.KIND, name, "default").status
    manager = None
    try:
        # -- CR -> fleet
        t0 = time.perf_counter()
        api.create(serving_api.make_serving_deployment(
            "fleet", model="resnet", replicas=cfg["replicas"], max_batch=cfg["max_batch"],
            batch_timeout_ms=cfg["timeout_ms"], checkpoint_dir=ckpt_dir, model_version=step))
        reconcile()
        out["fleet_up_s"] = time.perf_counter() - t0
        owned = api.list(serving_api.REPLICA_KIND, "default",
                         label_selector={serving_api.LABEL_DEPLOYMENT: "fleet"})
        checks["owned_replica_objects"] = (
            [r.metadata.name for r in owned] == names
            and all(r.metadata.owner_references[0]["name"] == "fleet" for r in owned))
        checks["ready_replicas"] = status()["readyReplicas"] == cfg["replicas"]
        checks["versions_are_the_step"] = versions() == [step] * cfg["replicas"]
        checks["version_column_is_the_step"] = [
            row["version"] for row in status()["replicas"]] == [step] * cfg["replicas"]
        ref = controller_reference(torch, rspec, instances)
        err = held_to(ref, *probe(router, instances))
        checks["answers"] = ref["version"] == step and err <= ref["limit"]
        out["answers"] = {"max_abs_err": err, "limit": ref["limit"]}
        memory["fleet_up"] = memory_point(torch)

        # -- steady load
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()  # before the load: a start under load stalls the process's CUDA calls
        origin = time.perf_counter()
        counts0 = router_counts(router)
        load = ClosedLoop(router, instances, cfg["clients"]).start()
        lo = cfg["warmup_s"]
        hi = lo + cfg["window_s"]
        time.sleep(max(0.0, load.t0 + lo + (cfg["window_s"] - cfg["profile_s"]) / 2
                       - time.perf_counter()))
        window = (time.perf_counter() - origin) * 1e6
        time.sleep(cfg["profile_s"])
        window = (window, (time.perf_counter() - origin) * 1e6)
        time.sleep(max(0.0, load.t0 + hi - time.perf_counter()))
        rec = load.stop()
        torch.cuda.synchronize()
        prof.stop()
        delta = {k: v - counts0[k] for k, v in router_counts(router).items()}
        busy = sum(max(0.0, min(evt.time_range.end, window[1])
                       - max(evt.time_range.start, window[0]))
                   for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        wall_ms = (window[1] - window[0]) / 1e3
        steady = window_stats(rec["start"], rec["end"], lo, hi)
        steady.update({
            "clients": cfg["clients"], "router": delta, "client_errors": len(rec["errors"]),
            "answers_max_abs_err": held_to(ref, rec["which"], rec["answers"]),
            "profiled_window": {
                "wall_ms": wall_ms, "device_busy_ms": busy if busy else "not measured",
                "device_idle_share": max(0.0, 1 - busy / wall_ms) if busy else "not measured"},
        })
        del prof
        out["steady"] = steady
        checks["steady_failed_0"] = delta["failed"] == 0 and not rec["errors"]
        checks["steady_answers"] = steady["answers_max_abs_err"] <= ref["limit"]

        # -- the roll under load
        step2 = commit_step(torch, ckpt_dir)
        manager = ControllerManager()
        manager.add(controller.controller)
        manager.start()
        counts0 = router_counts(router)
        load = ClosedLoop(router, instances, cfg["clients"]).start()
        time.sleep(cfg["warmup_s"])
        samples = []
        edit_spec(api, "fleet", modelVersion=step2)
        roll_s = wait_for(lambda: versions() == [step2] * cfg["replicas"],
                          cfg["roll_timeout_s"], "the roll",
                          tick=lambda: samples.append(len(router.ready_names())))
        time.sleep(1.0)  # the load goes on past the roll's end
        rec = load.stop()
        manager.stop()
        manager = None
        delta = {k: v - counts0[k] for k, v in router_counts(router).items()}
        ref2 = controller_reference(torch, rspec, instances)
        err2 = held_to(ref2, *probe(router, instances))
        out["roll"] = {
            "from_step": step, "to_step": step2, "roll_s": roll_s,
            "out_of_rotation_s": rolled_out_seconds(api, "fleet"),
            "min_admitting": min(samples), "samples": len(samples), "router": delta,
            "client_errors": len(rec["errors"]),
            "during": window_stats(rec["start"], rec["end"], cfg["warmup_s"],
                                   float(rec["end"].max())),
            "answers_after": {"max_abs_err": err2, "limit": ref2["limit"]},
        }
        checks["roll_converged"] = versions() == [step2] * cfg["replicas"]
        checks["roll_failed_0"] = delta["failed"] == 0 and not rec["errors"]
        checks["roll_one_at_a_time"] = min(samples) >= 1
        checks["roll_answers"] = ref2["version"] == step2 and err2 <= ref2["limit"]
        rolls = controller.rolls_total.value(deployment="fleet")
        checks["rolled_each_replica_once"] = rolls == cfg["replicas"]

        # -- a checkpoint directory past the spec: no endless roll
        step3 = commit_step(torch, ckpt_dir)
        for _ in range(cfg["fault_reconciles"]):
            controller.controller.enqueue(("default", "fleet"))
            reconcile()
        out["past_the_spec"] = {"spec": step2, "newest": step3, "versions": versions(),
                                "rolls": controller.rolls_total.value(deployment="fleet")}
        checks["no_roll_past_the_spec"] = (
            controller.rolls_total.value(deployment="fleet") == rolls
            and versions() == [step2] * cfg["replicas"])

        # -- scale 2 -> 3 -> 1
        scaled = {}
        for n in cfg["scale"]:
            t0 = time.perf_counter()
            edit_spec(api, "fleet", replicas=n)
            reconcile()
            gc.collect()
            scaled[n] = {
                "seconds": time.perf_counter() - t0, "router": router.replica_names(),
                "objects": [r.metadata.name for r in api.list(serving_api.REPLICA_KIND)],
                "ready": status()["readyReplicas"], "versions": {
                    r: (runtime.stats(r) or {}).get("version") for r in router.replica_names()},
                "memory": memory_point(torch)}
        want = {n: [serving_api.replica_name("fleet", i) for i in range(n)]
                for n in cfg["scale"]}
        checks["scaled"] = all(scaled[n]["router"] == scaled[n]["objects"] == want[n]
                               and scaled[n]["ready"] == n for n in cfg["scale"])
        # The replica the scale-up added restored the spec's own step,
        # which the directory still holds, not the newest: one version
        # in the fleet, and no roll.
        up = cfg["scale"][0]
        checks["scale_up_no_roll"] = (
            controller.rolls_total.value(deployment="fleet") == rolls
            and list(scaled[up]["versions"].values()) == [step2] * up)
        per_replica = (memory["fleet_up"]["tensors_mib"] - memory["before"]["tensors_mib"]) \
            / cfg["replicas"]
        one = scaled[cfg["scale"][-1]]["memory"]["tensors_mib"]
        checks["scale_down_gave_memory_back"] = abs(
            one - memory["before"]["tensors_mib"] - per_replica) <= slack
        out["scale"] = scaled
        out["replica_tensors_mib"] = per_replica
        api.delete(serving_api.KIND, "fleet", "default")
        reconcile()
        checks["fleet_deleted"] = (router.replica_names() == []
                                   and api.list(serving_api.REPLICA_KIND) == [])
        gc.collect()
        memory["fleet_deleted"] = memory_point(torch)
        checks["memory_back"] = abs(memory["fleet_deleted"]["tensors_mib"]
                                    - memory["before"]["tensors_mib"]) <= slack

        # -- the process runtime
        out["process"] = process_fleet(torch, api, controller, procs, proc_router, step3,
                                       rspec, instances, checks)
    finally:
        if manager is not None:
            manager.stop()
        procs.shutdown()
        for name in runtime.names():
            runtime.stop(name)
        facade.shutdown()
        facade.server_close()
        facade_thread.join(timeout=30)
    del router, runtime, controller
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(_kernels.launches)
    checks["no_flash_launches"] = not launches
    out.update({"memory": memory, "memory_slack_mib": slack, "checks": checks,
                "seconds": time.perf_counter() - t_phase})
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"controller checks failed: {failed}")


def process_fleet(torch, api, controller, procs, router, step: int, rspec: dict,
                  instances, checks: dict) -> dict:
    """controller_phase's process fleet (see there): the CR "workers"
    with ``runtime: process`` at ``modelVersion`` = `step` (the
    directory's newest), driven by the threaded controller."""
    import signal

    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.controllers import ControllerManager
    from kubeflow_tpu_torch.serving import HttpReplica
    from kubeflow_tpu_torch.testing.chaos import ReplicaKillSchedule
    from kubeflow_tpu_torch.testing.fake_apiserver import NotFound

    cfg = CONTROLLER
    slack = cfg["memory_slack_mib"]
    names = [serving_api.replica_name("workers", i) for i in range(cfg["workers"])]
    robj = lambda n: api.get(serving_api.REPLICA_KIND, n, "default")
    cuda_mib = lambda: {n: robj(n).status.get("cudaMemoryMiB") for n in names}
    out, started = {}, {}
    spawned = {}

    def settled_mib(base: dict) -> dict:
        """The workers' stamped card memory once each one's allocated
        MiB is back within the slack of `base` (a roll's old version is
        let go when the next request prunes its batching queue; a worker
        stamps at its 1 s heartbeat), or after 15 s, as it stands."""
        try:
            wait_for(lambda: all(cuda_mib()[n]["allocated"] - base[n]["allocated"] <= slack
                                 for n in names), 15.0, "the workers' card memory")
        except AssertionError:
            pass  # the check fails and the readings show why
        return cuda_mib()

    def live(n) -> bool:
        proc = procs._procs.get(n)
        try:
            status = robj(n).status
        except NotFound:  # not created yet
            return False
        return (proc is not None and proc.poll() is None and status.get("ready")
                and status.get("pid") == proc.pid and n in router.ready_names())

    used = {"before": card_used_mib(torch)}
    apps_before = compute_apps()

    def note_ready():
        for n in names:
            proc = procs._procs.get(n)
            if proc is not None and proc.pid not in spawned:
                spawned[proc.pid] = time.perf_counter()
            if proc is not None and proc.pid not in started and live(n):
                started[proc.pid] = time.perf_counter() - spawned[proc.pid]

    manager = ControllerManager()
    manager.add(controller.controller)
    manager.start()
    try:
        api.create(serving_api.make_serving_deployment(
            "workers", model="resnet", replicas=cfg["workers"], max_batch=cfg["max_batch"],
            batch_timeout_ms=cfg["timeout_ms"], checkpoint_dir=rspec["checkpointDir"],
            model_version=step, runtime="process"))
        out["fleet_up_s"] = wait_for(lambda: all(live(n) for n in names),
                                     cfg["worker_start_s"], "the workers", tick=note_ready)
        note_ready()
        pids = {n: procs._procs[n].pid for n in names}
        out["startup_s"] = {n: started[pids[n]] for n in names}
        used["workers_up"] = card_used_mib(torch)
        # Each worker's own reading (allocated and reserved MiB), and the
        # card's memory.used over the phase's own reading for them all.
        worker_mib = {"up": cuda_mib()}
        checks["workers_on_the_card"] = all(
            m and m["allocated"] > 0 for m in worker_mib["up"].values())
        out["card_used_by_workers_mib"] = used["workers_up"] - used["before"]
        ref = controller_reference(torch, rspec, instances)
        err = held_to(ref, *probe(router, instances))
        versions = [robj(n).status["version"] for n in names]
        checks["workers_answer"] = (err <= ref["limit"]
                                    and versions == [step] * cfg["workers"] == [ref["version"]]
                                    * cfg["workers"])
        out["answers"] = {"max_abs_err": err, "limit": ref["limit"], "versions": versions}
        checks["workers_admitted_as_http"] = all(
            isinstance(router.replica(n), HttpReplica) and router.replica(n)._binary
            for n in names)

        # The same clients and batching through two workers, then one.
        compare = {}
        for k in (2, 1):
            if k == 1:
                router.drain(names[1], timeout=60.0)
            load = ClosedLoop(router, instances, cfg["process_clients"]).start()
            time.sleep(cfg["warmup_s"] + cfg["process_compare_s"])
            rec = load.stop()
            compare[k] = window_stats(rec["start"], rec["end"], cfg["warmup_s"],
                                      cfg["warmup_s"] + cfg["process_compare_s"])
            compare[k]["client_errors"] = len(rec["errors"])
        router.admit(names[1])
        time.sleep(2.5)  # two idle heartbeats: each worker stamps its reading at rest
        # The base of the roll's memory checks: the version loaded, and
        # the threads that served it holding their cuBLAS workspaces.
        worker_mib["served"] = cuda_mib()
        out["workers_compare"] = {"clients": cfg["process_clients"], "2": compare[2],
                                  "1": compare[1]}
        checks["workers_compare_clean"] = not compare[2]["client_errors"] \
            and not compare[1]["client_errors"]

        # Load with one worker SIGKILLed.
        sched = ReplicaKillSchedule(SEED, kills=1, replicas=cfg["workers"])
        counts0 = router_counts(router)
        load = ClosedLoop(router, instances, cfg["process_clients"]).start()
        kills = []
        while time.perf_counter() - load.t0 < cfg["process_load_s"]:
            frac = (time.perf_counter() - load.t0) / cfg["process_load_s"]
            kill = sched.due(frac)
            if kill is not None:
                ready = router.ready_names()
                victim = ready[kill.victim % len(ready)]
                os.kill(procs._procs[victim].pid, signal.SIGKILL)
                t_kill = time.perf_counter()
                sched.mark_injected(kill)
                kills.append({"replica": victim, "pid": procs._procs[victim].pid,
                              "at_fraction": frac})
            note_ready()
            time.sleep(0.02)
        rec = load.stop()
        delta = {k: v - counts0[k] for k, v in router_counts(router).items()}
        victim = kills[0]["replica"] if kills else None
        respawn_s = wait_for(lambda: all(live(n) for n in names), cfg["worker_start_s"],
                             "the respawned worker", tick=note_ready) if kills else None
        new_pid = procs._procs[victim].pid if kills else None
        out["chaos"] = {
            "router": delta, "client_errors": len(rec["errors"]), "kills": kills,
            "kill_coverage": sched.coverage(), "requests": len(rec["start"]),
            "predictions_per_s": len(rec["start"]) / cfg["process_load_s"],
            "respawned_pid": new_pid,
            "respawn_s": (time.perf_counter() - t_kill) if kills else None,
            "respawn_wait_after_load_s": respawn_s,
            "respawned_startup_s": started.get(new_pid),
            **percentiles(list(rec["end"] - rec["start"]))}
        checks["chaos_acked_eq_completed"] = delta["acked"] == delta["completed"]
        checks["chaos_failed_0"] = delta["failed"] == 0 and not rec["errors"]
        checks["chaos_kill_plan_exhausted"] = sched.exhausted and len(kills) == 1
        checks["chaos_respawned"] = bool(kills) and new_pid != kills[0]["pid"] and live(victim)

        # Self-roll on the config push.
        pids = {n: procs._procs[n].pid for n in names}
        step4 = commit_step(torch, rspec["checkpointDir"])
        edit_spec(api, "workers", modelVersion=step4)
        out["self_roll_s"] = wait_for(
            lambda: all(robj(n).status.get("version") == step4 for n in names) and all(
                live(n) for n in names), cfg["worker_start_s"], "the workers' self-roll")
        ref4 = controller_reference(torch, rspec, instances)
        err4 = held_to(ref4, *probe(router, instances))
        checks["self_rolled"] = (
            {n: procs._procs[n].pid for n in names} == pids
            and ref4["version"] == step4 and err4 <= ref4["limit"])
        worker_mib["self_rolled"] = settled_mib(worker_mib["served"])
        used["self_rolled"] = card_used_mib(torch)
        out["after_self_roll"] = {"step": step4, "max_abs_err": err4, "limit": ref4["limit"],
                                  "card_used_by_workers_mib": used["self_rolled"]
                                  - used["before"]}

        # A roll back to the third step, which the directory still holds.
        edit_spec(api, "workers", modelVersion=step)
        out["roll_back_s"] = wait_for(
            lambda: all(robj(n).status.get("version") == step for n in names) and all(
                live(n) for n in names), cfg["worker_start_s"], "the workers' roll back")
        ref3 = controller_reference(torch, {**rspec, "modelVersion": step}, instances)
        err3 = held_to(ref3, *probe(router, instances))
        checks["rolled_back"] = (
            {n: procs._procs[n].pid for n in names} == pids
            and ref3["version"] == step and err3 <= ref3["limit"])
        worker_mib["rolled_back"] = settled_mib(worker_mib["served"])
        out["after_roll_back"] = {"step": step, "max_abs_err": err3, "limit": ref3["limit"]}
        out["worker_cuda_mib"] = worker_mib
        checks["worker_memory_back"] = all(
            worker_mib[when][n]["allocated"] - worker_mib["served"][n]["allocated"] <= slack
            for when in ("self_rolled", "rolled_back") for n in names) and all(
            worker_mib["rolled_back"][n]["reserved"]
            - worker_mib["self_rolled"][n]["reserved"] <= slack for n in names)

        # Delete: the workers are reaped.
        gone = dict(procs._procs)
        api.delete(serving_api.KIND, "workers", "default")
        out["teardown_s"] = wait_for(
            lambda: procs.names() == [] and router.replica_names() == []
            and all(p.poll() is not None for p in gone.values()),
            60.0, "the workers' reaping")
        # The workers' contexts leave the card with them: no compute
        # process beyond those before them, and memory.used back.
        try:
            wait_for(lambda: not set(compute_apps()) - set(apps_before)
                     and card_used_mib(torch) - used["before"] <= slack,
                     30.0, "the workers' card memory")
        except AssertionError:
            pass  # the check below fails and the readings show why
        used["reaped"] = card_used_mib(torch)
        left = set(compute_apps()) - set(apps_before)
        checks["workers_reaped"] = (
            not left and all(p.returncode is not None for p in gone.values())
            and used["reaped"] - used["before"] <= slack)
        out["exit_codes"] = {n: p.returncode for n, p in gone.items()}
        out["compute_apps_left"] = sorted(left)
        out["card_used_mib"] = used
    except BaseException:
        for n in names:
            proc = procs._procs.get(n)
            try:
                last = robj(n).status
            except Exception as e:
                last = repr(e)
            print(f"controller: worker {n}: exit code "
                  f"{proc.poll() if proc is not None else 'not running'}; "
                  f"last status {last}", file=sys.stderr)
        raise
    finally:
        manager.stop()
    return out


def rl_config(seed: int = SEED):
    """bench.py's phase-A run (`bench.py:2137-2146`): an 8 -> 32 -> 4
    policy, 8 envs x horizon 4 (a batch of 32 transitions), 48 learner
    steps at lr 0.05, a publish every 12, staleness bound 24, 2 actors,
    replay capacity 8; the env drawn from `seed`."""
    from kubeflow_tpu_torch.rl import EnvConfig, RLConfig

    return RLConfig(
        env=EnvConfig(seed=seed, obs_dim=RL["obs_dim"], n_actions=RL["n_actions"],
                      n_envs=RL["n_envs"], horizon=RL["horizon"]),
        hidden=RL["hidden"], learning_rate=RL["lr"], total_steps=RL["steps"],
        publish_every=RL["publish_every"], staleness_bound=2 * RL["publish_every"],
        n_actors=RL["actors"], replay_capacity=RL["capacity"])


def rl_fleet(cfg, ckpt_dir: str, trainer, device: str, refs: list, seed: int = SEED):
    """The policy fleet as `bench.py:2171-2190` stands it up: a CR
    "rl-policy" of RL["replicas"] replicas batching RL["max_batch"] /
    RL["timeout_ms"], reconciled by the port's controller through
    `LocalReplicaRuntime` and a `PolicyCheckpointPublisher` on `device`
    reading the learner's checkpoint directory (before the first publish:
    the init from `seed`, at version 1). A weak reference to the router
    and to every servable the fleet builds (rolls included) goes into
    `refs`. Returns (api, router, controller)."""
    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.controllers import ServingDeploymentController
    from kubeflow_tpu_torch.rl import PolicyCheckpointPublisher
    from kubeflow_tpu_torch.serving import LocalReplicaRuntime, Router
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
    from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

    publisher = PolicyCheckpointPublisher(
        ckpt_dir, trainer.abstract_state, obs_dim=cfg.env.obs_dim,
        n_actions=cfg.env.n_actions, hidden=cfg.hidden, init_seed=seed, device=device)

    def build(rspec):
        servable = publisher(rspec)
        refs.append(weakref.ref(servable))
        return servable

    metrics = MetricsRegistry()
    api, router = FakeApiServer(), Router(metrics, retry_jitter_seed=seed)
    refs.append(weakref.ref(router))
    controller = ServingDeploymentController(
        api, runtime=LocalReplicaRuntime(router, build, metrics), metrics=metrics)
    api.create(serving_api.make_serving_deployment(
        "rl-policy", model="policy", replicas=RL["replicas"], max_batch=RL["max_batch"],
        batch_timeout_ms=RL["timeout_ms"]))
    controller.controller.run_until_idle()
    return api, router, controller


def rl_close(api, router) -> None:
    """Takes every replica out of the router and closes it (its batching
    thread joined), then closes the fleet's apiserver, whose dispatcher
    thread would otherwise keep the controller, its runtime and the
    router alive; fails if the router still holds a replica."""
    for name in router.replica_names():
        replica = router.replica(name)
        router.remove(name)
        replica.close()
    api.close()
    if router.replica_names():
        raise AssertionError(f"rl: replicas left in the router: {router.replica_names()}")


def rl_fresh_return(torch, cfg, indices, seed: int = SEED) -> float:
    """The mean return of the policy's init from `seed` (the fleet's
    version 1, where the learner starts) over the trajectory `indices`
    (salt 0), rolled out on the CPU."""
    from kubeflow_tpu_torch.rl import PolicyMLP, VectorEnv, rollout

    policy = PolicyMLP(cfg.env.obs_dim, cfg.env.n_actions, cfg.hidden, seed=seed,
                       device="cpu")
    env = VectorEnv(cfg.env)

    def predict(obs):
        with torch.inference_mode():
            return policy(torch.from_numpy(obs)).numpy(), 1

    return float(np.mean([rollout(env, predict, i).mean_return for i in indices]))


def rl_coupled(torch, cfg, root: str, fleet_device: str, refs: list,
               seed: int = SEED) -> dict:
    """`run_actor_learner` as `bench.py:2236-2256` runs it, the learner on
    DEVICE, the fleet on `fleet_device`, the controller's
    `run_until_idle` as `reconcile`. Returns the result, the fleet's end
    state (each replica's version, the CR's servedVersions, the rolls by
    replica from the ReplicaRolled events, the MixedVersions events the
    apiserver's journal recorded during the loop, the router's counters
    and outstanding requests), the replay accounting,
    a replica's answer against `PolicyMLP`'s forward on the weights
    restored from the last step, the mean return of the last
    RL["last"] trajectories against the fresh init's on the same
    indices, and the fleet's apiserver and router (still up: the caller
    closes them).
    Weak references to the learner and its final state go into `refs`."""
    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.rl import (
        PolicyMLP, ReplayQueue, build_learner, extract_policy_variables,
        run_actor_learner, split_predictions)
    from kubeflow_tpu_torch.train import Checkpointer
    from kubeflow_tpu_torch.train.trainer import TensorSpec

    ckpt_dir = os.path.join(root, "ckpt")
    trainer = build_learner(cfg, device=DEVICE)
    refs.append(weakref.ref(trainer))
    t0 = time.perf_counter()
    api, router, controller = rl_fleet(cfg, ckpt_dir, trainer, fleet_device, refs, seed)
    fleet_up_s = time.perf_counter() - t0
    counts0 = router_counts(router)
    ckpt = Checkpointer(ckpt_dir, save_interval_steps=cfg.publish_every)
    queue = ReplayQueue(capacity=cfg.replay_capacity, staleness_bound=cfg.staleness_bound,
                        device=trainer.device, stall_timeout_s=RL["stall_timeout_s"])
    bookmark = api.current_rv
    try:
        result = run_actor_learner(
            api=api, deployment="rl-policy", router=router, trainer=trainer,
            checkpointer=ckpt, queue=queue, cfg=cfg, rng=seed,
            reconcile=controller.controller.run_until_idle)
    finally:
        ckpt.close()
    refs.append(weakref.ref(result.fit_result.state))
    journal, _ = api.events_since(bookmark, kind="Event")
    names = [serving_api.replica_name("rl-policy", i) for i in range(RL["replicas"])]
    dep = api.get(serving_api.KIND, "rl-policy", "default")
    rolls = {}
    for ev in api.list("Event", "default"):
        if ev.spec["reason"] == "ReplicaRolled":
            replica, _, _, version = ev.spec["message"].split()[:4]
            rolls.setdefault(replica, []).append(int(version))
    last = cfg.total_steps
    # What a replica answers for RL["max_batch"] observations, against
    # the policy forward on the weights restored from the last step.
    obs = np.random.default_rng(seed).standard_normal(
        (RL["max_batch"], cfg.env.obs_dim)).astype(np.float32)
    logits, version = split_predictions(np.asarray(router.predict(obs)))
    template = {"params": {n: TensorSpec(s.shape, s.dtype, torch.device(fleet_device))
                           for n, s in trainer.abstract_state()["params"].items()}}
    reader = Checkpointer(ckpt_dir, read_only=True)
    try:
        restored = reader.restore_latest(template, prefer_step=last)
    finally:
        reader.close()
    policy = PolicyMLP(cfg.env.obs_dim, cfg.env.n_actions, cfg.hidden, device=fleet_device)
    policy.load_state_dict(extract_policy_variables(restored.state["params"]))
    with torch.inference_mode():
        direct = policy(torch.from_numpy(obs).to(fleet_device)).cpu().numpy()
    trajectories = result.trajectories
    indices = range(max(0, trajectories - RL["last"]), trajectories)
    fresh = rl_fresh_return(torch, cfg, indices, seed)
    return {
        "result": result, "api": api, "router": router, "fleet_up_s": fleet_up_s,
        "versions": [router.replica(n).version for n in names],
        "served_versions": dep.status.get("servedVersions"),
        "rolls": {r: sorted(v) for r, v in sorted(rolls.items())},
        "mixed_events": [ev.spec["message"] for _, kind, ev in journal
                         if kind == "ADDED" and ev.spec["reason"] == "MixedVersions"],
        "router_delta": {k: v - counts0[k] for k, v in router_counts(router).items()},
        "outstanding": router.stats()["outstanding"],
        "position": queue.state_dict()["position"],
        "answer": {"version": version, "restored_step": int(restored.step),
                   "max_abs_err": float(np.abs(logits - direct).max())},
        "mean_return_last": result.mean_return, "fresh_return": fresh,
        "out_of_rotation_s": rolled_out_seconds(api, "rl-policy"),
    }


class RLActors:
    """`bench.py:2198-2220`'s actors for the under-traffic measurement:
    RL["actors"] threads rolling trajectories out through the router
    (`_RouterPolicy`), index a, a + actors, ..., until `stop()`; counts
    the actor steps (rows answered)."""

    def __init__(self, router, cfg):
        self.router, self.cfg = router, cfg
        self.steps, self.errors = [0] * cfg.n_actors, []

    def _act(self, a: int) -> None:
        from kubeflow_tpu_torch.rl import VectorEnv, rollout
        from kubeflow_tpu_torch.rl.loop import _RouterPolicy

        env = VectorEnv(self.cfg.env)
        policy = _RouterPolicy(self.router, timeout_s=30)
        index = a
        while not self._stop.is_set():
            try:
                traj = rollout(env, policy, index)
                self.steps[a] += traj.obs.shape[0] * traj.obs.shape[1]
            except Exception as e:  # a client error: counted, the loop goes on
                if self._stop.is_set():
                    return
                self.errors.append(repr(e))
            index += self.cfg.n_actors

    def start(self) -> "RLActors":
        import threading

        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._act, args=(a,), daemon=True)
                         for a in range(self.cfg.n_actors)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
        if any(t.is_alive() for t in self._threads):
            raise AssertionError("rl: actor threads did not stop")


def rl_synthetic_step(torch, trainer, cfg, seed: int, refs: list):
    """(state, step, batch): the learner's train step on a fresh state
    (params from `seed`; a weak reference to it goes into `refs`) and
    `bench.py:2159-2168`'s synthetic batch of zeros on the learner's
    device."""
    b = cfg.batch_size
    batch = {"obs": torch.zeros((b, cfg.env.obs_dim), device=trainer.device),
             "target": torch.zeros((b, 2), device=trainer.device)}
    state = trainer.init_state(seed)
    refs.append(weakref.ref(state))
    return state, trainer.make_train_step(), batch


def rl_learner_rate(torch, trainer, cfg, seed: int, refs: list) -> float:
    """`bench.py:2155-2168`'s solo rate: `rl_synthetic_step`,
    RL["warmup_steps"] steps, then RL["timed_steps"] timed with one sync
    at the end of the window. Steps per second."""
    state, step, batch = rl_synthetic_step(torch, trainer, cfg, seed, refs)
    for _ in range(RL["warmup_steps"]):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RL["timed_steps"]):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return RL["timed_steps"] / (time.perf_counter() - t0)


def rl_profiled_window(torch, trainer, cfg, router, refs: list) -> dict:
    """One RL["profile_s"] window of the under-traffic run, cut from a
    device-only trace started before the actors (a start under load
    stalls the process's CUDA calls): the learner stepping on synthetic
    batches while the actors roll out through the fleet. The device's
    busy ms and idle share, the learner's steps and the actors' steps in
    the window's run."""
    from torch.profiler import ProfilerActivity, profile

    state, step, batch = rl_synthetic_step(torch, trainer, cfg, SEED, refs)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    origin = time.perf_counter()
    actors = RLActors(router, cfg).start()
    steps, window = 0, None
    lead = 0.5  # the actors and the learner under way before the window
    try:
        while time.perf_counter() - origin < lead + RL["profile_s"] + 0.25:
            state, _ = step(state, batch)
            steps += 1
            now = time.perf_counter() - origin
            if window is None and now >= lead:
                window = [now * 1e6, None]
            elif window is not None and window[1] is None and now >= lead + RL["profile_s"]:
                window[1] = now * 1e6
    finally:
        actors.stop()
    torch.cuda.synchronize()
    prof.stop()
    busy = sum(max(0.0, min(evt.time_range.end, window[1]) - max(evt.time_range.start,
                                                                   window[0]))
               for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    wall_ms = (window[1] - window[0]) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy if busy else "not measured",
            "device_idle_share": max(0.0, 1 - busy / wall_ms) if busy else "not measured",
            "learner_steps": steps, "actor_steps": sum(actors.steps),
            "actor_errors": len(actors.errors)}


def rl_arm(torch, cfg, root: str, fleet_device: str, refs: list) -> tuple[dict, dict]:
    """One arm of the rl phase, the learner on DEVICE and the policy
    fleet on `fleet_device`: the solo rate, the rate under actor
    traffic and their ratio, a profiled window under traffic, then the
    coupled loop (`rl_coupled`). Weak references to the fleets, their
    servables, the learners and their states go into `refs`. Returns
    (numbers, checks)."""
    from kubeflow_tpu_torch.rl import build_learner

    out, checks = {"fleet_device": fleet_device}, {}
    solo = build_learner(cfg, device=DEVICE)
    refs.append(weakref.ref(solo))
    api, router, _ = rl_fleet(cfg, os.path.join(root, "idle"), solo, fleet_device, refs)
    try:
        out["solo_steps_per_sec"] = rl_learner_rate(torch, solo, cfg, SEED, refs)
        t0 = time.perf_counter()
        actors = RLActors(router, cfg).start()
        try:
            out["loaded_steps_per_sec"] = rl_learner_rate(torch, solo, cfg, SEED + 1, refs)
        finally:
            actors.stop()
        # The actors' rate over their whole run, the learner's warm-up included.
        out["loaded_actor_steps_per_sec"] = sum(actors.steps) / (time.perf_counter() - t0)
        out["rl_learner_mfu_under_actor_traffic"] = (
            out["loaded_steps_per_sec"] / out["solo_steps_per_sec"])
        out["profiled_window"] = rl_profiled_window(torch, solo, cfg, router, refs)
        checks["traffic_no_client_error"] = (
            not actors.errors and not out["profiled_window"]["actor_errors"])
    finally:
        rl_close(api, router)
    del solo, api, router
    run = rl_coupled(torch, cfg, root, fleet_device, refs)
    result = run.pop("result")
    rl_close(run.pop("api"), run.pop("router"))
    latencies = result.publish_latencies
    out.update({
        "rl_actor_steps_per_sec": result.actor_steps_per_sec,
        "rl_policy_publish_to_actor_seconds": latencies,
        "rl_policy_publish_to_actor_seconds_max": max(latencies, default=None),
        "learner_steps_per_sec_in_loop": result.learner_steps_per_sec,
        "actor_steps": result.actor_steps, "trajectories": result.trajectories,
        "predict_retries": result.predict_retries, "stale_dropped": result.stale_dropped,
        "rejected_pushes": result.rejected_pushes, "final_loss": result.final_loss,
        "publishes": [p.version for p in result.publishes],
        **run,
    })
    steps, every = cfg.total_steps, cfg.publish_every
    want = list(range(every, steps + 1, every))
    names = sorted(run["rolls"]) or ["none"]
    checks.update({
        "publishes": out["publishes"] == want,
        "each_publish_observed": len(latencies) == len(want),
        "each_replica_rolled_once_per_publish": (
            len(run["rolls"]) == RL["replicas"]
            and all(run["rolls"][n] == want for n in names)),
        "fleet_at_the_last_step": run["versions"] == [steps] * RL["replicas"],
        "served_versions": run["served_versions"] == [steps] and not run["mixed_events"],
        "nothing_lost": (run["outstanding"] == 0 and run["router_delta"]["failed"] == 0
                         and run["position"] == steps + result.stale_dropped
                         and result.fit_result.steps_done == steps),
        "answer": (run["answer"]["version"] == run["answer"]["restored_step"] == steps
                   and run["answer"]["max_abs_err"] <= RL["answer_tol"]),
        "return_beats_fresh_init": (
            run["mean_return_last"] >= run["fresh_return"] + RL["margin"]),
    })
    return out, checks


def rl_loss_check(torch, cfg) -> dict:
    """The learner's loss on the card against the CPU's: `PolicyWithLoss`
    with the same weights (the init from SEED, as converted parameters
    are the same on both) on one batch of transitions rolled out by that
    init: the loss and every gradient's largest distance."""
    from kubeflow_tpu_torch.rl import PolicyWithLoss, VectorEnv, rollout

    losses, grads = {}, {}
    cpu = PolicyWithLoss(cfg.env.obs_dim, cfg.env.n_actions, cfg.hidden, seed=SEED,
                         device="cpu")

    def predict(obs):
        with torch.inference_mode():
            return cpu.policy(torch.from_numpy(obs)).numpy(), 1

    batch = rollout(VectorEnv(cfg.env), predict, 0).transitions()
    for device in ("cpu", DEVICE):
        model = PolicyWithLoss(cfg.env.obs_dim, cfg.env.n_actions, cfg.hidden,
                               device=device)
        model.load_state_dict(cpu.state_dict())
        loss = model(torch.from_numpy(batch["obs"]).to(device),
                     labels=torch.from_numpy(batch["target"]).to(device))
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    return {"loss": losses, "loss_abs_err": abs(losses["cpu"] - losses[DEVICE]),
            "grad_max_abs_err": max(float((grads["cpu"][n] - grads[DEVICE][n]).abs().max())
                                    for n in grads["cpu"])}


def rl_phase(torch, card: str) -> None:
    """The actor–learner RL loop (`bench.py --workload rl`, phase A,
    `bench.py:2074-2270`) at the bench's configuration (`rl_config`):
    control plane, serving and training loaded at once. Two arms, both
    with the learner on the card: the slice's path with the policy fleet
    on the card too, and a comparison with the fleet pinned to the CPU
    as `bench.py:2179` pins it (named explicitly). Each arm (`rl_arm`):
    the learner's rate solo, under 2 actors' traffic and their ratio
    (`rl_learner_mfu_under_actor_traffic`), the device's idle share over
    a 3 s window under traffic, then the coupled loop with its gates:
    publishes at [12, 24, 36, 48], each observed by an actor in-band;
    each replica rolled exactly once per publish (ReplicaRolled events);
    both replicas at 48 and servedVersions [48], and no MixedVersions
    event recorded during the loop (the apiserver's journal: an
    in-process fleet rolls both replicas in one reconcile, so it never
    shows a mixed set); nothing outstanding or failed in the router and
    the replay position = steps + stale drops; a replica's answer within f32 1e-6 of
    `PolicyMLP`'s forward on the weights restored from step 48 (TF32 is
    off); the mean return of the last 20 trajectories at least
    RL["margin"] above the fresh init's on the same trajectory indices
    (up to the ones in flight at the end). Before the arms,
    `PolicyWithLoss`'s loss and gradients on the card within
    RL["grad_tol"] of the CPU's on the same weights and batch. After
    them, every router emptied by `rl_close`; every router, servable,
    learner and learner state the arms built collected (weak references:
    the phase moves well under 1 MiB, so a leak shows there and not in
    the allocator); and the live tensors within RL["memory_slack_mib"] of
    the phase's start (cuBLAS's workspaces released first). No flash
    kernel runs."""
    from kubeflow_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    gc.collect()
    memory = {"before": memory_point(torch)}
    _kernels.launches.clear()
    cfg = rl_config()
    out = {"phase": "rl", "card": card, "config": {
        k: RL[k] for k in ("obs_dim", "hidden", "n_actions", "n_envs", "horizon", "steps",
                           "publish_every", "actors", "capacity", "replicas", "max_batch",
                           "timeout_ms")}}
    checks = {}
    out["loss_check"] = rl_loss_check(torch, cfg)
    checks["loss_and_grads_card_vs_cpu"] = (
        out["loss_check"]["loss_abs_err"] <= RL["grad_tol"]
        and out["loss_check"]["grad_max_abs_err"] <= RL["grad_tol"])
    root = tempfile.mkdtemp(prefix="kftpu_rl_")
    arms, refs = {}, []
    try:
        for arm, fleet_device in (("card", DEVICE), ("cpu", "cpu")):
            os.mkdir(os.path.join(root, arm))
            arms[arm], arm_checks = rl_arm(torch, cfg, os.path.join(root, arm), fleet_device,
                                           refs)
            checks.update({f"{arm}_{k}": v for k, v in arm_checks.items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["arms"] = arms
    gc.collect()
    left = [type(ref()).__name__ for ref in refs if ref() is not None]
    out["released"] = {"tracked": len(refs), "alive": left}
    checks["fleets_and_learners_released"] = len(refs) > 0 and not left
    torch.cuda.empty_cache()
    memory["after"] = memory_point(torch)
    checks["memory_back"] = abs(memory["after"]["tensors_mib"]
                                - memory["before"]["tensors_mib"]) <= RL["memory_slack_mib"]
    checks["no_flash_launches"] = not _kernels.launches
    out.update({"memory": memory, "margin": RL["margin"], "checks": checks,
                "seconds": time.perf_counter() - t_phase})
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"rl checks failed: {failed}")


def log_records(text: str) -> list:
    """The LM job worker's JSON lines (start, step, kill, done) in a pod log."""
    out = []
    for line in text.splitlines():
        if line.startswith('{"event"'):
            out.append(json.loads(line))
    return out


def job_phase(torch, card: str, plane, root: str, bare_step_ms: float,
              loss_limit: float) -> dict:
    """Path A, the job plane: the full-width LM trained as a TpuJob
    ("lm-train": 1 worker, 1 GPU, maxRestarts 1) that the
    controller-manager binary gangs and the local pod runner execs:
    ``python -m kubeflow_tpu_torch.launcher --module
    kubeflow_tpu_torch.testing.workers.lm_job:main``, TRAIN's LM and
    stream through fit() with an AnomalyGuard and a Checkpointer (a save
    every JOB["save_every"]) on the default dispatch (flash_fwd,
    flash_delta, flash_bwd_fused), every step's loss reported to the
    TpuJob's status.metrics, for JOB["steps"] steps (path L's gang
    carries the kill, the whole-gang restart and the bitwise resumed
    step on the card). Gates: Succeeded, restarts 0, not
    resumed, every step logged and in status.metrics once, 16 launches a
    step of each of flash_fwd, flash_delta and flash_bwd_fused in the
    worker. Numbers: CR to pod Running, the runner's spawn to the
    worker's start line and first step (s), the job's step ms beside the
    train phase's bare step (`bare_step_ms`), the job's wall time, the
    worker's peak memory and the card's memory.used. Returns the
    worker's launch counts, its footprint on the card (memory.used's
    peak over the reading before the spawn) and path A's curve for the
    later jobs (losses, `loss_limit`: LOSS_Z of train_check's bf16
    standard error, step ms)."""
    from kubeflow_tpu_torch.api import make_tpujob
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_INCARNATION, LABEL_JOB

    t_phase = time.perf_counter()
    used_before = card_used_mib(torch)
    env = {
        "KFTPU_CKPT_DIR": os.path.join(root, "lm-ckpt"),
        "KFTPU_TOTAL_STEPS": str(JOB["steps"]),
        "KFTPU_SAVE_EVERY": str(JOB["save_every"]),
        "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                                     "dtype": "bfloat16", "lr": TRAIN["lr"]}),
    }
    running_at, used = {}, {"max": used_before, "t": 0.0}

    def tick():
        now = time.time()
        for pod in plane.api.list("Pod", "default", label_selector={LABEL_JOB: "lm-train"}):
            if pod.status.get("phase") == "Running":
                running_at.setdefault(int(pod.metadata.labels[LABEL_INCARNATION]), now)
        if now - used["t"] >= 1.0:
            used["t"] = now
            used["max"] = max(used["max"], float(nvidia_smi("--query-gpu=memory.used")[0]))

    t_create = time.time()
    plane.api.create(make_tpujob(
        "lm-train", replicas=1, tpu_chips_per_worker=1, max_restarts=JOB["max_restarts"],
        command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                 "kubeflow_tpu_torch.testing.workers.lm_job:main"),
        env=tuple(env.items())))
    plane.run_until(
        lambda: plane.api.get("TpuJob", "lm-train").status.get("phase")
        in ("Succeeded", "Failed"), JOB["timeout_s"], "TpuJob lm-train to finish", tick=tick)
    wall_s = time.time() - t_create
    job = plane.api.get("TpuJob", "lm-train")
    obs = job.status.get("observation") or {}
    records = log_records(plane.pod_logs().get("lm-train-worker-0.log", ""))
    steps = {(r["incarnation"], r["step"]): r for r in records if r["event"] == "step"}
    starts = {r["incarnation"]: r for r in records if r["event"] == "start"}
    first = min((r for (i, _), r in steps.items() if i == 0), key=lambda r: r["step"],
                default=None)
    loss = lambda step: steps.get((0, step), {}).get("loss")
    launches = {k[len("launches_"):]: int(v) for k, v in obs.items()
                if k.startswith("launches_")}
    done = int(obs.get("steps_done", 0))
    want_launches = {name: LM["n_layers"] * JOB["steps"]
                     for name in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
    checks = {
        "succeeded": job.status.get("phase") == "Succeeded",
        "restarts_0": job.status.get("restarts", 0) == 0,
        "not_resumed": obs.get("resumed_from") == 0.0,
        "steps_done": done == JOB["steps"],
        "curve": sorted(steps) == [(0, s) for s in range(1, JOB["steps"] + 1)],
        "worker_launches": launches == want_launches,
        "status_curve": [p["step"] for p in job.status.get("metrics", [])]
        == list(range(1, JOB["steps"] + 1)),
    }
    out = {
        "phase": "job", "card": card, "job": "lm-train", "worker_command": "python -m "
        "kubeflow_tpu_torch.launcher --module kubeflow_tpu_torch.testing.workers.lm_job:main",
        "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "steps": JOB["steps"], "save_every": JOB["save_every"],
        "phase_final": job.status.get("phase"), "restarts": job.status.get("restarts"),
        "observation": obs, "manager_ready_s": plane.manager_ready_s,
        "cr_to_running_s": running_at[0] - t_create if 0 in running_at else None,
        # From the runner's spawn (the pod's Running) to the worker's
        # start line (torch imported, the job read) and to its first step.
        "spawn_to_worker_start_s": (starts[0]["time"] - running_at[0]
                                    if 0 in starts and 0 in running_at else None),
        "spawn_to_first_step_s": (first["time"] - running_at[0]
                                  if first and 0 in running_at else None),
        "job_step_ms": obs.get("step_ms"), "train_phase_step_ms": bare_step_ms,
        "job_vs_bare_step": obs.get("step_ms", 0.0) / bare_step_ms,
        "job_wall_s": wall_s,
        "worker_peak_memory_gib": obs.get("peak_memory_gib"),
        "card_memory_used_mib": {"before_spawn": used_before, "max_during_job": used["max"]},
        "losses": {s: loss(s) for s in range(1, JOB["steps"] + 1)},
        "launches": launches, "want_launches": want_launches, "checks": checks,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"job phase checks failed: {failed}")
    path_a = {"losses": {s: loss(s) for s in range(1, JOB["steps"] + 1)},
              "loss_limit": loss_limit, "step_ms": obs.get("step_ms")}
    return launches, used["max"] - used_before, path_a


def gang_job_phase(torch, card: str, plane, root: str, bare_step_ms: float,
                   path_a: dict) -> dict:
    """Path L, the gang phase's job (b): the full-width LM as a
    two-worker TpuJob ("lm-gang": replicas 2, 1 GPU each, maxRestarts 1)
    on path A's binary, each worker ``python -m
    kubeflow_tpu_torch.launcher --module
    kubeflow_tpu_torch.testing.workers.lm_job:main`` at ``KFTPU_MESH``
    dp = -1 in bf16: one model over the gang, each rank on its 4 rows of
    the 8 x 2048 batch, the gradients all-reduced, through fit() for
    GANG["steps"] steps with a save every GANG["save_every"] (rank 0
    writes). Rank 1 of the first incarnation SIGKILLs itself after step
    GANG["kill_at"], once rank 0's save before it (step R) is
    committed; rank 0's next collective fails, the operator restarts the
    gang whole, both ranks resume from rank 0's step R. Gates:
    Succeeded, restarts 1, rank 0's observation resumed_from R and
    steps_done the rest; one kill by rank 1 after the commit; rank 0 of
    the first incarnation failed on its own within the group timeout;
    each rank's steps 1..kill_at, then R+1..steps; step R+1's loss (a
    forward from the restored state on the repositioned stream) bitwise
    equal across the incarnations; both ranks' losses equal at every
    step, and each bitwise or within path A's limit of path A's loss at
    that step; every rank of the last incarnation launching the
    forward, delta and fused backward kernels 16 times a step; both
    ranks on one backend. Numbers, per rank: the backend, step ms, ms in collectives a
    step, peak memory, launches; the survivor's s from the kill to its
    failure; CR to Running; kill to the first resumed step; beside the
    train phase's one-process step (`bare_step_ms`). Returns the last
    incarnation's launches summed over the ranks."""
    from kubeflow_tpu_torch.api import make_tpujob
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_INCARNATION, LABEL_JOB

    t_phase = time.perf_counter()
    name = "lm-gang"
    env = {
        "KFTPU_CKPT_DIR": os.path.join(root, name),
        "KFTPU_TOTAL_STEPS": str(GANG["steps"]),
        "KFTPU_SAVE_EVERY": str(GANG["save_every"]),
        "KFTPU_KILL_AT_STEP": str(GANG["kill_at"]),
        "KFTPU_KILL_RANK": str(GANG["kill_rank"]),
        "KFTPU_MESH": json.dumps({"dp": -1}),
        "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                                     "dtype": "bfloat16", "lr": TRAIN["lr"]}),
    }
    running_at = {}

    def tick():
        for pod in plane.api.list("Pod", "default", label_selector={LABEL_JOB: name}):
            if pod.status.get("phase") == "Running":
                running_at.setdefault(int(pod.metadata.labels[LABEL_INCARNATION]), time.time())

    t_create = time.time()
    plane.api.create(make_tpujob(
        name, replicas=GANG["ranks"], tpu_chips_per_worker=1,
        max_restarts=GANG["max_restarts"],
        command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                 "kubeflow_tpu_torch.testing.workers.lm_job:main"),
        env=tuple(env.items())))
    plane.run_until(
        lambda: plane.api.get("TpuJob", name).status.get("phase") in ("Succeeded", "Failed"),
        GANG["timeout_s"], f"TpuJob {name} to finish", tick=tick)
    wall_s = time.time() - t_create
    job = plane.api.get("TpuJob", name)
    obs = job.status.get("observation") or {}
    logs = plane.pod_logs()
    records = {r: log_records(logs.get(f"{name}-worker-{r}.log", "")) for r in range(GANG["ranks"])}
    steps = {(x["incarnation"], r, x["step"]): x for r, recs in records.items()
             for x in recs if x["event"] == "step"}
    starts = {(x["incarnation"], r): x for r, recs in records.items()
              for x in recs if x["event"] == "start"}
    kills = [(r, x) for r, recs in records.items() for x in recs if x["event"] == "kill"]
    failed = {(x["incarnation"], r): x for r, recs in records.items()
              for x in recs if x["event"] == "failed"}
    done = {r: x for r, recs in records.items() for x in recs
            if x["event"] == "done" and x["incarnation"] == 1}
    k, last = GANG["kill_at"], GANG["steps"]
    resume = k - k % GANG["save_every"]
    loss = lambda inc, r, step: steps.get((inc, r, step), {}).get("loss")
    inc_of = lambda step: 0 if step <= resume else 1
    curve = {s: loss(inc_of(s), 0, s) for s in range(1, last + 1)}
    vs_a = {}
    for s, value in curve.items():
        a = path_a["losses"].get(s)
        diff = abs(value - a) if value is not None and a is not None else float("nan")
        vs_a[s] = {"gang": value, "path_a": a, "abs_diff": diff,
                   "holds": "bitwise" if diff == 0.0 else
                   "within the bf16 limit" if diff <= path_a["loss_limit"] else "no"}
    launches = {r: {key[len("launches_"):]: int(v) for key, v in
                    (obs if r == 0 else done.get(r, {})).items() if key.startswith("launches_")}
                for r in range(GANG["ranks"])}
    want = {kernel: LM["n_layers"] * (last - resume)
            for kernel in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
    backends = {x.get("gang", {}).get("backend") for x in starts.values()}
    kill_time = kills[0][1]["time"] if kills else None
    survivor = failed.get((0, 0))
    per_rank = {}
    for r in range(GANG["ranks"]):
        mine = [x for (inc, rr, s), x in sorted(steps.items()) if rr == r]
        # The first step of each incarnation carries its start-up.
        timed = [x for x in mine if (x["incarnation"], x["step"]) not in ((0, 1), (1, resume + 1))]
        per_rank[r] = {
            "backend": starts.get((1, r), {}).get("gang", {}).get("backend"),
            "device": starts.get((1, r), {}).get("device"),
            "step_ms": statistics.median(x["step_ms"] for x in timed) if timed else None,
            "collective_ms_per_step": (statistics.median(x["collective_ms"] for x in timed)
                                       if timed else None),
            "peak_memory_gib": obs.get("peak_memory_gib") if r == 0
            else done.get(r, {}).get("peak_memory_gib"),
            "launches": launches[r],
        }
    first_resumed = min((x["time"] for (inc, _, _), x in steps.items() if inc == 1),
                        default=None)
    checks = {
        "succeeded": job.status.get("phase") == "Succeeded",
        "restarts_1": job.status.get("restarts") == 1,
        "resumed_from_save": obs.get("resumed_from") == float(resume),
        "steps_done": int(obs.get("steps_done", 0)) == last - resume,
        "killed_once_by_rank_1_after_commit": [(r, x["step"], x["committed"]) for r, x in kills]
        == [(GANG["kill_rank"], k, resume)],
        "survivor_failed_in_timeout": bool(
            survivor and kill_time and survivor["time"] - kill_time < 60.0),
        "curves": all(sorted(s for (inc, rr, s) in steps if inc == i and rr == r)
                      == list(range(1, k + 1) if i == 0 else range(resume + 1, last + 1))
                      for i in (0, 1) for r in range(GANG["ranks"])),
        "resumed_step_loss_bitwise": all(
            loss(0, r, resume + 1) is not None and loss(0, r, resume + 1) == loss(1, r, resume + 1)
            for r in range(GANG["ranks"])),
        "ranks_same_loss": all(loss(i, 0, s) == loss(i, r, s)
                               for (i, _, s) in steps for r in range(GANG["ranks"])),
        "losses_vs_path_a": all(v["holds"] != "no" for v in vs_a.values()),
        "worker_launches": all(launches[r] == want for r in range(GANG["ranks"])),
        "one_backend": len(backends) == 1 and None not in backends,
    }
    out = {
        "phase": "gang", "card": card, "job": name, "replicas": GANG["ranks"],
        "mesh": {"dp": GANG["ranks"]}, "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "global_batch": [TRAIN["batch"], TRAIN["seq"]], "steps": last,
        "save_every": GANG["save_every"], "kill_at": k, "kill_rank": GANG["kill_rank"],
        "resumed_step": {"killed_run": loss(0, 0, resume + 1), "resumed_run": loss(1, 0, resume + 1)},
        "backend": sorted(b for b in backends if b), "phase_final": job.status.get("phase"),
        "restarts": job.status.get("restarts"), "observation": obs, "per_rank": per_rank,
        "survivor_kill_to_failure_s": (survivor["time"] - kill_time
                                       if survivor and kill_time else None),
        "survivor_error": survivor.get("error") if survivor else None,
        "cr_to_running_s": running_at[0] - t_create if 0 in running_at else None,
        "kill_to_first_resumed_step_s": (first_resumed - kill_time
                                         if first_resumed and kill_time else None),
        "one_process_train_step_ms": bare_step_ms, "job_wall_s": wall_s,
        "losses_vs_path_a": vs_a, "loss_limit": path_a["loss_limit"],
        "want_launches_per_rank": want, "checks": checks,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed_checks = [c for c, ok in checks.items() if not ok]
    if failed_checks:
        raise AssertionError(f"gang phase checks failed: {failed_checks}")
    return {kernel: sum(launches[r].get(kernel, 0) for r in range(GANG["ranks"]))
            for kernel in set().union(*launches.values())}


def rl_soak_phase(torch, card: str, plane, root: str) -> None:
    """Path B, RL's study soak (bench.py phase B, `rl_studies_per_hour`)
    at bench.py's configuration (RL_SOAK): a grid Study of 4 trials over
    lr in [0.02, 0.08], parallelism 2, maxRestarts 2, reconciled by the
    same controller-manager process as path A; each trial
    (`testing/workers/rl_trial.py`, ``tpu.chipsPerWorker: 1``, where JAX's
    trials ask for 0 and run on the CPU) runs its learner and its
    2-replica policy fleet on the card, with the seeded RLFaultSchedule's
    trial_kill, learner_kill and actor_kill self-delivered. Gates (the
    JAX soak's, `testing/rl_soak.run_rl_study_soak`): Succeeded, 4 scored
    trials, every fault class covered by worker-reported evidence, the
    best return > 0, each trial's restarts as its plan says. Numbers:
    rl_studies_per_hour (3600 / the study's seconds), each trial's
    seconds and return, the worst publish latency, the card's
    memory.used while trials run (sampled each second) and each trial's
    peak allocated memory. No flash kernel runs on this path."""
    from kubeflow_tpu_torch.testing.rl_soak import run_rl_study_soak

    t_phase = time.perf_counter()
    used_before = card_used_mib(torch)
    samples = []

    def tick():
        now = time.time()
        if not samples or now - samples[-1][0] >= 1.0:
            samples.append((now, float(nvidia_smi("--query-gpu=memory.used")[0]),
                            plane.runner.running_count()))

    m = run_rl_study_soak(plane, os.path.join(root, "rl"), seed=RL_SOAK["seed"],
                          trials=RL_SOAK["trials"], steps=RL_SOAK["steps"],
                          publish_every=RL_SOAK["publish_every"],
                          deadline_s=RL_SOAK["deadline_s"], name="rl-soak", tick=tick)
    two = [used for _, used, running in samples if running >= 2]
    emit({
        "phase": "rl_soak", "card": card, "config": RL_SOAK, "chips_per_worker": 1,
        "rl_studies_per_hour": m["studies_per_hour"], "elapsed_s": m["elapsed_seconds"],
        "per_trial": m["per_trial"], "coverage": m["coverage"], "plan": m["plan"],
        "best_return": m["best_return"], "worst_publish_latency_s": m["publish_latency_s"],
        "card_memory_used_mib": {
            "before": used_before, "max": max((u for _, u, _ in samples), default=None),
            "max_with_two_trials_running": max(two, default=None),
            "two_trials_over_before": (max(two) - used_before) if two else None},
        "seconds": time.perf_counter() - t_phase,
    })


def lm_job_spec(name: str, namespace: str, priority: int, steps: int, root: str):
    """A TpuJob of one worker running TRAIN's LM through fit() in
    `testing/workers/lm_job.py`, saving every PREEMPT["save_every"]."""
    from kubeflow_tpu_torch.api import make_tpujob

    env = {
        "KFTPU_CKPT_DIR": os.path.join(root, name),
        "KFTPU_TOTAL_STEPS": str(steps),
        "KFTPU_SAVE_EVERY": str(PREEMPT["save_every"]),
        "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                                     "dtype": "bfloat16", "lr": TRAIN["lr"]}),
    }
    return make_tpujob(
        name, namespace=namespace, replicas=1, tpu_chips_per_worker=1, priority=priority,
        command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                 "kubeflow_tpu_torch.testing.workers.lm_job:main"),
        env=tuple(env.items()))


def set_suspend(api, kind: str, name: str, namespace: str = "default",
                suspend: bool = True) -> None:
    """`spec.suspend = suspend` on a CR, retried over the controller's own
    status writes."""
    from kubeflow_tpu_torch.testing.fake_apiserver import Conflict

    for _ in range(50):
        obj = api.get(kind, name, namespace).thaw()
        obj.spec = {**obj.spec, "suspend": suspend}
        try:
            api.update(obj)
            return
        except Conflict:
            time.sleep(0.01)
    raise AssertionError(f"could not set suspend={suspend} on {kind} {name}")


def pipeline_cron(plane, root: str):
    """Create path D's CronWorkflow "lm-nightly" suspended, so it is
    anchored now and fires nothing until the pipeline phase unsuspends
    it; returns the created object."""
    from kubeflow_tpu_torch.api import CronWorkflowSpec, new_resource
    from kubeflow_tpu_torch.testing.workers.lm_pipeline import pipeline_spec

    lm_size = {**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"], "dtype": "bfloat16",
               "lr": TRAIN["lr"]}
    job = lm_job_spec("lm-nightly-train", "default", 0, PIPELINE["steps"], root).spec
    spec = CronWorkflowSpec(
        schedule="* * * * *", concurrency_policy="Forbid", suspend=True,
        workflow_spec=pipeline_spec(
            job, steps=PIPELINE["steps"], max_eval_loss=PIPELINE["max_eval_loss"],
            ckpt_dir=os.path.join(root, "pipeline-ckpt"), save_every=PIPELINE["save_every"],
            kill_at=0, lm_size=lm_size, requests=REQUESTS))
    spec.validate()
    return plane.api.create(new_resource("CronWorkflow", "lm-nightly", "default",
                                         spec=spec.to_dict()))


def pipeline_phase(torch, card: str, plane, root: str, cron) -> dict:
    """Path D, the nightly pipeline: the Workflow and CronWorkflow
    controllers in the same controller-manager binary as paths A and B
    (``--controllers tpujob,study,workflow,cronworkflow,nodehealth``). A
    CronWorkflow "lm-nightly" (``* * * * *``, concurrencyPolicy Forbid;
    `cron`, created suspended by `pipeline_cron` before path A, is
    unsuspended here and fires its missed tick at once)
    spawns a Workflow (`testing/workers/lm_pipeline.pipeline_spec`):
    ``train``, a TpuJob slice step running `lm_job_spec`'s worker (TRAIN's
    LM through fit(), PIPELINE["steps"] steps, a save every
    PIPELINE["save_every"]); ``eval``,
    a pod that restores the newest step read-only and gates on the
    held-out loss (``promote`` or ``hold``); ``serve``, when eval read
    promote, a pod that serves the checkpoint over HTTP (REQUESTS) and
    holds each answer bitwise to the restored module's forward; and the
    exit handler ``teardown``, which removes the checkpoint directory. As
    soon as the Workflow is spawned the CronWorkflow is suspended, so no
    second run starts.

    Gates: one Workflow spawned, owned by the CronWorkflow, within
    PIPELINE["cron_wait_s"] of its unsuspension; the train TpuJob
    Succeeded with restarts 0, never resumed, killed or read Restarting,
    attempt label 0 and the only TpuJob of its step; 16 launches a
    step of flash_fwd, flash_delta and flash_bwd_fused in its
    observation; eval ``promote`` at step PIPELINE["steps"] with 16
    flash_fwd a forward; serve answering REQUESTS at that version; the
    teardown pod run once, output ``clean``, the directory gone; the
    Workflow Succeeded with each step's state, attempts and output; each
    pod's process gone before the next pod started; deleting the
    CronWorkflow removes the Workflow, its pods and its TpuJob (the
    owner cascade). Numbers: the cron wait, each step's seconds from
    creation to Succeeded, the eval loss beside the fresh init's, the
    serve latencies, each pod's peak device memory, the card's
    memory.used at each step's start, the Workflow's seconds. Returns the
    launches of train, eval and serve."""
    from kubeflow_tpu_torch.controllers.cronworkflow import LABEL_CRON
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_INCARNATION
    from kubeflow_tpu_torch.controllers.workflow import LABEL_ATTEMPT, LABEL_WORKFLOW

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(root, "pipeline-ckpt")
    spawned = lambda: plane.api.list("Workflow", "default",
                                     label_selector={LABEL_CRON: "lm-nightly"})
    t_armed = time.time()
    set_suspend(plane.api, "CronWorkflow", "lm-nightly", suspend=False)
    anchored_s = t_armed - cron.metadata.creation_timestamp
    plane.run_until(lambda: spawned(), PIPELINE["spawn_timeout_s"],
                    "the CronWorkflow to spawn its Workflow")
    set_suspend(plane.api, "CronWorkflow", "lm-nightly")
    [wf] = spawned()
    name = wf.metadata.name
    cron_wait_s = wf.metadata.creation_timestamp - t_armed

    seen = {"running": set(), "succeeded": {}, "memory_at_start_mib": {},
            "train_phases": []}

    def on_job(event, obj):
        # Every committed write of the step's TpuJob, so a Restarting
        # that lasts one write is seen too.
        if obj.metadata.labels.get(LABEL_WORKFLOW) == name:
            phase = obj.status.get("phase")
            if not seen["train_phases"] or seen["train_phases"][-1] != phase:
                seen["train_phases"].append(phase)

    plane.api.watch(on_job, "TpuJob")

    def tick():
        now = time.time()
        for pod in plane.api.list("Pod", "default"):
            pname, phase = pod.metadata.name, pod.status.get("phase")
            if not pname.startswith(name):
                continue
            inc = pod.metadata.labels.get(LABEL_INCARNATION)
            key = pname if inc is None else f"{pname} incarnation {inc}"
            if phase == "Running" and key not in seen["running"]:
                seen["running"].add(key)
                seen["memory_at_start_mib"][key] = float(
                    nvidia_smi("--query-gpu=memory.used")[0])
            if phase == "Succeeded":
                seen["succeeded"].setdefault(pname, now)

    plane.run_until(
        lambda: plane.api.get("Workflow", name).status.get("phase") in ("Succeeded", "Failed"),
        PIPELINE["timeout_s"], f"Workflow {name} to finish", tick=tick)
    tick()
    wf = plane.api.get("Workflow", name)
    wf_s = time.time() - wf.metadata.creation_timestamp
    steps_status = wf.status.get("steps", {})
    jobs = plane.api.list("TpuJob", "default", label_selector={LABEL_WORKFLOW: name})
    pods = {p.metadata.name: p for p in plane.api.list(
        "Pod", "default", label_selector={LABEL_WORKFLOW: name})}
    train = jobs[0] if len(jobs) == 1 else None
    obs = (train.status.get("observation") or {}) if train else {}
    logs = plane.pod_logs()
    records = {stem: log_records(logs.get(f"{name}-{stem}.log", ""))
               for stem in ("train-0-worker-0", "eval-0", "serve-0", "teardown-0")}
    event = lambda stem, kind: [r for r in records[stem] if r["event"] == kind]
    kills = event("train-0-worker-0", "kill")
    evals, serves = event("eval-0", "eval"), event("serve-0", "serve")
    ev = evals[0] if evals else {}
    sv = serves[0] if serves else {}
    done = int(obs.get("steps_done", 0))
    train_launches = {k[len("launches_"):]: int(v) for k, v in obs.items()
                      if k.startswith("launches_")}
    want_train = {k: LM["n_layers"] * done
                  for k in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
    # The creation of each step's resource to its Succeeded (the step
    # pods' status; the train step's TpuJob as its worker pod).
    order = [f"{name}-train-0-worker-0", f"{name}-eval-0", f"{name}-serve-0",
             f"{name}-teardown-0"]
    starts = {f"{name}-{stem}": (event(stem, "start") or [{}])[-1].get("time")
              for stem in ("eval-0", "serve-0", "teardown-0")}
    sequential = all(
        seen["succeeded"].get(a) is not None and starts.get(b) is not None
        and seen["succeeded"][a] < starts[b] for a, b in zip(order, order[1:]))
    created = {"train": train.metadata.creation_timestamp if train else None,
               **{stem: pods[f"{name}-{stem}-0"].metadata.creation_timestamp
                  for stem in ("eval", "serve", "teardown") if f"{name}-{stem}-0" in pods}}
    step_s = {stem: seen["succeeded"].get(pod) - created[stem]
              for stem, pod in zip(("train", "eval", "serve", "teardown"), order)
              if created.get(stem) and seen["succeeded"].get(pod)}
    teardown_pod = pods.get(f"{name}-teardown-0")
    serve_out = json.loads(steps_status.get("serve", {}).get("output") or "{}")
    checks = {
        "one_workflow": len(spawned()) == 1,
        "owned_by_cron": [r.get("uid") for r in wf.metadata.owner_references]
        == [cron.metadata.uid],
        "cron_wait": 0.0 <= cron_wait_s <= PIPELINE["cron_wait_s"],
        "train_succeeded": train is not None and train.status.get("phase") == "Succeeded",
        "train_restarts_0": train is not None and train.status.get("restarts", 0) == 0,
        "train_not_resumed": obs.get("resumed_from") == 0.0,
        "train_one_attempt": train is not None
        and train.metadata.labels.get(LABEL_ATTEMPT) == "0"
        and steps_status.get("train", {}).get("attempts") == 1
        and steps_status.get("train", {}).get("failedAttempts") == [],
        "train_never_restarting": "Restarting" not in seen["train_phases"],
        "not_killed": kills == [],
        "train_launches": train_launches == want_train,
        "eval_promote": steps_status.get("eval", {}).get("output") == "promote",
        "eval_step": ev.get("step") == PIPELINE["steps"],
        "eval_launches": ev.get("launches") == {"flash_fwd": 2 * LM["n_layers"]},
        "serve": serve_out == {"version": PIPELINE["steps"], "answered": len(REQUESTS)}
        and all(sv.get("checks", {}).values()) and bool(sv.get("checks")),
        "teardown_once": steps_status.get("teardown", {}).get("attempts") == 1
        and len(event("teardown-0", "done")) == 1 and teardown_pod is not None
        and teardown_pod.status.get("output") == "clean",
        "checkpoint_gone": not os.path.exists(ckpt_dir),
        "workflow_succeeded": wf.status.get("phase") == "Succeeded",
        "steps_status": all(
            steps_status.get(stem, {}).get("state") == "Succeeded"
            and steps_status[stem].get("attempts") == 1 and "output" in steps_status[stem]
            for stem in ("train", "eval", "serve"))
        and steps_status.get("teardown", {}).get("state") == "Succeeded",
        "pods_one_at_a_time": sequential,
    }
    # The owner cascade: the CronWorkflow takes its run with it.
    plane.api.delete("CronWorkflow", "lm-nightly", "default")
    checks["cascade"] = (not spawned() and not plane.api.list(
        "Pod", "default", label_selector={LABEL_WORKFLOW: name}) and not plane.api.list(
        "TpuJob", "default", label_selector={LABEL_WORKFLOW: name}))
    out = {
        "phase": "pipeline", "card": card, "cron": {"schedule": cron.spec["schedule"],
                                                     "concurrencyPolicy": "Forbid"},
        "workflow": name, "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": PIPELINE["steps"],
        "save_every": PIPELINE["save_every"], "max_eval_loss": PIPELINE["max_eval_loss"],
        "cron_wait_s": cron_wait_s, "cron_anchored_s_before": anchored_s,
        "step_created_to_succeeded_s": step_s,
        "train_phases_seen": seen["train_phases"], "train_observation": obs,
        "eval": {k: ev.get(k) for k in ("step", "loss", "fresh_init_loss", "decision",
                                        "restore_s", "eval_forward_s", "launches")},
        "serve": {k: sv.get(k) for k in ("version", "load_s", "requests", "launches")},
        "serve_latency_s": [r["latency_s"] for r in sv.get("requests", [])],
        "peak_memory_gib": {"train": obs.get("peak_memory_gib"),
                            "eval": ev.get("peak_memory_gib"),
                            "serve": sv.get("peak_memory_gib")},
        "card_memory_used_at_pod_start_mib": seen["memory_at_start_mib"],
        "steps_status": steps_status, "workflow_s": wf_s, "checks": checks,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pipeline phase checks failed: {failed}")
    launches = dict(train_launches)
    for part in (ev.get("launches") or {}, sv.get("launches") or {}):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def preempt_phase(torch, card: str, plane, root: str, bare_step_ms: float,
                  worker_mib: float) -> dict:
    """Path C, the multi-tenant, highly available job plane: priority
    preemption against leader election on the card. The cluster model is
    one Node "h100-0" (pool default, 1 accelerator) and two tenants,
    team-a and team-b, each with a ResourceQuota of nvidia.com/gpu 1 (the
    facade's store has the TpuJob admission and `quota.register`). Two
    operator replicas hold one Lease "tpujob-controller" (PREEMPT's 2 s,
    1.2 s renew deadline): the leader is a `testing/workers/preempt_ha.py`
    replica that stalls PREEMPT["stall_s"] after a preemption's
    evictions, the standby the controller-manager binary with
    ``--leader-elect --controllers tpujob``. Both jobs are TRAIN's LM in
    a worker process (`lm_job_spec`): lm-low (team-a, priority 1,
    PREEMPT["low_steps"] steps) and, once lm-low has logged step
    PREEMPT["submit_at"], lm-high (team-b, priority 10,
    PREEMPT["high_steps"] steps). The leader evicts lm-low (its pod deleted, SIGTERM from
    the runner; fit() saves at the next step boundary and the worker
    exits 0 as preempted) and stalls; it is SIGKILLed on its ``evicted``
    line; the standby takes the Lease and places lm-high, which runs to
    Succeeded; lm-low is placed again after it and resumes from its
    preemption's save to its last step.

    Gates: lm-low has one Preempted event and is named by one
    PreemptedLowerPriority event, its pod uid changes once, restarts 0,
    Succeeded, its worker exited 0 with the job's observation untouched;
    resumed_from = the last step of its first run, and each of its steps
    is logged once across its runs; lm-high never evicted (one pod uid),
    Succeeded; leaseTransitions 1 -> 2 at the takeover, the standby's
    first write (its Lease acquisition) within the lease duration + the
    renew deadline + 2 s of the kill, the standby exits 0 on SIGTERM;
    each tenant's status.used["nvidia.com/gpu"] reads 1 while its job has
    a Running pod and 0 at the end; each worker run launched flash_fwd,
    flash_delta and flash_bwd_fused 16 times a step it ran; memory.used
    at lm-high's first step at most this process's reading before the
    phase + one job worker's footprint (`worker_mib`, the job phase's) +
    PREEMPT["memory_slack_mib"]. Returns the workers' launch counts."""
    from kubeflow_tpu_torch.controllers import quota
    from kubeflow_tpu_torch.controllers.leader import LEASE_KIND
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB

    t_phase = time.perf_counter()
    api = plane.api
    baseline = card_used_mib(torch)
    plane.add_node("h100-0", chips=1)
    for ns in ("team-a", "team-b"):
        plane.set_quota(ns, {"nvidia.com/gpu": 1})
    lease = dict(lease_name="tpujob-controller", lease_duration=PREEMPT["lease_s"],
                 renew_deadline=PREEMPT["renew_s"], timeout=PREEMPT["manager_ready_s"])
    leader = plane.start_preempt_ha("mgr-a", stall=PREEMPT["stall_s"],
                                    wait_for="leading mgr-a", **lease)
    standby = plane.start_manager(("tpujob",), leader_elect=True, identity="mgr-b",
                                  retry_period=PREEMPT["retry_s"], **lease)
    transitions_before = api.get(LEASE_KIND, "tpujob-controller", "").spec["leaseTransitions"]
    acquired = {}

    def on_lease(event: str, obj) -> None:
        if obj.spec.get("holderIdentity") == "mgr-b":
            acquired.setdefault("t", time.time())

    api.watch(on_lease, LEASE_KIND)
    jobs = {"lm-low": "team-a", "lm-high": "team-b"}

    def log(name: str) -> list:
        path = os.path.join(plane.capture_dir, f"{name}-worker-0.log")
        if not os.path.exists(path):
            return []
        with open(path, errors="replace") as f:
            return log_records(f.read())

    def phase(name: str):
        found = api.list("TpuJob", jobs[name])
        return next((j.status.get("phase") for j in found if j.metadata.name == name), None)

    seen = {"uids": {name: set() for name in jobs}, "quota": [], "memory_t": 0.0,
            "memory_max": baseline, "running": {}}

    def tick() -> None:
        now = time.time()
        for name, ns in jobs.items():
            pods = api.list("Pod", ns, label_selector={LABEL_JOB: name})
            seen["uids"][name] |= {p.metadata.uid for p in pods}
            running = any(p.status.get("phase") == "Running" for p in pods)
            for p in pods:
                if p.status.get("phase") == "Running":
                    seen["running"].setdefault(p.metadata.uid, now)
            used = api.get("ResourceQuota", quota.QUOTA_NAME, ns).status.get("used", {})
            seen["quota"].append((now, ns, running, used.get("nvidia.com/gpu")))
        if "high_succeeded" not in seen and phase("lm-high") == "Succeeded":
            seen["high_succeeded"] = now
        for (ns, name, _), ev in plane.runner.evictions.items():
            if ns == "team-a" and ev["exit"] is not None and "victim_exit_obs" not in seen:
                seen["victim_exit_obs"] = api.get("TpuJob", "lm-low", ns).status.get(
                    "observation")
        if "high_first_step_mib" not in seen and any(r["event"] == "step"
                                                     for r in log("lm-high")):
            seen["high_first_step_mib"] = float(nvidia_smi("--query-gpu=memory.used")[0])
        if now - seen["memory_t"] >= 1.0:
            seen["memory_t"] = now
            seen["memory_max"] = max(seen["memory_max"],
                                     float(nvidia_smi("--query-gpu=memory.used")[0]))

    t_create = time.time()
    api.create(lm_job_spec("lm-low", "team-a", 1, PREEMPT["low_steps"], root))
    plane.run_until(lambda: any(r["event"] == "step" and r["step"] >= PREEMPT["submit_at"]
                                for r in log("lm-low")),
                    PREEMPT["timeout_s"], f"lm-low's step {PREEMPT['submit_at']}", tick=tick)
    t_submit = time.time()
    api.create(lm_job_spec("lm-high", "team-b", 10, PREEMPT["high_steps"], root))
    plane.run_until(lambda: leader.line_time("evicted mgr-a") is not None,
                    PREEMPT["timeout_s"], "the leader's eviction", tick=tick)
    t_kill = leader.kill()
    plane.run_until(lambda: phase("lm-low") in ("Succeeded", "Failed")
                    and phase("lm-high") in ("Succeeded", "Failed"),
                    PREEMPT["timeout_s"], "lm-low and lm-high to finish", tick=tick)
    t_done = time.time()

    def used_after() -> dict:
        return {ns: api.get("ResourceQuota", quota.QUOTA_NAME, ns).status.get("used", {}).get(
            "nvidia.com/gpu") for ns in jobs.values()}

    # status.used is published asynchronously: give it a moment to reach 0.
    deadline = time.monotonic() + 10
    while any(used_after().values()) and time.monotonic() < deadline:
        time.sleep(0.05)
    final_used = used_after()
    standby_code = standby.stop()

    low, high = (api.get("TpuJob", n, ns) for n, ns in jobs.items())
    low_records, high_records = log("lm-low"), log("lm-high")
    pids = sorted({r["pid"] for r in low_records},
                  key=lambda pid: min(r["time"] for r in low_records if r["pid"] == pid))
    preempted = [r for r in low_records if r["event"] == "preempted"]
    k = preempted[0]["step"] if len(preempted) == 1 else None
    low_steps = [(r["pid"], r["step"]) for r in low_records if r["event"] == "step"]
    first_resumed = next((r for r in low_records if r["event"] == "step"
                          and len(pids) == 2 and r["pid"] == pids[1]), None)
    high_first = next((r for r in high_records if r["event"] == "step"), None)
    low_obs, high_obs = low.status.get("observation") or {}, high.status.get("observation") or {}
    evictions = [(key, ev) for key, ev in plane.runner.evictions.items()
                 if key[0] == "team-a"]
    eviction = evictions[0][1] if len(evictions) == 1 else {}
    events = {ns: [e.spec for e in api.list("Event", ns)] for ns in jobs.values()}
    preempted_events = [e["involvedObject"]["name"] for ns in events for e in events[ns]
                        if e["reason"] == "Preempted"]
    lowered = [e["message"] for e in events["team-b"] if e["reason"] == "PreemptedLowerPriority"]
    lease_obj = api.get(LEASE_KIND, "tpujob-controller", "")
    high_pod = api.list("Pod", "team-b", label_selector={LABEL_JOB: "lm-high"})
    kernels = ("flash_fwd", "flash_delta", "flash_bwd_fused")
    runs = {"lm-low:preempted": (preempted[0] if k is not None else {}),
            "lm-low:resumed": low_obs, "lm-high": high_obs}
    run_launches = {run: {name: int(rec.get(f"launches_{name}", 0)) for name in kernels}
                    for run, rec in runs.items()}
    run_steps = {run: int(rec.get("steps_done", 0)) for run, rec in runs.items()}
    launches = {name: sum(r[name] for r in run_launches.values()) for name in kernels}
    quota_live = {ns: [used for _, n, running, used in seen["quota"] if n == ns and running]
                  for ns in jobs.values()}
    memory_limit = baseline + worker_mib + PREEMPT["memory_slack_mib"]
    takeover_s = acquired["t"] - t_kill if "t" in acquired else None
    checks = {
        "low_one_preempted_event": preempted_events == ["lm-low"],
        "low_named_by_one_preemptor_event": len(lowered) == 1
        and lowered[0].endswith(": team-a/lm-low"),
        "low_pod_uid_changed_once": len(seen["uids"]["lm-low"]) == 2,
        "low_restarts_0": low.status.get("restarts", 0) == 0,
        "low_succeeded": low.status.get("phase") == "Succeeded",
        "victim_exit_0": eviction.get("returncode") == 0,
        "victim_observation_untouched": "victim_exit_obs" in seen
        and seen["victim_exit_obs"] is None,
        "resumed_from_preempted_step": k is not None and low_obs.get("resumed_from") == float(k),
        "low_steps_once": len(pids) == 2 and k is not None
        and [s for pid, s in low_steps if pid == pids[0]] == list(range(1, k + 1))
        and [s for pid, s in low_steps if pid == pids[1]]
        == list(range(k + 1, PREEMPT["low_steps"] + 1)),
        "high_never_evicted": len(seen["uids"]["lm-high"]) == 1
        and "lm-high" not in preempted_events,
        "high_succeeded": high.status.get("phase") == "Succeeded",
        "lease_transitions_plus_one": lease_obj.spec["leaseTransitions"]
        == transitions_before + 1,
        "standby_first_write_in_time": takeover_s is not None
        and takeover_s <= PREEMPT["lease_s"] + PREEMPT["renew_s"] + 2.0,
        "standby_exit_0": standby_code == 0,
        "quota_used_1_while_running": all(v and all(u == 1 for u in v)
                                          for v in quota_live.values()),
        "quota_used_0_after": final_used == {ns: 0 for ns in jobs.values()},
        "worker_launches": all(all(n == LM["n_layers"] * run_steps[run]
                                   for n in run_launches[run].values()) and run_steps[run] > 0
                               for run in runs),
        "memory_at_high_first_step": seen.get("high_first_step_mib", float("inf"))
        <= memory_limit,
    }
    out = {
        "phase": "preempt", "card": card, "jobs": {
            "lm-low": {"namespace": "team-a", "priority": 1, "steps": PREEMPT["low_steps"]},
            "lm-high": {"namespace": "team-b", "priority": 10, "steps": PREEMPT["high_steps"]}},
        "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "config": PREEMPT,
        "preempted_at_step": k, "resumed_from": low_obs.get("resumed_from"),
        "leadership": plane.leadership(), "lease_transitions": [
            transitions_before, lease_obj.spec["leaseTransitions"]],
        "sigterm_to_victim_exit_s": (eviction["exit"] - eviction["sigterm"]
                                     if eviction.get("exit") else None),
        # The victim's exit, split: to fit()'s return (the step under way,
        # the forced save and fit()'s wait for every pending save's
        # write), to the writer closed, to the process's end.
        "victim_exit_split_s": ({
            "to_fit_returned": preempted[0]["fit_returned"] - eviction["sigterm"],
            "writer_close": preempted[0]["time"] - preempted[0]["fit_returned"],
            "to_exit": eviction["exit"] - preempted[0]["time"]}
            if k is not None and eviction.get("exit") else None),
        # > 0: both workers were processes at once for that long.
        "victim_exit_after_preemptor_spawn_s": (
            eviction["exit"] - seen["running"][high_pod[0].metadata.uid]
            if eviction.get("exit") and high_pod
            and high_pod[0].metadata.uid in seen["running"] else None),
        "submit_to_eviction_s": eviction["sigterm"] - t_submit if eviction else None,
        "eviction_to_preemptor_first_step_s": (high_first["time"] - eviction["sigterm"]
                                               if high_first and eviction else None),
        "kill_to_standby_first_write_s": takeover_s,
        "kill_to_preemptor_placed_s": (high_pod[0].metadata.creation_timestamp - t_kill
                                       if high_pod else None),
        "high_succeeded_to_low_resumed_step_s": (first_resumed["time"] - seen["high_succeeded"]
                                                 if first_resumed and "high_succeeded" in seen
                                                 else None),
        "step_ms": {"lm-low:preempted": statistics.median(
                        [r["step_ms"] for r in low_records if r["event"] == "step"
                         and r["pid"] == pids[0] and r["step"] > 1]) if pids else None,
                    "lm-low:resumed": low_obs.get("step_ms"),
                    "lm-high": high_obs.get("step_ms"), "train_phase": bare_step_ms},
        "card_memory_used_mib": {
            "before_phase": baseline, "one_worker_footprint": worker_mib,
            "at_high_first_step": seen.get("high_first_step_mib"), "limit": memory_limit,
            "max_during_phase": seen["memory_max"]},
        "worker_peak_memory_gib": {"lm-low": low_obs.get("peak_memory_gib"),
                                   "lm-high": high_obs.get("peak_memory_gib")},
        "quota_used_while_running": {ns: sorted(set(v), key=str) for ns, v in quota_live.items()},
        "quota_used_after": final_used,
        "run_launches": run_launches, "run_steps": run_steps, "checks": checks,
        "wall_s": t_done - t_create, "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"preempt phase checks failed: {failed}")
    return launches


def node_lost_phase(torch, card: str, plane, root: str, straight_losses: list) -> dict:
    """Path E, a lost Node: ResNet-50 trained from record files as a
    TpuJob ("rn-records": 1 worker, 1 GPU, maxRestarts 1) on a cluster
    model of two one-GPU Nodes, the binary running the nodehealth
    controller beside the operator. The worker
    (`testing/workers/resnet_records_job.py`) reads records_fit's file
    (written anew here from SEED) through `device_iter()` and trains
    through fit() with an AnomalyGuard and a Checkpointer, cuDNN
    deterministic, NODE_LOST["step_sleep_s"] slept after each step. The
    port's sidecar CLI runs beside it as its own process: its CUDA
    probe, the SIGCONT the worker waits for, the job watch, SIGTERM, the
    upload of the worker's results.

    Once step NODE_LOST["lose_after"] is logged and the step-4 save is
    committed, `plane.lose_node` SIGKILLs the worker and deletes its
    Node. Gates: the pod Failed with reason NodeLost and one NodeLost
    event; one restart, on the surviving Node; Succeeded with
    resumed_from 4; steps 5 and 6 repeated bitwise; the dataset's
    position equal to the step on every line; no flash launch; the
    sidecar's SIGCONT before the first step, its pid never among
    nvidia-smi's compute apps, SIGTERM written, the results uploaded,
    exit 0 on Succeeded. Before the job, the sidecar's CUDA probe runs
    alone in a process kept alive after it answers True: nvidia-smi's
    compute processes and memory.used (under 64 MiB more) must not move,
    since a machine may list every container process under one host pid.
    Numbers: the Node's loss to the NodeLost write, to the new pod, to
    the worker's start and to its first resumed step; each incarnation's
    start line, gate, restore, fast-forward and first step from its
    spawn; restore and fast-forward seconds; the job's step ms; each
    step's loss against records_fit's straight run (`straight_losses`,
    the same file, seed and setup). The surviving Node is deleted at the
    end. Returns the worker's launch counts."""
    from kubeflow_tpu_torch.api import make_tpujob
    from kubeflow_tpu_torch.controllers.nodehealth import REASON_NODE_LOST
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_INCARNATION, LABEL_JOB

    t_phase = time.perf_counter()
    cfg, name = NODE_LOST, "rn-records"
    pod_name = f"{name}-worker-0"
    path = os.path.join(root, "node-lost.rec")
    written = write_record_file(path)
    ckpt_dir, sig, results, store = (os.path.join(root, f"node-lost-{d}")
                                     for d in ("ckpt", "sig", "results", "store"))
    nodes = ("h100-a", "h100-b")
    # The sidecar's CUDA probe, alone in a process that stays alive after
    # it answered: no CUDA context means no new compute process on the
    # card and no memory (a context holds ~500 MiB).
    before = {"rows": compute_app_rows(), "mib": card_used_mib(torch)}
    probe = subprocess.Popen(
        [sys.executable, "-c", "import sys; from kubeflow_tpu_torch.sidecar.controller import "
         "default_device_probe; print(default_device_probe(), flush=True); sys.stdin.read()"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        probed = probe.stdout.readline().strip()
        during = {"rows": compute_app_rows(),
                  "mib": float(nvidia_smi("--query-gpu=memory.used")[0])}
    finally:
        probe.stdin.close()
        probe.wait(timeout=30)
    pods = []

    def on_pod(event, pod):
        if pod.metadata.labels.get(LABEL_JOB) == name:
            pods.append((time.time(), event, pod.metadata.labels.get(LABEL_INCARNATION),
                         pod.spec.get("nodeName"), pod.status.get("phase"),
                         pod.status.get("reason")))

    plane.api.watch(on_pod, "Pod")
    for node in nodes:
        plane.add_node(node, chips=1)
    env = {
        "KFTPU_RECORDS": path, "KFTPU_SHUFFLE_BUFFER": str(RECORDS["shuffle_buffer"]),
        "KFTPU_DATA_SEED": str(SEED), "KFTPU_CKPT_DIR": ckpt_dir,
        "KFTPU_TOTAL_STEPS": str(cfg["steps"]), "KFTPU_SAVE_EVERY": str(cfg["save_every"]),
        "KFTPU_STEP_SLEEP_S": str(cfg["step_sleep_s"]), "KFTPU_SIGNAL_DIR": sig,
        "KFTPU_RESULTS_DIR": results,
        "KFTPU_RESNET_SIZE": json.dumps({"model": cfg["model"], "classes": RESNET["classes"],
                                         "image": RESNET["image"], "batch": RECORDS["batch"],
                                         "lr": RESNET["lr"]}),
    }
    plane.api.create(make_tpujob(
        name, replicas=1, tpu_chips_per_worker=1, max_restarts=cfg["max_restarts"],
        command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                 "kubeflow_tpu_torch.testing.workers.resnet_records_job:main"),
        env=tuple(env.items())))
    t_created = time.time()
    # After the create: a sidecar whose first poll finds no job reads it
    # as Failed.
    sidecar = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.sidecar", "--workdir", sig, "--job", name,
         "--apiserver", plane.url, "--poll-seconds", str(cfg["poll_s"]),
         "--timeout-seconds", str(cfg["timeout_s"]), "--results", results,
         "--artifacts", store],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    apps = {"sidecar_seen": False, "pids_seen": set(), "max_rows": 0, "t": 0.0}

    def tick():
        now = time.time()
        if now - apps["t"] >= 1.0:
            apps["t"] = now
            rows = nvidia_smi("--query-compute-apps=pid,used_memory")
            seen = {int(r.partition(",")[0]) for r in rows if r.partition(",")[0].isdigit()}
            apps["max_rows"] = max(apps["max_rows"], len(rows))
            apps["pids_seen"] |= seen
            apps["sidecar_seen"] |= sidecar.pid in seen

    def log():
        return log_records(plane.pod_logs().get(f"{pod_name}.log", ""))

    def logged(inc: int, step: int) -> bool:
        return any(r["event"] == "step" and r["incarnation"] == inc and r["step"] == step
                   for r in log())

    committed_manifest = os.path.join(ckpt_dir, str(cfg["save_every"]), "kftpu_manifest.json")
    survivor = None
    try:
        plane.run_until(lambda: logged(0, cfg["lose_after"]) and
                        os.path.exists(committed_manifest), cfg["timeout_s"],
                        f"{name}: step {cfg['lose_after']} and the step-{cfg['save_every']} "
                        "save", tick=tick)
        committed = max(int(d) for d in os.listdir(ckpt_dir) if d.isdigit() and
                        os.path.exists(os.path.join(ckpt_dir, d, "kftpu_manifest.json")))
        host = plane.api.get("Pod", pod_name).spec["nodeName"]
        t_lost = time.time()
        killed = plane.lose_node(host)
        plane.run_until(lambda: plane.api.get("TpuJob", name).status.get("phase")
                        in ("Succeeded", "Failed"), cfg["timeout_s"], f"{name} to finish",
                        tick=tick)
        t_done = time.time()
        job = plane.api.get("TpuJob", name)
        survivor = plane.api.get("Pod", pod_name).spec.get("nodeName")
        sidecar_out, _ = sidecar.communicate(timeout=cfg["sidecar_exit_s"])
        t_sidecar = time.time()
        events = [e for e in plane.api.list("Event", "default")
                  if e.spec["reason"] == REASON_NODE_LOST
                  and e.spec["involvedObject"]["name"] == pod_name]
        records = log()
    finally:
        if sidecar.poll() is None:
            sidecar.kill()
            print(f"node_lost: the sidecar was killed; its output:\n{sidecar.communicate()[0]}",
                  file=sys.stderr, flush=True)
        for node in nodes:
            if any(n.metadata.name == node for n in plane.api.list("Node")):
                plane.api.delete("Node", node, "")
    obs = job.status.get("observation") or {}
    steps = {(r["incarnation"], r["step"]): r for r in records if r["event"] == "step"}
    starts = {r["incarnation"]: r for r in records if r["event"] == "start"}
    gates = {r["incarnation"]: r for r in records if r["event"] == "gate"}
    restored = [r for r in records if r["event"] == "restored"]
    forwarded = [r for r in records if r["event"] == "fast_forward"]
    lost = [p for p in pods if p[4] == "Failed"]
    new_pod = min((p[0] for p in pods if p[1] == "ADDED" and p[2] == "1"), default=None)
    running = {}
    for t, _, inc, _, phase, _ in pods:
        if phase == "Running":
            running.setdefault(int(inc), t)
    # Each incarnation from the runner's spawn (the pod's Running): its
    # start line (torch imported, the job read), the gate, the restore
    # and fast-forward, the first step.
    timeline = {}
    for inc, spawned in running.items():
        marks = {"start": starts.get(inc), "gate": gates.get(inc),
                 "restored": next((r for r in restored if r["incarnation"] == inc), None),
                 "fast_forward": next((r for r in forwarded if r["incarnation"] == inc), None),
                 "first_step": min((r for (i, _), r in steps.items() if i == inc),
                                   key=lambda r: r["step"], default=None)}
        timeline[inc] = {k: r["time"] - spawned for k, r in marks.items() if r}
    first_resumed = min((r for (i, _), r in steps.items() if i == 1),
                        key=lambda r: r["step"], default=None)
    first_step = min((r["time"] for (i, _), r in steps.items() if i == 0), default=None)
    repeated = [s for i, s in steps if i == 0 and s > committed]
    loss = lambda inc, step: steps.get((inc, step), {}).get("loss")
    vs_records_fit = {f"{i}:{s}": abs(r["loss"] - straight_losses[s - 1])
                      for (i, s), r in sorted(steps.items()) if s <= len(straight_losses)}
    launches = {k[len("launches_"):]: int(v) for k, v in obs.items()
                if k.startswith("launches_")}
    sigcont = os.path.join(sig, "SIGCONT")
    checks = {
        "killed_the_worker": killed == [pod_name],
        "pod_failed_node_lost": bool(lost) and {p[5] for p in lost} == {REASON_NODE_LOST}
        and {(p[2], p[3]) for p in lost} == {("0", host)},
        "one_node_lost_event": len(events) == 1 and events[0].spec["type"] == "Warning",
        "restarted_once_on_the_survivor": job.status.get("restarts") == 1
        and survivor not in (None, host),
        "succeeded": job.status.get("phase") == "Succeeded",
        "resumed_from_4": committed == cfg["save_every"]
        and obs.get("resumed_from") == float(cfg["save_every"]),
        "resumed_curve": sorted(s for i, s in steps if i == 1)
        == list(range(cfg["save_every"] + 1, cfg["steps"] + 1)),
        "restored_position": [(r["incarnation"], r["data_state"]) for r in restored]
        == [(1, {"batches_delivered": cfg["save_every"]})],
        "repeated_steps_bitwise": repeated[:2] == [cfg["save_every"] + 1, cfg["save_every"] + 2]
        and all(loss(0, s) == loss(1, s) for s in repeated),
        "position_is_the_step": all(r["batches_delivered"] == r["step"]
                                    for r in steps.values()),
        "no_flash_launches": not launches,
        "sidecar_gate_before_first_step": os.path.exists(sigcont) and first_step is not None
        and os.path.getmtime(sigcont) <= first_step and set(gates) == {0, 1},
        "probe_creates_no_context": probed == "True" and during["rows"] == before["rows"]
        and during["mib"] - before["mib"] < 64,
        "sidecar_pid_never_on_the_card": not apps["sidecar_seen"],
        "sidecar_sigterm": os.path.exists(os.path.join(sig, "SIGTERM")),
        "sidecar_uploaded": os.path.exists(os.path.join(store, "observation.json")),
        "sidecar_exit_0_succeeded": sidecar.returncode == 0
        and "terminal phase: Succeeded" in sidecar_out,
    }
    out = {
        "phase": "node_lost", "card": card, "job": name, "nodes": list(nodes),
        "worker_command": "python -m kubeflow_tpu_torch.launcher --module "
        "kubeflow_tpu_torch.testing.workers.resnet_records_job:main",
        "model": cfg["model"], "batch": RECORDS["batch"], "records_file": written,
        "steps": cfg["steps"], "save_every": cfg["save_every"],
        "lose_after": cfg["lose_after"], "step_sleep_s": cfg["step_sleep_s"],
        "lost_node": host, "survivor": survivor, "committed_at_loss": committed,
        "phase_final": job.status.get("phase"), "restarts": job.status.get("restarts"),
        "observation": obs,
        "loss_to_node_lost_write_s": lost[0][0] - t_lost if lost else None,
        "loss_to_new_pod_s": new_pod - t_lost if new_pod else None,
        "loss_to_worker_start_s": starts[1]["time"] - t_lost if 1 in starts else None,
        "loss_to_first_resumed_step_s": (first_resumed["time"] - t_lost
                                         if first_resumed else None),
        "create_to_first_step_s": first_step - t_created if first_step else None,
        "from_spawn_s": timeline,
        "restore_s": restored[0]["restore_s"] if restored else None,
        "fast_forward_s": [r["seconds"] for r in forwarded],
        "job_step_ms": obs.get("step_ms"),
        "step_ms_by_step": {f"{i}:{s}": r["step_ms"] for (i, s), r in sorted(steps.items())},
        "losses": {f"{i}:{s}": r["loss"] for (i, s), r in sorted(steps.items())},
        "abs_diff_vs_records_fit": vs_records_fit,
        "max_abs_diff_vs_records_fit": max(vs_records_fit.values(), default=None),
        "sidecar": {"pid": sidecar.pid, "returncode": sidecar.returncode,
                    "exit_after_job_s": t_sidecar - t_done,
                    "last_line": sidecar_out.strip().splitlines()[-1:]},
        "probe": {"answered": probed, "before": before, "during": during},
        "compute_apps_pids_seen": sorted(apps["pids_seen"]),
        "compute_apps_max_rows": apps["max_rows"],
        "worker_pids": sorted({r["pid"] for r in starts.values()}),
        "launches": launches, "checks": checks, "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [key for key, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"node_lost checks failed: {failed}")
    return launches


def tier_phase(name: str, card: str, reports: dict) -> dict:
    """The compiled control-plane tier of one phase's managers: each
    manager's last ``plane`` line (`controllers.runtime.plane_report`: its
    controllers' work-queue backends and its TpuJob operator's
    tpujob_gang_placements_total by scheduler backend, which it prints
    when ready, before each ``evicted`` line and at exit), and the
    placements summed over them. Fails unless every manager reported, every
    work queue is the compiled one, and the managers placed gangs on the
    compiled scheduler (native > 0) and never on the Python twin."""
    placements = {backend: sum(int(r["tpujob_gang_placements_total"][backend])
                               for r in reports.values() if r)
                  for backend in ("native", "python", "custom")}
    checks = {
        "every_manager_reported": bool(reports) and None not in reports.values(),
        "compiled_work_queues": all(r and set(r["workqueue"].values()) == {"native"}
                                    for r in reports.values()),
        "native_placements": placements["native"] > 0,
        "no_python_placements": placements["python"] == 0,
    }
    emit({"phase": f"{name}_tier", "card": card, "managers": reports,
          "placements": placements, "checks": checks})
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name}'s compiled tier checks failed: {failed}")
    return placements


def ci_dag_phase(card: str, plane, root: str) -> dict:
    """Path K, the kernel CI DAG on the job plane's binary (its workflow
    controller) and pod runner: `testing/workflows.sharded_unit_tests_workflow`
    fans CI_DAG["shards"] out as one pod each (``python -m
    kubeflow_tpu_torch.testing.shard_runner <shard> --junit-dir <artifacts>
    --pytest-args ...``: the card's kernel tests, on the kernels the build
    phase built) and then merges their junit (``python -m
    kubeflow_tpu_torch.testing.junit_merge``). Gates: the Workflow
    Succeeded, every shard step and the collect step Succeeded, a junit
    file per shard in the artifacts directory, and junit_merged.xml with
    tests > 0, failures 0 and errors 0. Numbers: the counts, each shard's
    seconds (its state seen Running to Succeeded on the host's clock, and
    pytest's own time from its junit) and the Workflow's."""
    import xml.etree.ElementTree as ET

    from kubeflow_tpu_torch.testing.shard_runner import safe_name
    from kubeflow_tpu_torch.testing.workflows import sharded_unit_tests_workflow

    artifacts = os.path.join(root, "ci-artifacts")
    os.makedirs(artifacts)
    name = "kernel-ci"
    wf = sharded_unit_tests_workflow(CI_DAG["shards"], name=name, namespace="default",
                                     artifacts_dir=artifacts,
                                     pytest_args=CI_DAG["pytest_args"])
    api = plane.api
    seen: dict = {}

    def status() -> dict:
        st = api.get("Workflow", name).status
        now = time.time()
        for step, info in st.get("steps", {}).items():
            seen.setdefault(step, {}).setdefault(info.get("state"), now)
        return st

    t0 = time.time()
    api.create(wf)
    plane.run_until(lambda: status().get("phase") in ("Succeeded", "Failed"),
                    CI_DAG["timeout_s"], f"Workflow {name} to finish")
    wall_s = time.time() - t0
    final = status()
    steps = final.get("steps", {})
    shards = {}
    for i, target in enumerate(CI_DAG["shards"]):
        path = os.path.join(artifacts, f"junit_{safe_name(target)}.xml")
        suite = ET.parse(path).getroot() if os.path.exists(path) else None
        if suite is not None and suite.tag != "testsuite":
            suite = suite.find("testsuite")
        marks = seen.get(f"shard-{i}", {})
        start = marks.get("Running", marks.get("Succeeded"))
        shards[target] = {
            "state": steps.get(f"shard-{i}", {}).get("state"),
            "junit": os.path.basename(path) if suite is not None else None,
            "tests": int(suite.get("tests", 0)) if suite is not None else None,
            "pytest_s": float(suite.get("time", 0)) if suite is not None else None,
            "seconds": marks["Succeeded"] - start if "Succeeded" in marks and start else None,
        }
    merged_path = os.path.join(artifacts, "junit_merged.xml")
    merged = ET.parse(merged_path).getroot() if os.path.exists(merged_path) else None
    counts = {k: int(merged.get(k, -1)) if merged is not None else None
              for k in ("tests", "failures", "errors")}
    checks = {
        "succeeded": final.get("phase") == "Succeeded",
        "every_step_succeeded": all(steps.get(f"shard-{i}", {}).get("state") == "Succeeded"
                                    for i in range(len(CI_DAG["shards"])))
        and steps.get("collect-junit", {}).get("state") == "Succeeded",
        "junit_per_shard": all(v["junit"] for v in shards.values()),
        "merged_clean": merged is not None and counts["tests"] > 0
        and counts["failures"] == 0 and counts["errors"] == 0,
    }
    out = {"phase": "ci_dag", "card": card, "workflow": name, "shards": shards,
           "merged": counts, "pytest_args": CI_DAG["pytest_args"],
           "phase_final": final.get("phase"), "workflow_s": wall_s, "checks": checks}
    emit(out)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ci_dag phase checks failed: {failed}")
    return out


def job_plane_phases(torch, card: str, bare_step_ms: float, loss_se: float,
                     records_losses: list) -> dict:
    """Paths A, L, B, D, E, K and C on one job plane (`testing/job_plane.JobPlane`):
    the apiserver facade over this process's store (with the TpuJob and
    ResourceQuota admission), the controller-manager binary as its own
    process (``--controllers tpujob,study,workflow,cronworkflow,nodehealth``)
    and the local pod runner stepped here. This process gives back its
    cached card memory before anything is spawned. The manager must exit
    0 on SIGTERM after paths A, B, D, E and K; path C then starts its two
    leader-elected replicas on the same facade. Then the plane's compiled
    tier (`tier_phase`) over the three managers: compiled work queues, and
    gangs placed by the compiled scheduler only (paths E and C place on
    Nodes). The pods, the managers
    and the facade are reaped on every exit path, and on a failure the
    managers' output, the leadership timeline and the pod logs are
    printed. `bare_step_ms` is the train phase's step, `loss_se`
    train_check's bf16 standard error of the mean loss, `records_losses`
    records_fit's straight run. Returns paths A's, L's, D's, E's and C's
    launch counts."""
    from kubeflow_tpu_torch.testing.job_plane import JobPlane

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kftpu_jobs_")
    plane = None
    try:
        plane = JobPlane(controllers=("tpujob", "study", "workflow", "cronworkflow",
                                      "nodehealth"),
                         capture_dir=os.path.join(root, "logs"),
                         ready_timeout=JOB["manager_ready_s"])
        # Anchored now: by the pipeline phase its first tick is long past.
        cron = pipeline_cron(plane, root)
        launches, worker_mib, path_a = job_phase(torch, card, plane, root, bare_step_ms,
                                                 LOSS_Z * loss_se)
        gang_launches = gang_job_phase(torch, card, plane, root, bare_step_ms, path_a)
        rl_soak_phase(torch, card, plane, root)
        pipeline_launches = pipeline_phase(torch, card, plane, root, cron)
        node_lost_launches = node_lost_phase(torch, card, plane, root, records_losses)
        ci_dag_phase(card, plane, root)
        code = plane.stop_manager()
        if code != 0:
            raise AssertionError(f"the controller manager exited {code} on SIGTERM")
        preempt_launches = preempt_phase(torch, card, plane, root, bare_step_ms, worker_mib)
        tier_phase("job_plane", card, plane.plane_reports())
    except BaseException:
        if plane is not None:
            print(plane.diagnostics(), file=sys.stderr, flush=True)
        raise
    finally:
        if plane is not None:
            plane.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"job": launches, "gang": gang_launches, "pipeline": pipeline_launches,
            "node_lost": node_lost_launches, "preempt": preempt_launches}, path_a


def port_refuses(port: int) -> bool:
    """Whether nothing accepts a connection on localhost:`port`."""
    import socket

    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    except OSError:
        return True
    return False


def ha_job_phase(torch, card: str, path_a: dict) -> dict:
    """Path F, the durable, highly available control plane: an HA
    `JobPlane` (two processes of `testing/workers/apiserver.py`,
    "facade-a" active and "facade-b" standby, over one WAL-backed store,
    https with a CA minted for the pair; the apiserver lease 3 s), the
    binary on ``--apiserver https://a,https://b --ca``
    running the tpujob controller leader-elected, and the pod runner on
    an `HttpApiClient` over the same list. The full-width LM trains as
    TpuJob "lm-ha" (1 worker, 1 GPU, HA_JOB["steps"] steps through fit()
    on the default dispatch). Once the worker's step HA_JOB["kill_after"]
    is acked the active facade is SIGKILLed; the standby takes the lease
    over, replays the WAL and serves.

    Gates: Succeeded with status.restarts 0 and one worker process;
    every step the worker saw acked in the final status.metrics, and in
    a fresh store booted over a copy of the state directory once the
    plane is down (the WAL diff), which also holds the final status;
    exactly one pod for the one replica; each step's loss against path
    A's (`path_a`: bitwise, or within its loss limit, the line says
    which; steps past path A's 6 are not compared); 16 launches a step
    of flash_fwd, flash_delta and flash_bwd_fused in the worker; the
    killed facade exited by SIGKILL and its port refuses connections to
    the end; both facades' stores on the compiled WAL, and ``wal.log`` on a
    new inode after the standby's takeover (its checkpoint renamed a fresh
    log over it: the inode it found and the one after, in its ``takeover``
    line); the compiled tier (`tier_phase`: the binary's work queue, and the
    gang placed on the one-GPU Node "h100-0" by the compiled scheduler).
    Numbers: kill to standby serving; kill to the first acked
    write through the new active from the worker (its step reports),
    the binary (its Lease renewals) and the runner's client (a probe
    write every HA_JOB["probe_every_s"]); the worker's step ms across the
    failover beside path A's; each client's failovers and connections
    dialed (refused dials included), and the TLS handshakes the surviving
    facade completed and the requests it served; the WAL's bytes and
    `open_active_store`'s seconds at takeover; whether TLS was used and
    which tool made the certs. Returns the worker's launch counts."""
    import signal

    from kubeflow_tpu_torch.api import make_tpujob
    from kubeflow_tpu_torch.api.objects import new_resource
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
    from kubeflow_tpu_torch.testing.job_plane import JobPlane

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kftpu_ha_")
    state = os.path.join(root, "state")
    steps = HA_JOB["steps"]
    env = {
        "KFTPU_CKPT_DIR": os.path.join(root, "lm-ckpt"),
        "KFTPU_TOTAL_STEPS": str(steps),
        "KFTPU_SAVE_EVERY": str(steps),
        "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                                     "dtype": "bfloat16", "lr": TRAIN["lr"]}),
    }
    plane = None
    try:
        plane = JobPlane(controllers=(), capture_dir=os.path.join(root, "logs"),
                         ha_state_dir=state, ready_timeout=HA_JOB["manager_ready_s"])
        facades_ready_s = time.time() - plane.started
        manager = plane.start_manager(
            ("tpujob",), leader_elect=True, identity="manager",
            lease_duration=HA_JOB["manager_lease_s"], renew_deadline=HA_JOB["manager_renew_s"],
            retry_period=HA_JOB["manager_retry_s"], wait_for="manager ready tpujob",
            timeout=HA_JOB["manager_ready_s"])
        api = plane.api
        plane.add_node("h100-0", chips=1)  # the gang places through the scheduler
        probe = {"last": 0.0, "acked": []}

        def tick():
            now = time.time()
            if now - probe["last"] >= HA_JOB["probe_every_s"]:
                probe["last"] = now
                try:
                    cm = api.get("ConfigMap", "ha-probe").thaw()
                    cm.spec = {"t": now}
                    api.update(cm)
                except NotFound:
                    api.create(new_resource("ConfigMap", "ha-probe", spec={"t": now}))
                probe["acked"].append(time.time())

        def curve():
            return {p["step"]: p["loss"] for p in
                    api.get("TpuJob", "lm-ha").status.get("metrics", [])}

        t_create = time.time()
        api.create(make_tpujob(
            "lm-ha", replicas=1, tpu_chips_per_worker=1, max_restarts=1,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items())))
        plane.run_until(lambda: HA_JOB["kill_after"] in curve(), HA_JOB["timeout_s"],
                        f"lm-ha's step {HA_JOB['kill_after']} acked", tick=tick)
        killed = plane.active_facade()
        killed_port = int(plane.endpoints[plane.facades.index(killed)].rsplit(":", 1)[1])
        acked_before_kill = sorted(curve())
        t_kill = plane.kill_active_facade()
        refused_after_kill = port_refuses(killed_port)
        lease = {}

        def watch_lease():
            tick()
            if "renewed" not in lease:
                spec = api.get("Lease", "controller-manager", "").spec
                if float(spec.get("renewTime", 0.0)) > t_kill:
                    lease["renewed"] = float(spec["renewTime"])
                    lease["seen"] = time.time()

        plane.run_until(lambda: api.get("TpuJob", "lm-ha").status.get("phase")
                        in ("Succeeded", "Failed"), HA_JOB["timeout_s"],
                        "TpuJob lm-ha to finish", tick=watch_lease)
        plane.run_until(lambda: "renewed" in lease, 30, "the binary's first renewal",
                        tick=watch_lease)
        wall_s = time.time() - t_create
        job = api.get("TpuJob", "lm-ha")
        pods = api.list("Pod", "default", label_selector={LABEL_JOB: "lm-ha"})
        survivor = plane.active_facade()
        records = log_records(plane.pod_logs().get("lm-ha-worker-0.log", ""))
        runner_client = {"failovers": api.failovers, "handshakes": api.handshakes}
        if manager.stop() != 0:
            raise AssertionError("the leader-elected binary did not exit 0 on SIGTERM")
        binary_client = json.loads(next(
            line for _, line in reversed(manager.lines)
            if line.startswith("client "))[len("client "):])
        tier_phase("ha_job", card, plane.plane_reports())
        takeover = json.loads(next(line for _, line in survivor.lines
                                   if line.startswith("takeover "))[len("takeover "):])
        first_takeover = json.loads(next(line for _, line in killed.lines
                                         if line.startswith("takeover "))[len("takeover "):])
        standby_serving_s = survivor.line_time("apiserver ready ") - t_kill
        tls_used, tls_tool = all(e.startswith("https://") for e in plane.endpoints), \
            plane.tls_tool
        killed_exit = killed.proc.returncode
        plane.close()
        diagnostics = plane.diagnostics()
        served = json.loads(next(line for _, line in survivor.lines
                                 if line.startswith("served "))[len("served "):])
        plane = None
        still_refused = port_refuses(killed_port)

        # The WAL diff: a fresh store over a copy of the state directory.
        copy = os.path.join(root, "readback")
        shutil.copytree(os.path.join(state, "store"), copy)
        fresh = FakeApiServer(persist_dir=copy)
        durable = fresh.get("TpuJob", "lm-ha")
        durable_pods = fresh.list("Pod", "default", label_selector={LABEL_JOB: "lm-ha"})
        fresh.close()
    except BaseException:
        if plane is not None:
            print(plane.diagnostics(), file=sys.stderr, flush=True)
        raise
    finally:
        if plane is not None:
            plane.close()

    try:
        step_recs = {r["step"]: r for r in records if r["event"] == "step"}
        acked = {r["step"]: r for r in records if r["event"] == "acked"}
        done = next((r for r in records if r["event"] == "done"), {})
        losses = {s: r["loss"] for s, r in step_recs.items()}
        status_curve = {p["step"]: p["loss"] for p in job.status.get("metrics", [])}
        durable_curve = {p["step"]: p["loss"] for p in durable.status.get("metrics", [])}
        vs_a = {}
        for step in range(1, steps + 1):
            a, b = path_a["losses"].get(step), losses.get(step)
            if a is None:
                vs_a[step] = {"path_a": None, "ha_job": b, "holds": "no path A step"}
                continue
            diff = abs(a - b) if b is not None else float("nan")
            vs_a[step] = {"path_a": a, "ha_job": b, "abs_diff": diff,
                          "holds": "bitwise" if diff == 0.0 else "within path A's limit"
                          if diff <= path_a["loss_limit"] else "no"}
        obs = job.status.get("observation") or {}
        launches = {k[len("launches_"):]: int(v) for k, v in obs.items()
                    if k.startswith("launches_")}
        want_launches = {name: LM["n_layers"] * steps
                         for name in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
        after_kill = lambda times: min((t for t in times if t > t_kill), default=None)  # noqa: E731
        first_worker = after_kill([r["time"] for r in acked.values()])
        first_probe = after_kill(probe["acked"])
        checks = {
            "succeeded": job.status.get("phase") == "Succeeded",
            "restarts_0": job.status.get("restarts", 0) == 0,
            "one_worker_process": len({r["pid"] for r in records}) == 1,
            "every_step_acked": sorted(acked) == list(range(1, steps + 1)),
            "acked_steps_in_status": all(status_curve.get(s) == losses.get(s) for s in acked),
            "acked_steps_durable": all(durable_curve.get(s) == losses.get(s) for s in acked),
            "durable_final_status": durable.status.get("phase") == "Succeeded"
            and durable.status.get("observation") == obs,
            "one_pod": len(pods) == 1 and len(durable_pods) == 1,
            "losses_vs_path_a": all(v["holds"] != "no" for v in vs_a.values()),
            "worker_launches": launches == want_launches,
            "writes_after_kill": None not in (first_worker, first_probe)
            and "renewed" in lease,
            "worker_failed_over": done.get("failovers", 0) >= 1,
            "killed_by_sigkill": killed_exit == -signal.SIGKILL,
            "deposed_never_serves": refused_after_kill and still_refused,
            "standby_took_over": survivor is not None and survivor is not killed,
            "tls": tls_used,
            "compiled_wal": first_takeover.get("wal_backend") == "native"
            and takeover.get("wal_backend") == "native",
            "wal_new_inode_at_takeover": None not in (takeover.get("wal_inode_found"),
                                                      takeover.get("wal_inode"))
            and takeover["wal_inode_found"] != takeover["wal_inode"],
        }
        out = {
            "phase": "ha_job", "card": card, "job": "lm-ha", "worker_command": "python -m "
            "kubeflow_tpu_torch.launcher --module kubeflow_tpu_torch.testing.workers.lm_job:main",
            "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
            "seq": TRAIN["seq"], "steps": steps, "kill_after_step": HA_JOB["kill_after"],
            "config": HA_JOB, "tls": tls_used, "tls_tool": tls_tool,
            "facades": [f.name for f in (killed, survivor)], "killed": killed.name,
            "phase_final": job.status.get("phase"), "restarts": job.status.get("restarts", 0),
            "facades_ready_s": facades_ready_s,
            "acked_before_kill": acked_before_kill,
            "kill_to_standby_serving_s": standby_serving_s,
            "kill_to_first_acked_write_s": {
                "worker": first_worker - t_kill if first_worker else None,
                "binary_lease_renewal": lease.get("renewed", t_kill) - t_kill,
                "binary_renewal_seen_by_plane": lease.get("seen", t_kill) - t_kill,
                "runner_client_probe": first_probe - t_kill if first_probe else None},
            "takeover": takeover,
            "wal_inode": {"backend": takeover.get("wal_backend"),
                          "before_takeover": takeover.get("wal_inode_found"),
                          "after_takeover": takeover.get("wal_inode")},
            "step_ms": {s: r["step_ms"] for s, r in sorted(step_recs.items())},
            "acked_at_s_after_kill": {s: r["time"] - t_kill for s, r in sorted(acked.items())},
            "worker_median_step_ms": obs.get("step_ms"), "path_a_step_ms": path_a["step_ms"],
            "clients": {"worker": {k: done.get(k) for k in ("failovers", "handshakes")},
                        "binary": binary_client, "runner": runner_client},
            "survivor_served": served,
            "losses_vs_path_a": vs_a, "loss_limit": path_a["loss_limit"],
            "launches": launches, "want_launches": want_launches,
            "job_wall_s": wall_s, "checks": checks,
            "seconds": time.perf_counter() - t_phase,
        }
        emit(out)
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            print(diagnostics, file=sys.stderr, flush=True)
            raise AssertionError(f"ha_job phase checks failed: {failed}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tenant_phase(torch, card: str, path_a: dict) -> dict:
    """Path G, tenants: a `JobPlane` whose store is durable (``persist_dir``,
    `testing/persist.py`), the binary running
    ``--controllers profile,notebook,tensorboard,tpujob`` and the pod runner
    with the workload materializer (`runtime/workloads.py`) beside it.

    1. Provision: Profile team-c (owner TENANT["owner"], its
       resourceQuotaSpec TENANT["hard"]) to condition Ready: the Namespace
       with the owner annotation and an ownerReference to the Profile,
       both ServiceAccounts, the RoleBinding, the AuthorizationPolicy, the
       ResourceQuota and the finalizer.
    2. No takeover: a Namespace team-x with no owner, then Profile
       team-x: one NamespaceConflict Warning, condition Failed, the
       namespace unchanged.
    3. Train: PVC lm-ckpt and TpuJob lm-tenant in team-c (1 worker, 1
       GPU), TRAIN's LM through fit() for TENANT["steps"] with a trace of
       two steps (``KFTPU_TRACE_DIR``); status.used of the quota reads
       one GPU while the pod runs; 16 launches a step of flash_fwd,
       flash_delta and flash_bwd_fused in the worker; every step's loss
       finite and against path A's (`path_a`: bitwise, or within its loss
       limit).
    4. While it trains: Notebook nb (no accelerator) to readyReplicas 1
       and containerState Running through the materializer, then the stop
       annotation to 0 pods and Terminated; Tensorboard tb on
       ``lm-ckpt/traces``: its Deployment mounting claim lm-ckpt at
       subPath traces, its Service and VirtualService, readyReplicas 1;
       the worker's trace on disk (its ``trace`` line and the files).
    5. Drain: once step TENANT["drain_after"] is acked, Profile team-c is
       deleted. Seconds from the delete to the Profile gone (the
       finalizer cleared), the Namespace gone, the worker's SIGTERM and
       its exit, and memory.used back within TENANT["memory_slack_mib"]
       of its reading before the pod started. From the Namespace gone
       until the worker has exited and at least TENANT["quiet_s"] later,
       no pod in team-c and no process started. Then: nothing of any
       kind left in team-c; a fresh store over a copy of the state directory
       with no Profile team-c, no Namespace team-c and nothing in team-c;
       team-x's Profile and Namespace untouched; the binary exits 0 on
       SIGTERM; the compiled tier (`tier_phase`: the binary's work
       queues, lm-tenant placed on the one-GPU Node "h100-0" by the
       compiled scheduler).

    Returns the worker's launch counts."""
    from kubeflow_tpu_torch.api import make_tpujob
    from kubeflow_tpu_torch.api.objects import new_resource
    from kubeflow_tpu_torch.controllers.notebook import STOP_ANNOTATION
    from kubeflow_tpu_torch.controllers.profile import EDITOR_SA, FINALIZER, VIEWER_SA
    from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
    from kubeflow_tpu_torch.testing.job_plane import JobPlane

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kftpu_tenant_")
    state = os.path.join(root, "state")
    claim = os.path.join(root, "lm-ckpt")  # what claim lm-ckpt holds
    trace_dir = os.path.join(claim, "traces")
    steps = TENANT["steps"]
    env = {
        "KFTPU_CKPT_DIR": os.path.join(claim, "ckpt"),
        "KFTPU_TRACE_DIR": trace_dir,
        "KFTPU_TOTAL_STEPS": str(steps),
        "KFTPU_SAVE_EVERY": str(TENANT["save_every"]),
        "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                                     "dtype": "bfloat16", "lr": TRAIN["lr"]}),
    }
    ns = "team-c"
    worker = "lm-tenant-worker-0"
    plane = None
    try:
        plane = JobPlane(controllers=("profile", "notebook", "tensorboard", "tpujob"),
                         capture_dir=os.path.join(root, "logs"), persist_dir=state,
                         ready_timeout=TENANT["manager_ready_s"])
        api = plane.api
        plane.add_node("h100-0", chips=1)  # the gang places through the scheduler
        manager_ready_s = plane.manager_ready_s

        def condition(name: str):
            return api.get("Profile", name, "default").status.get("condition")

        def gone(kind: str, name: str, namespace: str) -> bool:
            try:
                api.get(kind, name, namespace)
            except NotFound:
                return True
            return False

        # 1. Provision.
        api.create(new_resource("Profile", ns, "default", spec={
            "owner": {"kind": "User", "name": TENANT["owner"]},
            "resourceQuotaSpec": {"hard": dict(TENANT["hard"])}}))
        provision_s = plane.run_until(lambda: condition(ns) == "Ready",
                                      TENANT["ready_timeout_s"], "Profile team-c Ready")
        profile = api.get("Profile", ns, "default")
        namespace = api.get("Namespace", ns, "")
        quota = api.get("ResourceQuota", "kf-resource-quota", ns)
        children = {
            "namespace_owner_annotation": namespace.metadata.annotations.get("owner")
            == TENANT["owner"],
            "namespace_owned_by_profile": [
                (r.get("kind"), r.get("uid")) for r in namespace.metadata.owner_references]
            == [("Profile", profile.metadata.uid)],
            "service_accounts": not gone("ServiceAccount", EDITOR_SA, ns)
            and not gone("ServiceAccount", VIEWER_SA, ns),
            "role_binding": not gone("RoleBinding", "namespaceAdmin", ns),
            "authorization_policy": not gone("AuthorizationPolicy", "ns-owner", ns),
            "resource_quota": quota.spec.get("hard") == TENANT["hard"],
            "finalizer": FINALIZER in profile.metadata.finalizers,
        }

        # 2. No takeover.
        api.create(new_resource("Namespace", "team-x", ""))
        team_x_before = api.get("Namespace", "team-x", "")
        api.create(new_resource("Profile", "team-x", "default", spec={
            "owner": {"kind": "User", "name": "x@example.com"}}))
        conflict_s = plane.run_until(lambda: condition("team-x") == "Failed",
                                     TENANT["ready_timeout_s"], "Profile team-x Failed")
        takeover_refused = gone("ServiceAccount", EDITOR_SA, "team-x") and gone(
            "ResourceQuota", "kf-resource-quota", "team-x")

        def conflicts() -> int:
            return sum(1 for e in api.list("Event", "default")
                       if e.spec["reason"] == "NamespaceConflict"
                       and e.spec["involvedObject"]["name"] == "team-x")

        # 3 and 4. Train, with a Notebook and a Tensorboard beside it.
        api.create(new_resource("PersistentVolumeClaim", "lm-ckpt", ns, spec={
            "resources": {"requests": {"storage": "10Gi"}}}))
        used_before = card_used_mib(torch)
        seen = {"gpu_used": set()}

        def tick():
            now = time.time()
            for pod in api.list("Pod", ns, label_selector={LABEL_JOB: "lm-tenant"}):
                if pod.status.get("phase") == "Running":
                    seen.setdefault("running", now)
                    used = api.get("ResourceQuota", "kf-resource-quota", ns).status.get(
                        "used", {}).get("nvidia.com/gpu")
                    seen["gpu_used"].add(used)

        def acked() -> dict:
            return {p["step"]: p["loss"] for p in
                    api.get("TpuJob", "lm-tenant", ns).status.get("metrics", [])}

        t_create = time.time()
        api.create(make_tpujob(
            "lm-tenant", ns, replicas=1, tpu_chips_per_worker=1, max_restarts=0,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items())))
        api.create(new_resource("Notebook", "nb", ns, spec={"image": "kubeflow-tpu/nb:1"}))
        api.create(new_resource("Tensorboard", "tb", ns, spec={"logspath": "lm-ckpt/traces"}))

        def ready(kind: str, name: str, **want) -> bool:
            status = api.get(kind, name, ns).status
            return all(status.get(k) == v for k, v in want.items())

        notebook_ready_s = plane.run_until(
            lambda: ready("Notebook", "nb", readyReplicas=1, containerState="Running"),
            TENANT["ready_timeout_s"], "Notebook nb ready", tick=tick)
        tensorboard_ready_s = plane.run_until(
            lambda: ready("Tensorboard", "tb", readyReplicas=1),
            TENANT["ready_timeout_s"], "Tensorboard tb ready", tick=tick) + notebook_ready_s
        nb_pods_ready = [p.metadata.name for p in api.list("Pod", ns,
                                                           label_selector={"notebook": "nb"})]
        tb_pods = [p.metadata.name for p in api.list("Pod", ns,
                                                     label_selector={"tensorboard": "tb"})]
        nb = api.get("Notebook", "nb", ns).thaw()
        nb.metadata.annotations[STOP_ANNOTATION] = "chip_smoke"
        api.update(nb)
        notebook_stop_s = plane.run_until(
            lambda: ready("Notebook", "nb", readyReplicas=0, containerState="Terminated")
            and not api.list("Pod", ns, label_selector={"notebook": "nb"}),
            TENANT["ready_timeout_s"], "Notebook nb stopped", tick=tick)
        deployment = api.get("Deployment", "tb", ns)
        tb_spec = deployment.spec["template"]["spec"]
        vs = api.get("VirtualService", "tensorboard-team-c-tb", ns)
        tensorboard = {
            "claim": [v.get("persistentVolumeClaim", {}).get("claimName")
                      for v in tb_spec.get("volumes", [])] == ["lm-ckpt"],
            "sub_path": [m.get("subPath") for m in tb_spec["containers"][0]
                         .get("volumeMounts", [])] == ["traces"],
            "service": not gone("Service", "tb", ns),
            "route": vs.spec["http"][0]["match"][0]["uri"]["prefix"]
            == "/tensorboard/team-c/tb/",
        }
        plane.run_until(lambda: TENANT["drain_after"] in acked(), TENANT["timeout_s"],
                        f"lm-tenant's step {TENANT['drain_after']} acked", tick=tick)
        # From the CRs' creates (beside the TpuJob's) to ready, and from
        # the stop annotation to stopped.
        workloads_s = {"notebook_ready_s": notebook_ready_s,
                       "tensorboard_ready_s": tensorboard_ready_s,
                       "notebook_stop_s": notebook_stop_s}

        # 5. Drain mid-run.
        acked_before_drain = sorted(acked())
        used_at_drain = float(nvidia_smi("--query-gpu=memory.used")[0])
        logs_before = set(os.listdir(os.path.join(root, "logs")))
        drain = {}
        memory = {"t": 0.0, "last": used_at_drain}

        def drain_tick():
            now = time.time()
            if "profile_gone" not in drain and gone("Profile", ns, "default"):
                drain["profile_gone"] = now
            if "namespace_gone" not in drain and gone("Namespace", ns, ""):
                drain["namespace_gone"] = now
            for (pod_ns, name, _), ev in plane.runner.evictions.items():
                if (pod_ns, name) == (ns, worker):
                    drain["sigterm"] = ev["sigterm"]
                    if ev["exit"] is not None:
                        drain["exit"], drain["returncode"] = ev["exit"], ev["returncode"]
            if "memory_back" not in drain and now - memory["t"] >= 0.25:
                memory["t"] = now
                memory["last"] = float(nvidia_smi("--query-gpu=memory.used")[0])
                if "exit" in drain and abs(memory["last"] - used_before) \
                        <= TENANT["memory_slack_mib"]:
                    drain["memory_back"] = now

        # The quiet window opens once the Namespace is gone and runs
        # while the worker saves and exits, for at least `quiet_s`.
        quiet = {"pods": set(), "running": 0}

        def drained_and_quiet() -> bool:
            drain_tick()
            if "namespace_gone" in drain:
                quiet["pods"] |= {p.metadata.name for p in api.list("Pod", ns)}
                quiet["running"] = max(quiet["running"], plane.runner.running_count())
            return {"profile_gone", "namespace_gone", "exit", "memory_back"} <= set(drain) \
                and time.time() - drain["namespace_gone"] >= TENANT["quiet_s"]

        t_delete = time.time()
        api.delete("Profile", ns, "default")
        plane.run_until(drained_and_quiet, TENANT["drain_timeout_s"],
                        "team-c drained, its worker gone, the card released and the "
                        "quiet window over")
        quiet_s = time.time() - drain["namespace_gone"]
        new_logs = sorted(set(os.listdir(os.path.join(root, "logs"))) - logs_before)
        left = {kind: [o.metadata.name for o in api.list(kind, ns)] for kind in api.kinds()}
        left = {kind: names for kind, names in left.items() if names}
        listed = {kind: len(api.list(kind, ns)) for kind in (
            "TpuJob", "Pod", "Service", "StatefulSet", "Deployment", "VirtualService",
            "Notebook", "Tensorboard", "PersistentVolumeClaim", "ResourceQuota",
            "ServiceAccount", "RoleBinding", "AuthorizationPolicy")}
        team_x = api.get("Namespace", "team-x", "")
        team_x_kept = (
            condition("team-x") == "Failed"
            and team_x.metadata.uid == team_x_before.metadata.uid
            and dict(team_x.metadata.annotations) == dict(team_x_before.metadata.annotations)
            and dict(team_x.metadata.labels) == dict(team_x_before.metadata.labels)
            and not team_x.metadata.owner_references)
        conflict_events = conflicts()
        records = log_records(plane.pod_logs().get(f"{worker}.log", ""))
        binary_exit = plane.stop_manager()
        tier_phase("tenant", card, plane.plane_reports())
        plane.close()
        diagnostics = plane.diagnostics()
        plane = None

        # A fresh store over a copy of the state directory.
        copy = os.path.join(root, "readback")
        shutil.copytree(state, copy)
        fresh = FakeApiServer(persist_dir=copy)
        durable = {
            "profile_gone": not any(p.metadata.name == ns for p in fresh.list("Profile")),
            "namespace_gone": not any(n.metadata.name == ns for n in fresh.list("Namespace")),
            "nothing_in_namespace": not any(fresh.list(kind, ns) for kind in fresh.kinds()),
            "team_x_kept": any(p.metadata.name == "team-x" for p in fresh.list("Profile"))
            and any(n.metadata.name == "team-x" for n in fresh.list("Namespace")),
        }
        fresh.close()
    except BaseException:
        if plane is not None:
            print(plane.diagnostics(), file=sys.stderr, flush=True)
        raise
    finally:
        if plane is not None:
            plane.close()

    try:
        step_recs = {r["step"]: r for r in records if r["event"] == "step"}
        start = next((r for r in records if r["event"] == "start"), {})
        trace = next((r for r in records if r["event"] == "trace"), {})
        gone_rec = next((r for r in records if r["event"] == "job_gone"), None)
        preempted = next((r for r in records if r["event"] == "preempted"), {})
        trace_files = sorted(f for f in (os.listdir(trace_dir) if os.path.isdir(trace_dir)
                                         else []) if f.endswith(".pt.trace.json"))
        launches = {k[len("launches_"):]: int(v) for k, v in preempted.items()
                    if k.startswith("launches_")}
        done = int(preempted.get("steps_done", 0))
        want_launches = {name: LM["n_layers"] * done
                         for name in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
        losses = {s: r["loss"] for s, r in step_recs.items()}
        vs_a = {}
        for step, b in sorted(losses.items()):
            a = path_a["losses"].get(step)
            if a is None:
                vs_a[step] = {"path_a": None, "tenant": b, "holds": "no path A step"}
                continue
            diff = abs(a - b)
            vs_a[step] = {"path_a": a, "tenant": b, "abs_diff": diff,
                          "holds": "bitwise" if diff == 0.0 else "within path A's limit"
                          if diff <= path_a["loss_limit"] else "no"}
        first = min(step_recs.values(), key=lambda r: r["step"], default=None)
        checks = {
            **{f"provisioned_{k}": v for k, v in children.items()},
            "no_takeover": takeover_refused,
            "one_namespace_conflict": conflict_events == 1,
            "team_x_untouched": team_x_kept,
            # status.used is published asynchronously: a reading taken
            # before the first publish shows no usage yet.
            "quota_used_one_gpu": seen["gpu_used"] - {None, 0} == {1},
            "notebook_ready_pod": len(nb_pods_ready) == 1,
            "tensorboard_ready_pod": len(tb_pods) == 1,
            **{f"tensorboard_{k}": v for k, v in tensorboard.items()},
            "trace_on_disk": trace.get("written") is True and bool(trace_files),
            "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses.values()),
            "losses_vs_path_a": all(v["holds"] != "no" for v in vs_a.values()),
            "drained_mid_run": acked_before_drain[-1] < steps and done < steps,
            "worker_launches": bool(launches) and launches == want_launches,
            "worker_exited": drain.get("returncode") is not None,
            "memory_released": "memory_back" in drain,
            "nothing_left_in_namespace": not left and not any(listed.values()),
            "no_pod_reappeared": not quiet["pods"] and quiet["running"] == 0
            and not new_logs,
            "durable_drain": all(durable.values()),
            "binary_exit_0": binary_exit == 0,
        }
        out = {
            "phase": "tenant", "card": card, "profile": ns, "job": "lm-tenant",
            "controllers": "profile,notebook,tensorboard,tpujob",
            "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
            "seq": TRAIN["seq"], "config": TENANT,
            "provision_s": provision_s, "conflict_s": conflict_s,
            "manager_ready_s": manager_ready_s,
            "cr_to_running_s": seen["running"] - t_create if "running" in seen else None,
            "spawn_to_first_step_s": (first["time"] - seen["running"]
                                      if first and "running" in seen else None),
            "spawn_to_worker_start_s": (start["time"] - seen["running"]
                                        if start and "running" in seen else None),
            "workloads": workloads_s,
            "step_ms": {s: r["step_ms"] for s, r in sorted(step_recs.items())},
            "path_a_step_ms": path_a["step_ms"],
            "acked_before_drain": acked_before_drain,
            "delete_to_s": {
                "profile_gone": drain.get("profile_gone", t_delete) - t_delete,
                "namespace_gone": drain.get("namespace_gone", t_delete) - t_delete,
                "worker_sigterm": drain.get("sigterm", t_delete) - t_delete,
                "worker_job_gone_line": gone_rec["time"] - t_delete if gone_rec else None,
                "worker_fit_returned": (preempted["fit_returned"] - t_delete
                                        if "fit_returned" in preempted else None),
                "worker_exit": drain.get("exit", t_delete) - t_delete,
                "memory_back": drain.get("memory_back", t_delete) - t_delete,
            },
            "worker_returncode": drain.get("returncode"),
            "worker_steps_done": done, "preempted_at_step": preempted.get("step"),
            "card_memory_used_mib": {"before_pod": used_before, "at_drain": used_at_drain,
                                     "last_read": memory["last"]},
            "quota_used_gpu_seen": sorted(seen["gpu_used"], key=str),
            "trace": {"line": trace, "files": trace_files},
            "quiet_window": {"seconds": quiet_s, "pods": sorted(quiet["pods"]),
                             "max_running": quiet["running"], "new_logs": new_logs},
            "left_in_namespace": left, "listed": listed, "durable": durable,
            "namespace_conflict_events": conflict_events, "binary_exit": binary_exit,
            "losses_vs_path_a": vs_a, "loss_limit": path_a["loss_limit"],
            "launches": launches, "want_launches": want_launches, "checks": checks,
            "seconds": time.perf_counter() - t_phase,
        }
        emit(out)
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            print(diagnostics, file=sys.stderr, flush=True)
            raise AssertionError(f"tenant phase checks failed: {failed}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def platform_phase(torch, card: str, path_a: dict) -> dict:
    """Path H, the platform in a box: ``python -m kubeflow_tpu_torch.apps``
    as its own process (the store on a state directory, every controller,
    the PodDefault, quota and TpuJob admission, the pod runner and the
    materializer, the dashboard, kfam, the Jupyter and Tensorboards apps,
    the facade over https with bearer tokens and RBAC, one seeded Node
    advertising the card), driven only through its entry points by
    `testing/platform.run_flow`: HTTP to the apps, the https facade and
    ``python -m kubeflow_tpu_torch.cli`` as subprocesses.

    1. Boot (a team-p service-account token written first as a static
       token-file entry); the admin token, token file and CA printed.
    2. The dashboard's workgroup create for team-p to the Profile's
       Ready; the owner's RoleBinding; kfam's edit binding for the
       service account. The mesh gate: an outsider given an edit
       RoleBinding in team-p (no kfam, so no AuthorizationPolicy rule)
       gets 403 from the Jupyter app's notebook list, the owner 200.
    3. `kftpu apply` of PodDefault facade-env (every pod of team-p: a
       TpuJob's pods carry no label of their CR) with the facade's URL,
       its CA and the service account's token.
    4. The Jupyter app's notebook POST with facade-env among its
       configurations, to ready, the env on its pod; a PATCH stops it.
    5. `kftpu apply` of TpuJob lm-platform: the LM at TRAIN's shape
       through the launcher and fit() on the card, one GPU,
       PLATFORM["steps"] steps, its worker reporting each step through
       the facade with the service account's token; `kftpu get tpujobs
       -n team-p -w` to Succeeded; describe, logs --job, top.
    6. The dashboard's workloads (the job with its one GPU) and
       activities.
    7. `kftpu traces`: the apply's request span, the worker's status
       writes, the operator's reconciles of team-p/lm-platform.
    8. SIGTERM (exit 0), a boot on the same state directory: the same
       admin token, lm-platform Succeeded, Notebook nb.
    9. The dashboard's nuke-self: the Profile and Namespace gone, the
       service account's token refused with 401 and gone from the token
       file, the admin's accepted; SIGTERM, exit 0.
    10. The compiled tier (`tier_phase`) over the two boots' ``plane``
       lines: compiled work queues, lm-platform placed on the seeded Node
       by the compiled scheduler.

    Each step's loss finite and bitwise or within path A's limit
    (`path_a`); 16 launches a step of flash_fwd, flash_delta and
    flash_bwd_fused in the worker. Returns the worker's launches."""
    from kubeflow_tpu_torch.testing.platform import run_flow

    t_phase = time.perf_counter()
    release(torch)
    root = tempfile.mkdtemp(prefix="kftpu_platform_")
    steps, ns, job = PLATFORM["steps"], PLATFORM["namespace"], PLATFORM["job"]
    try:
        rec = run_flow(
            os.path.join(root, "state"), user=PLATFORM["user"], namespace=ns, job=job,
            timeout=PLATFORM["timeout_s"],
            job_env={"KFTPU_CKPT_DIR": os.path.join(root, "ckpt"),
                     "KFTPU_TOTAL_STEPS": str(steps), "KFTPU_SAVE_EVERY": str(steps),
                     "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"],
                                                  "seq": TRAIN["seq"], "dtype": "bfloat16",
                                                  "lr": TRAIN["lr"]})})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tier_phase("platform", card, {f"apps-boot{i + 1}": plane
                                  for i, plane in enumerate(rec["planes"])})
    records = log_records(rec["logs"][1])
    step_recs = {r["step"]: r for r in records if r["event"] == "step"}
    start = next((r for r in records if r["event"] == "start"), {})
    done = next((r for r in records if r["event"] == "done"), {})
    launches = {k[len("launches_"):]: int(v) for k, v in done.items()
                if k.startswith("launches_")}
    want_launches = {name: LM["n_layers"] * steps
                     for name in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
    losses = {s: r["loss"] for s, r in step_recs.items()}
    vs_a = {}
    for step, b in sorted(losses.items()):
        a = path_a["losses"].get(step)
        diff = None if a is None else abs(a - b)
        vs_a[step] = {"path_a": a, "platform": b, "abs_diff": diff,
                      "holds": "no path A step" if a is None else "bitwise" if diff == 0.0
                      else "within path A's limit" if diff <= path_a["loss_limit"] else "no"}
    rc, spans, traces_err = rec["traces"]
    by_kind: dict = {}
    for span in spans:
        by_kind[span["name"]] = by_kind.get(span["name"], 0) + 1
    http = [sp["attributes"] for sp in spans if sp["name"] == "http"]
    apply_spans = [a for a in http if a.get("app") == "apiserver" and a.get("method") == "POST"
                   and a.get("path") == "/apis/TpuJob" and a.get("status") == "201"]
    status_writes = [a for a in http if a.get("method") == "PUT"
                     and a.get("path") == f"/apis/TpuJob/{ns}/{job}/status"]
    reconciles = [sp for sp in spans if sp["name"] == "reconcile"
                  and sp["attributes"] == {"controller": "tpujob-controller", "key": f"{ns}/{job}"}]
    workloads = rec["workloads"][1] if rec["workloads"][0] == 200 else []
    first = min(step_recs.values(), key=lambda r: r["step"], default=None)
    checks = {
        "credentials_printed": rec["credentials_printed"],
        "workgroup_created": rec["workgroup_create"][0] == 200,
        "owner_binding": rec["owner_binding"] == [PLATFORM["user"]],
        "kfam_binding": rec["kfam_binding"][0] == 200 and any(
            b["user"]["name"] == rec["service_account"]
            for b in rec["kfam_bindings"][1].get("bindings", [])),
        "mesh_outsider_403": rec["mesh_outsider"][0] == 403
        and "mesh policy denies" in str(rec["mesh_outsider"][1]),
        "mesh_owner_200": rec["mesh_owner"][0] == 200,
        "poddefault_applied": rec["poddefault_apply"][0] == 0,
        "notebook_env_injected": rec["notebook_pod_env"] == [rec["facade_env"]],
        "notebook_stopped": rec["notebook_stop"][0] == 200,
        "tpujob_applied": rec["tpujob_apply"][0] == 0,
        "watch_saw_succeeded_exit_0": rec["watch_rc"] == 0,
        "job_succeeded": rec["job_status"].get("phase") == "Succeeded",
        "worker_env_injected": rec["worker_pod_env"] == [rec["facade_env"]],
        "acked_every_step": [pt["step"] for pt in rec["job_status"].get("metrics", [])]
        == list(range(1, steps + 1)),
        "losses_finite": sorted(losses) == list(range(1, steps + 1))
        and all(math.isfinite(v) for v in losses.values()),
        "losses_vs_path_a": all(v["holds"] != "no" for v in vs_a.values()),
        "worker_launches": launches == want_launches,
        "describe_logs_top": rec["describe"][0] == 0 and "Succeeded" in rec["describe"][1]
        and rec["logs"][0] == 0 and rec["top"][0] == 0,
        "token_file_outside_log_root": all(not rec["token_file"].startswith(r)
                                           for r in rec["pod_log_root"]),
        "workloads_one_gpu": [(r["name"], r["phase"], r["chips"]) for r in workloads]
        == [(job, "Succeeded", 1)],
        "activities": rec["activities"][0] == 200 and bool(rec["activities"][1]),
        "traces_drained": rc == 0 and bool(apply_spans) and len(status_writes) >= steps + 1
        and bool(reconciles),
        "stop_exit_0": rec["stop_rc"] == 0,
        "restart_same_admin_token": rec["restart_same_admin_token"],
        "restart_job_succeeded": rec["restart_job_phase"] == "Succeeded",
        "restart_notebook_kept": rec["restart_notebook"] == "nb",
        "nuke_self": rec["nuke_self"][0] == 200,
        "service_account_401": "no valid bearer token" in str(rec["sa_after_nuke"]),
        "service_account_token_gone": not rec["sa_token_in_file"],
        "admin_token_works": ns not in rec["admin_after_nuke"],
        "final_exit_0": rec["final_stop_rc"] == 0,
    }
    out = {
        "phase": "platform", "card": card, "namespace": ns, "job": job, "steps": steps,
        "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "seconds_by_step": rec["seconds"],
        "spawn_to_first_step_s": (first["time"] - rec["t_running"]
                                  if first and rec["t_running"] else None),
        "spawn_to_worker_start_s": (start["time"] - rec["t_running"]
                                    if start and rec["t_running"] else None),
        "step_ms": {s: r["step_ms"] for s, r in sorted(step_recs.items())},
        "path_a_step_ms": path_a["step_ms"], "losses_vs_path_a": vs_a,
        "loss_limit": path_a["loss_limit"], "spans_by_kind": by_kind,
        "spans": {"apply": len(apply_spans), "worker_status_writes": len(status_writes),
                  "tpujob_reconciles": len(reconciles), "dropped_note": traces_err.strip()},
        "watch_rows": rec["watch_rows"], "workloads": workloads,
        "mesh_outsider": rec["mesh_outsider"],
        "activities": len(rec["activities"][1] or []),
        "sa_after_nuke": rec["sa_after_nuke"], "launches": launches,
        "want_launches": want_launches, "checks": checks,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        print(rec["output"], file=sys.stderr, flush=True)
        raise AssertionError(f"platform phase checks failed: {failed}")
    return launches


def chaos_job_phase(torch, card: str, path_a: dict) -> dict:
    """Path I, the control plane's wire under faults
    (`testing/chaos_job.run_chaos_job`): the facade as its own process
    over a state directory, on plain http (opted into: the proxy must
    read the HTTP), behind a `ChaosProxy` running
    FaultSchedule(CHAOS_JOB["seed"], faults_per_class=2) over the seven
    wire fault classes; the controller-manager binary (tpujob and
    notebook controllers; its watch degrades after one failed stream for
    1 s), the pod runner and the LM worker's status client reach the
    store only through the proxy; the stream lives 2 s, bookmarks every
    0.2 s. TRAIN's LM trains as TpuJob "lm-chaos" on one GPU for
    CHAOS_JOB["steps"] steps (one save); a Notebook is applied with
    ``kftpu apply`` as a v1alpha1 manifest and read back at v1, v1beta1
    and v1alpha1.

    Gates: `chaos_job.checks` (Succeeded, restarts 0, one pod, every step
    acked, the Notebook stored at v1, read at every version, its
    v1alpha1 round trip equal to the manifest, one StatefulSet, Service
    and VirtualService, every fault class fired and the schedule
    exhausted, no object live twice and no Event twice, the binary
    long-polled while degraded and streamed again, and exited 0 on
    SIGTERM); one worker process; each acked step in status.metrics with
    the worker's loss; the losses finite and bitwise or within path A's
    limit (`path_a`); 16 launches a step of flash_fwd, flash_delta and
    flash_bwd_fused in the worker; the compiled tier (`tier_phase`: the
    binary's work queues, the job placed on a one-GPU Node by the compiled
    scheduler). Returns the worker's launches."""
    from kubeflow_tpu_torch.testing import chaos_job

    t_phase = time.perf_counter()
    release(torch)
    root = tempfile.mkdtemp(prefix="kftpu_chaos_")
    steps = CHAOS_JOB["steps"]
    try:
        rec = chaos_job.run_chaos_job(
            root, steps=steps, seed=CHAOS_JOB["seed"],
            faults_per_class=CHAOS_JOB["faults_per_class"], timeout=CHAOS_JOB["timeout_s"],
            ready_timeout=CHAOS_JOB["manager_ready_s"], nodes=1,
            job_env={"KFTPU_CKPT_DIR": os.path.join(root, "ckpt"),
                     "KFTPU_TOTAL_STEPS": str(steps), "KFTPU_SAVE_EVERY": str(steps),
                     "KFTPU_LM_SIZE": json.dumps({**LM, "batch": TRAIN["batch"],
                                                  "seq": TRAIN["seq"], "dtype": "bfloat16",
                                                  "lr": TRAIN["lr"]})})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tier_phase("chaos_job", card, {"manager-0": rec["plane"]})
    records = log_records(rec["logs"])
    step_recs = {r["step"]: r for r in records if r["event"] == "step"}
    acked = {r["step"] for r in records if r["event"] == "acked"}
    start = next((r for r in records if r["event"] == "start"), {})
    done = next((r for r in records if r["event"] == "done"), {})
    launches = {k[len("launches_"):]: int(v) for k, v in done.items()
                if k.startswith("launches_")}
    want_launches = {name: LM["n_layers"] * steps
                     for name in ("flash_fwd", "flash_delta", "flash_bwd_fused")}
    losses = {s: r["loss"] for s, r in step_recs.items()}
    status_curve = {p["step"]: p["loss"] for p in rec["job_status"].get("metrics", [])}
    vs_a = {}
    for step, b in sorted(losses.items()):
        a = path_a["losses"].get(step)
        diff = None if a is None else abs(a - b)
        vs_a[step] = {"path_a": a, "chaos_job": b, "abs_diff": diff,
                      "holds": "no path A step" if a is None else "bitwise" if diff == 0.0
                      else "within path A's limit" if diff <= path_a["loss_limit"] else "no"}
    first = min(step_recs.values(), key=lambda r: r["step"], default=None)
    checks = {
        **chaos_job.checks(rec, steps),
        "one_worker_process": len({r["pid"] for r in records}) == 1,
        "acked_steps_in_status": sorted(acked) == list(range(1, steps + 1))
        and all(status_curve.get(s) == losses.get(s) for s in acked),
        "losses_finite": sorted(losses) == list(range(1, steps + 1))
        and all(math.isfinite(v) for v in losses.values()),
        "losses_vs_path_a": all(v["holds"] != "no" for v in vs_a.values()),
        "worker_launches": launches == want_launches,
    }
    sec = rec["seconds"]
    out = {
        "phase": "chaos_job", "card": card, "job": "lm-chaos", "steps": steps,
        "transport": "plain http between every client and the facade, opted into "
                     "(KFTPU_PLAINTEXT=1): the proxy reads the HTTP it injects into",
        "model": {**LM, "dtype": "bfloat16", "remat": "none"}, "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "config": CHAOS_JOB,
        "plan": [[f.cls, f.param, f.gap] for f in rec["schedule"].plan],
        "faults_fired": rec["coverage"], "seconds": sec,
        "cr_to_pod_running_s": sec["cr_to_pod_running"],
        "spawn_to_first_step_s": (first["time"] - rec["t_running"]
                                  if first and rec["t_running"] else None),
        "worker_start_to_first_step_s": (first["time"] - start["time"]
                                         if first and start else None),
        "step_ms": {s: r["step_ms"] for s, r in sorted(step_recs.items())},
        "worker_median_step_ms": done.get("step_ms"), "path_a_step_ms": path_a["step_ms"],
        "job_wall_s": sec["job_wall"], "notebook_apply_to_ready_s": sec["notebook_apply_to_ready"],
        "binary_client": rec["binary_client"], "runner_client": rec["runner_client"],
        "worker_client": {k: done.get(k) for k in ("failovers", "handshakes")},
        "binary_degraded_marks_s": rec["binary_degraded_marks"],
        "long_poll_rounds": rec["binary_client"]["watch"]["longpoll_rounds"],
        "degraded_seconds": rec["binary_client"]["watch"]["degraded_seconds"],
        "churn_rounds": rec["churn_rounds"], "events": rec["events"],
        "losses_vs_path_a": vs_a, "loss_limit": path_a["loss_limit"],
        "launches": launches, "want_launches": want_launches, "checks": checks,
        "phase_seconds": time.perf_counter() - t_phase,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        print(rec["diagnostics"], file=sys.stderr, flush=True)
        raise AssertionError(f"chaos_job phase checks failed: {failed}")
    return launches


def gpu_accelerator(card: str) -> str:
    """The GPU table's accelerator (`deploy/kfdef.GPUS_PER_HOST`) that
    nvidia-smi's name names ("NVIDIA H100 80GB HBM3, 700.00 W" -> h100)."""
    from kubeflow_tpu_torch.deploy.kfdef import GPUS_PER_HOST

    name = card.split(",")[0].lower()
    for accelerator in GPUS_PER_HOST:
        if accelerator in name:
            return accelerator
    raise AssertionError(f"no accelerator of the GPU table in {card!r}")


class DeployClient:
    """The deploy service over HTTP, as `DeployProber` calls it: post and
    get, each returning a reply with `status` and `json()`."""

    class Reply:
        def __init__(self, status: int, body: bytes):
            self.status, self.body = status, body

        def json(self):
            return json.loads(self.body)

    def __init__(self, base: str):
        self.base = base

    def _call(self, method: str, path: str, body=None):
        import urllib.error

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return self.Reply(resp.status, resp.read())
        except urllib.error.HTTPError as e:
            return self.Reply(e.code, e.read())

    def post(self, path: str, body=None):
        return self._call("POST", path, body)

    def get(self, path: str):
        return self._call("GET", path)


def child_processes(pid: int) -> dict:
    """The live (not zombie) children of `pid`: {pid: command line}."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != pid or fields[0] == "Z":
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                out[int(entry)] = f.read().replace(b"\0", b" ").decode()
        except (OSError, IndexError, ValueError):
            continue
    return out


def deploy_worker_alive(pid: int) -> bool:
    """Whether `pid` is a live deploy worker process."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"kubeflow_tpu_torch.deploy.worker" in f.read()
    except OSError:
        return False


def worker_store(pid: int):
    """The deploy server's store as its worker `pid` reaches it: the
    facade's URL from the worker's command line, the token and the CA
    from its environment."""
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient

    with open(f"/proc/{pid}/cmdline", "rb") as f:
        argv = f.read().decode().split("\0")
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(item.split("=", 1) for item in f.read().decode().split("\0") if "=" in item)
    return HttpApiClient(argv[argv.index("--apiserver") + 1], ca=env["KFTPU_CA"],
                         token=env["KFTPU_TOKEN"])


def loads_torch(pid: int) -> bool:
    """Whether the live process `pid` has torch's shared library mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def deploy_phase(torch, card: str) -> dict:
    """Main path 20, deploying the platform (`deploy/`): no work on the
    card, the port's deploy entry points on the card's machine.
    ``python -m kubeflow_tpu_torch.deploy serve --worker-mode process``
    as its own process (every worker holds DEPLOY["apply_delay_s"]
    between its PLATFORM and K8S phases); a platform created over its
    HTTP API with the default bundles and one GPU pool sized from the
    card (nvidia-smi's name mapped through the GPU table, one GPU on one
    host); its worker SIGKILLed in the middle of the apply, once the
    server's store holds the pool's Node (read through the worker
    plane's facade with the worker's own credential): the deployment
    Pending, its Node written and no bundle object yet; the babysitter's
    respawn and the phase Ready with KfAvailable, the Node the same
    object (its uid) and every bundle object there, each once; one
    `DeployProber` round against the server; then
    ``python -m kubeflow_tpu_torch.deploy apply --dry-run`` on the same
    pool with provider gke, which must print one node pool of machine
    type a3-highgpu-1g with one nvidia-h100-80gb.

    Gates: each of those; no deploy process (the server, every worker,
    the dry run) loaded torch; the server exits 0 on SIGTERM with its
    workers gone; no kernel launched; the phase within
    DEPLOY["limit_s"]. Returns the launch counts (none)."""
    import select
    import signal

    from kubeflow_tpu_torch.deploy.bundles import bundle_resources
    from kubeflow_tpu_torch.deploy.kfdef import NodePool, default_spec
    from kubeflow_tpu_torch.deploy.provisioner import PLATFORM_LABEL
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.testing.e2e_util import DeployProber
    from kubeflow_tpu_torch.testing.fake_apiserver import NotFound

    t_phase = time.perf_counter()
    _kernels.launches.clear()
    accelerator = gpu_accelerator(card)
    pool = NodePool(name="gpu-pool-0", accelerator=accelerator, topology="1")
    spec = default_spec("kf-card")
    spec.node_pools = [pool]
    checks, sec, workers = {}, {}, {}
    root = tempfile.mkdtemp(prefix="kftpu_deploy_")
    env = {**os.environ, "KFTPU_WORKER_APPLY_DELAY": str(DEPLOY["apply_delay_s"]),
           "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    server = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.deploy", "serve", "--port", "0",
         "--worker-mode", "process"], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([server.stdout], [], [], 10.0)
        line = server.stdout.readline() if ready else ""
        if not line.startswith("deploy-server: http://"):
            raise AssertionError(f"the deploy server printed {line!r}")
        sec["server_start"] = time.perf_counter() - t_phase
        client = DeployClient(line.split()[1])
        status_path = "/kfctl/apps/v1/status/kf-card"

        def phase_of():
            reply = client.get(status_path)
            return reply.json()["status"] if reply.status == 200 else {}

        def worker_pids() -> set:
            return {pid for pid, cmd in child_processes(server.pid).items()
                    if "kubeflow_tpu_torch.deploy.worker" in cmd and "kf-card" in cmd}

        t_create = time.perf_counter()
        checks["create_200"] = client.post("/kfctl/apps/v1/create",
                                           spec.to_dict()).status == 200
        first = wait_for(lambda: worker_pids(), 5.0, "the deploy worker")
        [victim] = worker_pids()
        workers["killed"] = victim
        store = worker_store(victim)

        def nodes() -> dict:
            return {n.metadata.name: n.metadata.uid for n in store.list(
                "Node", "", label_selector={PLATFORM_LABEL: spec.name})}

        def bundle_objects() -> list:
            present = []
            for res in bundle_resources(spec):
                try:
                    store.get(res.kind, res.metadata.name, res.metadata.namespace)
                except NotFound:
                    continue
                present.append((res.kind, res.metadata.namespace, res.metadata.name))
            return present

        wait_for(lambda: phase_of().get("phase") == "Pending" and nodes(),
                 DEPLOY["ready_timeout_s"], "the PLATFORM phase's Node")
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        # The respawn holds as long before its K8S phase: what is in the
        # store now is what the killed worker left.
        at_kill = phase_of()
        nodes_at_kill, bundles_at_kill = nodes(), bundle_objects()
        checks["killed_mid_apply"] = (
            at_kill.get("phase") == "Pending"
            and sorted(nodes_at_kill) == [f"{spec.name}-{pool.name}-0"]
            and bundles_at_kill == [])
        wait_for(lambda: worker_pids() - {victim}, 10.0, "the respawned deploy worker")
        sec["kill_to_respawn"] = time.perf_counter() - t_kill
        [workers["respawned"]] = worker_pids() - {victim}
        wait_for(lambda: phase_of().get("phase") in ("Ready", "Failed"),
                 DEPLOY["ready_timeout_s"], "the deployment to converge")
        sec["kill_to_ready"] = time.perf_counter() - t_kill
        status = phase_of()
        checks["ready_after_respawn"] = (
            status.get("phase") == "Ready"
            and [c.get("type") for c in status.get("conditions", [])] == ["KfAvailable"])
        nodes_ready, bundles_ready = nodes(), bundle_objects()
        store.close()
        checks["applied_once_after_respawn"] = (
            nodes_ready == nodes_at_kill
            and len(bundles_ready) == len(bundle_resources(spec)))
        sec["create_to_worker"] = first

        t_probe = time.perf_counter()
        prober = DeployProber(client, sleep=lambda dt: time.sleep(0.1),
                              timeout_seconds=DEPLOY["ready_timeout_s"])
        probe_spec = default_spec("kf-probe")
        probe_spec.node_pools = [pool]
        checks["probe_ok"] = prober.probe_once(probe_spec.to_dict())
        sec["probe"] = time.perf_counter() - t_probe
        metrics = prober.metrics.expose_text()
        checks["probe_gauges"] = ("deployment_service_status 1" in metrics
                                  and "deployment_probe_failures_total 0" in metrics)
        workers["probe"] = sorted(
            pid for pid, cmd in child_processes(server.pid).items() if "kf-probe" in cmd)
        live = [server.pid, *(p for p in (workers["respawned"], *workers["probe"])
                              if os.path.exists(f"/proc/{p}"))]
        torch_in = {pid: loads_torch(pid) for pid in live}

        t_dry = time.perf_counter()
        gke = default_spec("kf-card")
        gke.provider, gke.project, gke.zone = "gke", "kftpu-card", "us-central1-a"
        gke.node_pools = [pool]
        spec_file = os.path.join(root, "platform.yaml")
        with open(spec_file, "w") as f:
            f.write(gke.to_yaml())
        dry = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "kubeflow_tpu_torch.deploy", "apply",
             "-f", spec_file, "--dry-run"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=60)
        sec["dry_run"] = time.perf_counter() - t_dry
        # The requests as indented JSON objects, then the K8S phase's line.
        text = dry.stdout
        payload = "\n".join(ln for ln in text.splitlines() if not ln.startswith("#"))
        requests, pos, decoder = [], 0, json.JSONDecoder()
        while payload[pos:].strip():
            obj, end = decoder.raw_decode(payload[pos:].lstrip())
            pos += len(payload[pos:]) - len(payload[pos:].lstrip()) + end
            requests.append(obj)
        pools = [r["body"]["nodePool"] for r in requests if r["url"].endswith("/nodePools")]
        imported = {line.rsplit("|", 1)[-1].strip() for line in dry.stderr.splitlines()
                    if line.startswith("import time:")}
        checks["dry_run_gpu_pool"] = (
            dry.returncode == 0 and len(pools) == 1
            and pools[0]["config"]["machineType"] == "a3-highgpu-1g"
            and pools[0]["config"]["accelerators"] == [
                {"acceleratorType": "nvidia-h100-80gb", "acceleratorCount": 1}]
            and "K8S phase would apply" in text)
        torch_in["dry_run"] = any(m == "torch" or m.startswith("torch.") for m in imported)
        checks["no_torch_in_deploy_processes"] = len(torch_in) >= 3 and not any(
            torch_in.values())

        server.send_signal(signal.SIGTERM)
        code = server.wait(timeout=30)
        seen = [workers["killed"], workers["respawned"], *workers["probe"]]
        time.sleep(0.2)
        checks["server_exit_0"] = code == 0
        checks["workers_gone"] = not any(deploy_worker_alive(p) for p in seen)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(_kernels.launches)
    checks["no_kernel_launch"] = launches == {}
    seconds = time.perf_counter() - t_phase
    checks["within_limit"] = seconds <= DEPLOY["limit_s"]
    out = {
        "phase": "deploy", "card": card, "accelerator": accelerator,
        "pool": pool.to_dict(), "gpus_per_host": 1, "config": DEPLOY,
        "status_at_kill": at_kill, "nodes_at_kill": nodes_at_kill,
        "bundle_objects_at_kill": len(bundles_at_kill), "nodes_ready": nodes_ready,
        "bundle_objects_ready": len(bundles_ready), "status": status, "workers": workers,
        "probe_metrics": {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines()
                          if ln and not ln.startswith("#")},
        "dry_run_pools": pools, "torch_loaded": {str(k): v for k, v in torch_in.items()},
        "server_exit": code, "launches": launches, "checks": checks,
        "seconds": {k: round(v, 3) for k, v in sec.items()}, "phase_seconds": seconds,
    }
    emit(out)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        print(dry.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"deploy phase checks failed: {failed}")
    return launches


def cache_bytecode() -> dict:
    """Lets this process and every process it starts (workers, pods,
    binaries: they inherit the environment) keep the bytecode Python
    compiles under ``build/pycache`` in the checkout; returns that
    directory and whether the environment had turned writing off. Where the environment says PYTHONDONTWRITEBYTECODE and the
    installed packages ship no ``.pyc``, every new process compiles
    torch's Python sources anew, on import and in its first step's lazy
    imports (tools/worker_start.py): seconds of every worker's start."""
    prefix = os.path.join(ROOT, "build", "pycache")
    was_off = bool(os.environ.pop("PYTHONDONTWRITEBYTECODE", None)) or sys.dont_write_bytecode
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    return {"prefix": prefix, "writing_was_off": was_off}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import kubeflow_tpu_torch  # noqa: F401
    except ImportError as err:  # the script alone, outside a checkout
        print(f"chip_smoke: {err}; run it from the root of a checkout",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = device_phase(torch, cache_bytecode())["nvidia_smi"]
    ptxas = build_phase()
    if sys.argv[1:2] == ["--loss-seeds"]:
        loss_seeds(torch, int(sys.argv[2]))
        return 0
    serving_fwd = kernel_phase(torch)
    entries = bwd_kernel_phase(torch, card, ptxas)
    rect_entries = rect_kernel_phase(torch, card)
    servable, batches, served, result = serve_phase(torch)
    check_phase(torch, servable, batches, served)
    timing_phase(torch, servable, batches)
    del servable
    torch.cuda.empty_cache()
    train_launches, train_step_ms = train_phase(torch, card)
    by_path = {"serve": result["launches"], **train_launches}
    gang_dir = tempfile.mkdtemp(prefix="kftpu_gang_")
    try:
        _, check_rows = train_check_phase(torch, keep_f32=os.path.join(gang_dir, "reference.pt"))
        gang_parity_phase(torch, card, os.path.join(gang_dir, "reference.pt"))
        ring_nccl_phase(torch)
    finally:
        shutil.rmtree(gang_dir, ignore_errors=True)
    by_path["remat"] = remat_phase(torch, card, check_rows[0])
    by_path.update(moe_phases(torch, card))
    by_path["fit"] = fit_phase(torch, card)
    entries.update(rect_entries)
    by_path["ring_train"] = ring_train_phase(torch, card)
    ring_check_phase(torch)
    resnet_check_phase(torch, card)
    resnet_step_ms = resnet_train_phase(torch, card)
    resnet_root = tempfile.mkdtemp(prefix="kftpu_resnet_")
    try:
        step = resnet_fit_phase(torch, card, resnet_root)
        records_losses, by_path["records_fit"] = records_fit_phase(
            torch, card, resnet_root, resnet_step_ms)
        resnet_serve_phase(torch, card, os.path.join(resnet_root, "ckpt"), step)
        controller_phase(torch, card, os.path.join(resnet_root, "ckpt"), step)
    finally:
        shutil.rmtree(resnet_root, ignore_errors=True)
    rl_phase(torch, card)
    by_path["frontdoor"] = frontdoor_phase(torch, card)
    job_paths, path_a = job_plane_phases(torch, card, train_step_ms,
                                         check_rows[0]["loss_kernel_vs_plain"]["se"],
                                         records_losses)
    by_path.update(job_paths)
    by_path["ha_job"] = ha_job_phase(torch, card, path_a)
    by_path["tenant"] = tenant_phase(torch, card, path_a)
    by_path["platform"] = platform_phase(torch, card, path_a)
    by_path["chaos_job"] = chaos_job_phase(torch, card, path_a)
    by_path["deploy"] = deploy_phase(torch, card)
    for name, entry in entries.items():
        counts = {path: launches.get(name, 0) for path, launches in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if entry["launches"] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    entries["flash_fwd"]["max_abs_err"] = serving_fwd["max_abs_err"]
    entries["flash_fwd"]["serving_shape"] = {
        key: serving_fwd[key] for key in (
            "shape_bshd", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "achieved_tflops", "bound_share")
    }
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)  # nvidia-smi's name and power limit
    emit({"kernels": [entries[name] for name in KERNEL_ROWS]})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-nccl-worker"]:
        sys.exit(ring_nccl_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--gang-worker"]:
        sys.exit(gang_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-load-worker"]:
        sys.exit(serve_load_worker(*sys.argv[2:8]))
    sys.exit(main())
