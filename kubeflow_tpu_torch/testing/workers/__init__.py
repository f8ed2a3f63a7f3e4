"""Worker entry points: the LM training job (`lm_job.py`, through the
launcher's ``--module``) and the RL study's trial (`rl_trial.py`,
``python -m``), which TpuJob pods run; the nightly LM pipeline's pod
steps, eval, serve and teardown (`lm_pipeline.py`, ``python -m``), which
a Workflow's step pods run; a leader-elected TpuJob operator replica
that can stall mid-preemption (`preempt_ha.py`, ``python -m``), which
`testing/job_plane.JobPlane` runs as a manager; and one incarnation of
the kill-and-resume training soak (`resilience.py`, ``python -m``),
which its test runs again and again over one checkpoint directory; and
the gang's own (``python -m``): `gang_worker.py` (one collective),
`train_worker.py` (a tiny ResNet trained over a dp mesh of the gang)
and `multislice_worker.py` (a two-slice hybrid mesh), the counterparts
of the JAX package's ``tests/e2e`` workers."""
