"""Worker entry points that TpuJob pods run: the LM training job
(`lm_job.py`, through the launcher's ``--module``) and the RL study's
trial (`rl_trial.py`, ``python -m``)."""
