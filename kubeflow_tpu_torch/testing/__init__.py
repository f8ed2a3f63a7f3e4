"""Test and load-generation support for the port: the open-loop load
harness (`testing/loadgen.py`), the fault plans of the wire, of the
kill-and-resume training soak, of the serving chaos run and of RL's
study soak (`testing/chaos.py`), the tiny models of the resilience
suites (`testing/tinymodels.py`), the readiness harness and the deploy
prober (`testing/e2e_util.py`), the control plane's
in-process API server (`testing/fake_apiserver.py`) with its durable
WAL (`testing/persist.py`), its active-passive fencing
(`testing/failover.py`) and its HTTP facade and endpoint-list client
(`testing/apiserver_http.py`), the one-host job plane
(`testing/job_plane.py`: the facade, controller-manager processes and
the local pod runner), the platform in a box as a child process and the
flow that drives it through its entry points (`testing/platform.py`),
RL's study soak (`testing/rl_soak.py`) and the workers its TpuJobs and
soaks run (`testing/workers/`).

Imports nothing at package level: `loadgen`'s worker processes start
under the spawn context and import this package first."""
