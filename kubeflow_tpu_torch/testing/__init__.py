"""Test and load-generation support for the port: the open-loop load
harness (`testing/loadgen.py`), the serving data plane's replica-kill
plans (`testing/chaos.py`), the tiny models of the resilience suites
(`testing/tinymodels.py`), and the control plane's in-process API server
(`testing/fake_apiserver.py`) with its HTTP facade and client
(`testing/apiserver_http.py`).

Imports nothing at package level: `loadgen`'s worker processes start
under the spawn context and import this package first."""
