"""Test and load-generation support for the port: the open-loop load
harness (`testing/loadgen.py`), the serving data plane's replica-kill
plans (`testing/chaos.py`) and the tiny models of the resilience suites
(`testing/tinymodels.py`).

Imports nothing at package level: `loadgen`'s worker processes start
under the spawn context and import this package first."""
