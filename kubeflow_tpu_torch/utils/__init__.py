"""Utilities: Prometheus-style metrics (`utils/metrics.py`) and bounded
joins (`utils/threads.py`)."""
