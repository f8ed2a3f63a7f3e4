"""Utilities: Prometheus-style metrics (`utils/metrics.py`), bounded
joins (`utils/threads.py`) and shutdown signal handling
(`utils/signals.py`)."""
