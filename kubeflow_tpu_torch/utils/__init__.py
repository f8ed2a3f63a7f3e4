"""Utilities: Prometheus-style metrics (`utils/metrics.py`), bounded
joins (`utils/threads.py`), shutdown signal handling
(`utils/signals.py`) and tracing spans (`utils/tracing.py`)."""
