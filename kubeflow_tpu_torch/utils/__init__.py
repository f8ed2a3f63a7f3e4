"""Utilities: Prometheus-style metrics (`utils/metrics.py`)."""
