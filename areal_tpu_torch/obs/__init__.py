"""Observability helpers (the port's copies from `areal_tpu/obs/`)."""
