"""Trace analytics for the lifecycle telemetry (the port's copies of
`areal_tpu/obs/`, standard library only): everything here parses dumped
JSONL or an in-memory event list, strictly offline.

- :mod:`areal_tpu_torch.obs.trace` — per-trajectory records, the trace
  completeness linter, and per-stage latency decomposition with an
  accounting identity (stage sum ≈ client-measured end-to-end).
- :mod:`areal_tpu_torch.obs.slo` — the SLO report (JSON + markdown).
  ``python -m areal_tpu_torch.obs.slo``.
- :mod:`areal_tpu_torch.obs.workload` — arrival processes from a recorded
  trace plus a seeded synthetic mixed workload for
  `areal_tpu_torch/scripts/bench_replay.py`.
"""
