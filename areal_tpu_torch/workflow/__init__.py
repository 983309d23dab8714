"""Rollout workflows of the port (copies of `areal_tpu/workflow/`)."""
