"""Rollout orchestration of the port: the task runner, the staleness
controller and the workflow executor (copies of `areal_tpu/core/`)."""
