"""Datasets of the port (copies of `areal_tpu/dataset/`)."""
