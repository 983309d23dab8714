"""Runnable examples of the port (`python -m areal_tpu_torch.examples.<area>.<name>`)."""
