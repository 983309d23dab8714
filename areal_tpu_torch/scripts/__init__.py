"""Runnable drivers of the port (`python -m areal_tpu_torch.scripts.<name>`)."""
