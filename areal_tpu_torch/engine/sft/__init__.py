"""Supervised finetuning engine of the port."""

from areal_tpu_torch.engine.sft.lm_engine import TorchLMEngine  # noqa: F401
