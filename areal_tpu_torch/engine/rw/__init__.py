"""Bradley-Terry reward-model engine of the port."""

from areal_tpu_torch.engine.rw.rw_engine import TorchRewardModelEngine  # noqa: F401
