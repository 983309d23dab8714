"""PPO actor of the port."""

from areal_tpu_torch.engine.ppo.actor import PPOActor, TorchPPOActor  # noqa: F401
