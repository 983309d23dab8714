"""PPO actor and critic of the port."""

from areal_tpu_torch.engine.ppo.actor import PPOActor, TorchPPOActor  # noqa: F401
from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic  # noqa: F401
