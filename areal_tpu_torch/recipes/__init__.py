"""Algorithm recipes of the port (copies of `areal_tpu/recipes/`)."""

from areal_tpu_torch.recipes.aent import (  # noqa: F401
    AEntConfig,
    AEntPPOActor,
    AEntPPOActorConfig,
    TorchAEntPPOActor,
    aent_grpo_loss_fn,
)
