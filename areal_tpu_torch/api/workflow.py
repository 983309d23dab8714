"""Rollout workflow interface (the port's copy of `areal_tpu/api/workflow.py`)."""

import abc
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    from areal_tpu_torch.api.engine import InferenceEngine


class RolloutWorkflow(abc.ABC):
    @abc.abstractmethod
    async def arun_episode(
        self, engine: "InferenceEngine", data: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Run one episode; return a padded array dict (see
        `utils.data.pad_sequences_to_tensors`) or None to reject.

        May issue several `engine.agenerate` calls concurrently (a GRPO
        group, for one).
        """
