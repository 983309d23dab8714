"""The inference-engine interface (the part of
`areal_tpu/api/engine.py InferenceEngine` that the port's colocated engine
implements): what workflows and the workflow executor call."""

import abc
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse


class InferenceEngine(abc.ABC):
    @abc.abstractmethod
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Generate one completion; per-token versions ride in the
        response."""

    @abc.abstractmethod
    def rollout_batch(
        self,
        data: List[Dict[str, Any]],
        workflow=None,
        workflow_builder: Optional[Callable] = None,
        should_accept: Optional[Callable] = None,
    ) -> Dict[str, Any]:
        """Run one episode per item and concatenate the trajectories."""

    @abc.abstractmethod
    def get_version(self) -> int:
        """The weight version new tokens are generated under."""
