"""Head-only rollout for multi-process training (the port's copy of
`areal_tpu/core/dist_rollout.py`).

In a multi-process run only the head rank talks to the inference
servers: one client and one staleness gate, where N clients would each
admit `max_concurrent_rollouts` and overshoot the staleness budget.
Every other rank receives the head's whole batch through
`parallel/distributed.py broadcast_pytree` (its length, then its bytes),
and the train engine takes each rank's shard of it (`make_global_batch`).
"""

from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.parallel import distributed


class DistRolloutCoordinator:
    """Wraps an inference-engine-like rollout client so that only the head
    rank drives it; its results are broadcast to every rank."""

    def __init__(self, rollout_engine):
        self.rollout = rollout_engine

    @property
    def is_head(self) -> bool:
        return distributed.is_head()

    def rollout_batch(self, data: List[Dict[str, Any]], workflow=None,
                      workflow_builder: Optional[Callable] = None,
                      should_accept: Optional[Callable] = None) -> Dict[str, Any]:
        batch = None
        if self.is_head:
            batch = self.rollout.rollout_batch(data, workflow=workflow,
                                               workflow_builder=workflow_builder,
                                               should_accept=should_accept)
        return distributed.broadcast_pytree(batch)

    def prepare_batch(self, dataloader, workflow=None,
                      workflow_builder: Optional[Callable] = None,
                      should_accept: Optional[Callable] = None) -> Dict[str, Any]:
        batch = None
        if self.is_head:
            batch = self.rollout.prepare_batch(dataloader, workflow=workflow,
                                               workflow_builder=workflow_builder,
                                               should_accept=should_accept)
        return distributed.broadcast_pytree(batch)

    def pause(self):
        if self.is_head:
            self.rollout.pause()

    def resume(self):
        if self.is_head:
            self.rollout.resume()
