"""Staleness-aware rollout capacity control (the port's copy of
`areal_tpu/core/staleness.py`), the async-RL throttle:

    capacity = min(max_concurrent - running,
                   (max_staleness + version + 1) * batch_size
                       - (accepted + running))

so that by the time a sample is consumed, its off-policyness cannot exceed
`max_staleness` versions.  The crash-recovery `restore` and the metrics
gauges of the reference are not ported.
"""

import threading
from dataclasses import asdict

from areal_tpu_torch.api.io_struct import RolloutStat


class StalenessManager:
    def __init__(
        self,
        max_concurrent_rollouts: int,
        consumer_batch_size: int,
        max_staleness: int,
    ):
        self.max_concurrent_rollouts = max_concurrent_rollouts
        self.consumer_batch_size = consumer_batch_size
        self.max_staleness = max_staleness
        self._lock = threading.Lock()
        self._stat = RolloutStat()

    def get_capacity(self, current_version: int) -> int:
        """Slots available for new rollouts; may be negative when over
        capacity (submission must then stall)."""
        with self._lock:
            concurrency_cap = max(1, self.max_concurrent_rollouts) - self._stat.running
            sample_cnt = self._stat.accepted + self._stat.running
            staleness_cap = (
                (self.max_staleness + current_version + 1)
                * max(1, self.consumer_batch_size)
                - sample_cnt
            )
            return min(concurrency_cap, staleness_cap)

    def _check_locked(self) -> None:  # holds: _lock
        """Ledger invariant: every submitted rollout is exactly one of
        accepted / rejected / still running.  Fails at the transition that
        broke it (a rollout settled twice or not at all)."""
        s = self._stat
        if s.submitted != s.accepted + s.rejected + s.running or s.running < 0:
            raise RuntimeError(
                f"staleness ledger violated: submitted={s.submitted} != "
                f"accepted={s.accepted} + rejected={s.rejected} + "
                f"running={s.running}"
            )

    def on_rollout_submitted(self) -> None:
        with self._lock:
            self._stat.submitted += 1
            self._stat.running += 1
            self._check_locked()

    def on_rollout_accepted(self) -> None:
        with self._lock:
            self._stat.accepted += 1
            self._stat.running -= 1
            self._check_locked()

    def on_rollout_rejected(self) -> None:
        with self._lock:
            self._stat.rejected += 1
            self._stat.running -= 1
            self._check_locked()

    def get_stats(self) -> RolloutStat:
        with self._lock:
            return RolloutStat(**asdict(self._stat))
