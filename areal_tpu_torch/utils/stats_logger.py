"""Experiment metric logging (the port's copy of
`areal_tpu/utils/stats_logger.py`): one JSON line per committed step in
``<fileroot>/logs/<experiment>/<trial>/stats.jsonl``, appended and flushed
at each commit, so the lines of a run that was killed and relaunched
stand in one file.  The reference's wandb and tensorboard sinks are not
ported: the card's machine has neither."""

import json
import logging
import os
import time
from typing import Dict, List, Union

from areal_tpu_torch.api.config import StatsLoggerConfig

logger = logging.getLogger("areal_tpu_torch.stats_logger")


class StatsLogger:
    def __init__(self, config: StatsLoggerConfig):
        self.config = config
        self._start = time.monotonic()
        root = self.get_log_path(config)
        os.makedirs(root, exist_ok=True)
        self._jsonl = open(os.path.join(root, "stats.jsonl"), "a")

    @staticmethod
    def get_log_path(config: StatsLoggerConfig) -> str:
        return os.path.join(config.fileroot, "logs", config.experiment_name,
                            config.trial_name)

    def commit(self, epoch: int, step: int, global_step: int,
               data: Union[Dict[str, float], List[Dict[str, float]]]):
        """Append one record: the step's position and `data` (a dict of
        numbers, or a list of them merged in order, later keys winning)."""
        if isinstance(data, list):
            merged: Dict[str, float] = {}
            for d in data:
                merged.update(d)
            data = merged
        elapsed = time.monotonic() - self._start
        logger.info("Epoch %d step %d (global %d) [%.1fs]: %s", epoch + 1, step + 1,
                    global_step + 1, elapsed,
                    " ".join(f"{k}={v:.4g}" for k, v in sorted(data.items())))
        rec = {"epoch": epoch, "step": step, "global_step": global_step, **data}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def state_dict(self):
        return {"start_offset": time.monotonic() - self._start}

    def load_state_dict(self, state):
        self._start = time.monotonic() - state.get("start_offset", 0.0)
