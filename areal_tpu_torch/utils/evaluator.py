"""Frequency-controlled evaluation callback (the port's copy of
`areal_tpu/utils/evaluator.py` `Evaluator`)."""

import logging
from typing import Callable, Optional

from areal_tpu_torch.api.config import EvaluatorConfig
from areal_tpu_torch.utils.timer import FrequencyControl

logger = logging.getLogger("areal_tpu_torch.evaluator")


class Evaluator:
    def __init__(self, config: EvaluatorConfig, ft_spec=None):
        self.config = config
        self.ft_spec = ft_spec
        self.freq = FrequencyControl(config)

    def evaluate(
        self,
        evaluate_fn: Callable[[], Optional[dict]],
        epoch: int,
        epoch_step: int,
        global_step: int,
        force: bool = False,
    ) -> Optional[dict]:
        """Run `evaluate_fn` if the frequency budget elapsed; returns its
        result, or None when it did not run."""
        if not self.freq.check(epoch, global_step, force=force):
            return None
        result = evaluate_fn()
        logger.info("eval @ step %d: %s", global_step, result)
        return result

    def state_dict(self):
        return {"freq": self.freq.state_dict()}

    def load_state_dict(self, state):
        self.freq.load_state_dict(state["freq"])
