"""Frequency control for periodic actions (the port's copy of
`areal_tpu/utils/timer.py`), which `Saver`, the checkpointer and
`Evaluator` consult once per step."""

import time

from areal_tpu_torch.api.config import TimerConfig


class FrequencyControl:
    """Triggers when ANY configured budget (epochs, steps, seconds) has
    elapsed since the last trigger; all-None never triggers (except on
    an explicit `force`).  Counting starts at epoch 0, step 0, so a
    `freq_steps` of N first fires at step N."""

    def __init__(self, config: TimerConfig):
        self.freq_epochs = config.freq_epochs
        self.freq_steps = config.freq_steps
        self.freq_secs = config.freq_secs
        self._last_epoch = 0
        self._last_step = 0
        self._last_time = time.monotonic()

    def check(self, epoch: int, step: int, force: bool = False) -> bool:
        now = time.monotonic()
        hit = force
        if self.freq_epochs is not None and epoch - self._last_epoch >= self.freq_epochs:
            hit = True
        if self.freq_steps is not None and step - self._last_step >= self.freq_steps:
            hit = True
        if self.freq_secs is not None and now - self._last_time >= self.freq_secs:
            hit = True
        if hit:
            self._last_epoch, self._last_step, self._last_time = epoch, step, now
        return hit

    def state_dict(self):
        return {
            "last_epoch": self._last_epoch,
            "last_step": self._last_step,
            "elapsed": time.monotonic() - self._last_time,
        }

    def load_state_dict(self, state):
        self._last_epoch = state["last_epoch"]
        self._last_step = state["last_step"]
        self._last_time = time.monotonic() - state.get("elapsed", 0.0)
