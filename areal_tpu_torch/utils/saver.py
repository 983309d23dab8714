"""Frequency-controlled HF-format checkpoint saving (the port's copy of
`areal_tpu/utils/saver.py` `Saver`).

A save is staged and renamed: it is written into a ``.tmp-*`` sibling and
renamed to its published path, so a crash mid-save never leaves a
half-written checkpoint where a later run (or a person) would trust it.
With ``for_recover`` it is the checkpointer's form (the optimizer state
too, under ``recover_checkpoints``)."""

import logging
import os
import shutil
from typing import Optional

from areal_tpu_torch.api.config import SaverConfig
from areal_tpu_torch.api.io_struct import SaveLoadMeta, StepInfo
from areal_tpu_torch.utils.timer import FrequencyControl

logger = logging.getLogger("areal_tpu_torch.saver")


class Saver:
    def __init__(self, config: SaverConfig, ft_spec=None, for_recover: bool = False):
        self.config = config
        self.ft_spec = ft_spec
        self.for_recover = for_recover
        self.freq = FrequencyControl(config)

    def save_root(self) -> str:
        return os.path.join(
            self.config.fileroot,
            self.config.experiment_name,
            self.config.trial_name,
            "recover_checkpoints" if self.for_recover else "checkpoints",
        )

    def save_path(self, step_info: StepInfo, name: str = "default") -> str:
        return os.path.join(
            self.save_root(),
            name,
            f"epoch{step_info.epoch}epochstep{step_info.epoch_step}"
            f"globalstep{step_info.global_step}",
        )

    def save(
        self,
        engine,
        epoch: int,
        epoch_step: int,
        global_step: int,
        name: str = "default",
        force: bool = False,
    ) -> Optional[str]:
        """Save if the frequency budget elapsed; returns the path if saved."""
        if not self.freq.check(epoch, global_step, force=force):
            return None
        step_info = StepInfo(
            epoch=epoch, epoch_step=epoch_step, global_step=global_step,
            steps_per_epoch=self.ft_spec.steps_per_epoch if self.ft_spec else 0,
        )
        path = self.save_path(step_info, name)
        staging = os.path.join(os.path.dirname(path), f".tmp-{os.path.basename(path)}")
        for stale in (staging, path):
            if os.path.isdir(stale):
                shutil.rmtree(stale)
        os.makedirs(staging, exist_ok=True)
        engine.save(SaveLoadMeta(path=staging, with_optim=self.for_recover))
        os.rename(staging, path)  # atomic publish on one filesystem
        logger.info("saved checkpoint: %s", path)
        return path

    def state_dict(self):
        return {"freq": self.freq.state_dict()}

    def load_state_dict(self, state):
        self.freq.load_state_dict(state["freq"])
