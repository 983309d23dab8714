"""PPO critic: a value model with a scalar head over the backbone (the port
of `areal_tpu/engine/ppo/critic.py` `JaxPPOCritic`).

The value head is a `[D]` parameter (`model.value_head`) dotted against
the final-norm hidden states; the LM head is dropped and the model's
config is tied, so a save writes the backbone as a tied HF checkpoint with
no `lm_head` and the head beside it as `value_head.npy`
(`models/hf.py`), and a load reads both.  Per-token values take the same
row-packed path as the actor's logprobs, through the flash kernels.

Rounding points are the reference's: the head is cast to the compute
dtype and the product taken there; the values become f32 in the forward
hook and in the loss.  The head is 1-D, so `decays` leaves it out of
weight decay, as the reference's `ndim >= 2` mask does.
"""

import functools
from typing import Dict, List

import numpy as np
import torch

from areal_tpu_torch.engine.torch_train import TorchTrainEngine
from areal_tpu_torch.models.hf import attach_value_head
from areal_tpu_torch.models.transformer import forward_hidden
from areal_tpu_torch.ops.functional import ppo_critic_loss_fn
from areal_tpu_torch.parallel import distributed
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list


def _value_hook(values: torch.Tensor, mb) -> torch.Tensor:
    return values.float()


def critic_loss(values: torch.Tensor, mb, eps_clip_value):
    return ppo_critic_loss_fn(values.float(), mb["values"], mb["returns"], mb["loss_mask"],
                              eps_clip_value=eps_clip_value)


class TorchPPOCritic(TorchTrainEngine):
    """TorchTrainEngine + a value head: `compute_values` and `ppo_update`
    under a `PPOCriticConfig` (the reward model subclasses it with a plain
    `TrainEngineConfig`)."""

    # the batch keys the value loss reads
    LOSS_KEYS = ("input_ids", "attention_mask", "loss_mask", "values", "returns")

    def initialize(self, addr=None, ft_spec=None) -> None:
        """The backbone without its LM head, the value head (zero, or the
        checkpoint's `value_head.npy`), then AdamW over both."""
        optimizer_cfg = self.config.optimizer
        self.config.optimizer = None
        try:
            super().initialize(addr, ft_spec)
        finally:
            self.config.optimizer = optimizer_cfg
        self.model.lm_head = None
        self.model_config = self.model_config.replace(tie_word_embeddings=True)
        self.model.cfg = self.model_config
        if not hasattr(self.model, "value_head"):
            attach_value_head(self.model, np.zeros(self.model_config.hidden_size, np.float32))
        self.model.value_head.requires_grad_(True)
        with torch.no_grad():
            distributed.broadcast_(self.model.value_head.data, self.mesh.group)
        if optimizer_cfg is not None:
            self._build_optimizer(ft_spec)

    def _call_model(self, mb):
        hidden = forward_hidden(self.model, mb["input_ids"], mb["positions"], mb["segment_ids"],
                                mesh=self.mesh)
        return hidden @ self.model.value_head.to(hidden.dtype)

    def compute_values(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Token-level values [B, L], aligned with the input batch."""
        return self.forward(batch, post_hook=_value_hook)

    def ppo_update(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
        """One `train_batch` a minibatch of the (predictor-aligned) batch,
        each weighted by its valid tokens."""
        view = {k: batch[k] for k in self.LOSS_KEYS if k in batch}
        mbs = split_padded_tensor_dict_into_mb_list(view, n_mbs=self.config.ppo_n_minibatches)
        loss_fn = functools.partial(critic_loss, eps_clip_value=self.config.value_eps_clip)
        return [self.train_batch(mb, loss_fn,
                                 loss_weight_fn=lambda b: float(np.sum(b["loss_mask"])))
                for mb in mbs.mbs]
