"""AEnt: adaptive entropy-regularised GRPO (the port of
`areal_tpu/recipes/aent.py`): GRPO with a clamped-entropy bonus whose
coefficient is adapted online to keep the policy's entropy inside a band;
after each update

    coeff -= coeff_lr * (min(0, H - H_low) + max(0, H - H_high))
    coeff  clamped to [box_low, box_high]

The entropy is clamped in token space: the bottom `entropy_clamp`
fraction of the vocabulary is masked before it is computed
(`ops/functional.py _clamped_entropy`, on the token-chunked head), so the
bonus cannot be farmed by spreading mass over junk tokens.  The live
coefficient rides in the batch as a per-token `entropy_coeff` array, so
the loss stays one function over the run.
"""

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.config import PPOActorConfig
from areal_tpu_torch.engine.ppo.actor import PPOActor
from areal_tpu_torch.engine.torch_train import TorchTrainEngine
from areal_tpu_torch.ops.functional import (
    lm_logprobs_entropy,
    next_token_labels,
    ppo_actor_loss_fn,
)


@dataclass
class AEntConfig:
    entropy_coeff: float = 1e-3
    entropy_clamp: float = 0.0  # fraction of the vocab masked from the entropy
    adaptive: bool = True
    entropy_low: float = 0.2
    entropy_high: float = 0.4
    coeff_lr: float = 1e-3
    coeff_box_low: float = 0.0
    coeff_box_high: float = 1e-2
    warmup_steps: int = 0


@dataclass
class AEntPPOActorConfig(PPOActorConfig):
    aent: AEntConfig = field(default_factory=AEntConfig)


def aent_grpo_loss_fn(
    model_out,
    batch: Dict[str, torch.Tensor],
    eps_clip: float,
    c_clip: Optional[float] = None,
    behav_imp_weight_cap: Optional[float] = None,
    temperature: float = 1.0,
    use_decoupled_loss: bool = True,
    eps_clip_higher: Optional[float] = None,
    entropy_clamp: float = 0.0,
    vocab_chunk: Optional[int] = None,
):
    """`grpo_loss_fn` with a clamped-entropy bonus scaled by the batch's
    `entropy_coeff` array."""
    loss_mask = batch["loss_mask"].float()
    logprobs, entropy, _ = lm_logprobs_entropy(
        model_out, next_token_labels(batch), temperature=temperature,
        entropy_clamp=entropy_clamp, vocab_chunk=vocab_chunk)
    prox = batch.get("prox_logp") if use_decoupled_loss else None
    loss, stats = ppo_actor_loss_fn(
        logprobs=logprobs, old_logprobs=batch["logprobs"], advantages=batch["advantages"],
        eps_clip=eps_clip, loss_mask=loss_mask, c_clip=c_clip, proximal_logprobs=prox,
        behav_imp_weight_cap=behav_imp_weight_cap, eps_clip_higher=eps_clip_higher)
    # the max over loss tokens of a constant-filled array is the scalar,
    # wherever the tokens sit
    coeff = (batch["entropy_coeff"] * loss_mask).max()
    loss = loss - coeff * (entropy * loss_mask).sum()
    stats["entropy"] = (entropy * loss_mask).sum()
    stats["new_logp"] = (logprobs * loss_mask).sum()
    stats["old_logp"] = (batch["logprobs"] * loss_mask).sum()
    return loss, stats


class AEntPPOActor(PPOActor):
    LOSS_KEYS = PPOActor.LOSS_KEYS + ("entropy_coeff",)

    def __init__(self, config: AEntPPOActorConfig, engine):
        super().__init__(config, engine)
        self.aent = config.aent
        self.entropy_coeff = float(self.aent.entropy_coeff)
        self._updates_done = 0

    def _build_loss_fn(self):
        cfg = self.config
        return functools.partial(
            aent_grpo_loss_fn, eps_clip=cfg.eps_clip, c_clip=cfg.c_clip,
            behav_imp_weight_cap=cfg.behav_imp_weight_cap, temperature=cfg.temperature,
            use_decoupled_loss=cfg.use_decoupled_loss, eps_clip_higher=cfg.eps_clip_higher,
            entropy_clamp=cfg.aent.entropy_clamp, vocab_chunk=cfg.lm_head_chunk or None)

    def ppo_update(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
        batch = dict(batch)
        batch["entropy_coeff"] = np.full(batch["input_ids"].shape, self.entropy_coeff,
                                         np.float32)
        all_stats = super().ppo_update(batch)
        aent = self.aent
        if aent.adaptive:
            self._updates_done += 1
            if self._updates_done > aent.warmup_steps:
                ent = float(np.mean([s["entropy"] for s in all_stats]))
                self.entropy_coeff -= aent.coeff_lr * (min(0.0, ent - aent.entropy_low)
                                                       + max(0.0, ent - aent.entropy_high))
                self.entropy_coeff = float(np.clip(self.entropy_coeff, aent.coeff_box_low,
                                                   aent.coeff_box_high))
        for s in all_stats:
            s["entropy_coeff"] = self.entropy_coeff
        return all_stats


class TorchAEntPPOActor(TorchTrainEngine):
    """TorchTrainEngine + the AEnt actor (the counterpart of
    `JaxAEntPPOActor`)."""

    def __init__(self, config: AEntPPOActorConfig, model_config=None, device=None):
        super().__init__(config, model_config, device)
        self.actor = AEntPPOActor(config, self)

    def compute_logp(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        return self.actor.compute_logp(batch)

    def compute_advantages(self, batch: Dict[str, np.ndarray]) -> None:
        self.actor.compute_advantages(batch)

    def ppo_update(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
        return self.actor.ppo_update(batch)
