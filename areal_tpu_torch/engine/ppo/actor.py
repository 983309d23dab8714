"""PPO/GRPO actor (the port of `areal_tpu/engine/ppo/actor.py`).

`PPOActor` is the algorithm layer over a train engine: `compute_logp`
(the proximal policy of the decoupled objective), `compute_advantages`
(reward shaping, predictor alignment, terminal reward, GAE, advantage
normalisation) and `ppo_update` (dynamic sampling, minibatch split, one
`train_batch` per minibatch).  `TorchPPOActor` is `TorchTrainEngine` plus
that surface, the counterpart of `JaxPPOActor`.

Alignment: trajectories arrive token-aligned (arr[t] describes token t);
losses consume predictor-aligned arrays (arr[t] describes token t + 1).
`compute_advantages` performs that shift once; everything it writes back
(advantages, logprobs, prox_logp, loss_mask) is predictor-aligned, as
`grpo_loss_fn` and the engine's logprob hook produce.
"""

import functools
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.config import NormConfig, PPOActorConfig
from areal_tpu_torch.engine.torch_train import TorchTrainEngine
from areal_tpu_torch.ops.functional import grpo_loss_fn, lm_logprobs_entropy
from areal_tpu_torch.ops.gae import gae_padded
from areal_tpu_torch.utils import stats
from areal_tpu_torch.utils.data import (
    KLEstimator,
    Normalization,
    select_rows,
    split_padded_tensor_dict_into_mb_list,
)

logger = logging.getLogger("areal_tpu_torch.ppo.actor")


def _roll_back(arr: np.ndarray) -> np.ndarray:
    """token-aligned [B, L] -> predictor-aligned (arr[t] <- arr[t+1])."""
    return np.roll(arr, -1, axis=-1)


class PPOActor:
    """Algorithm layer over a train engine."""

    # batch keys forwarded into the loss
    LOSS_KEYS = ("input_ids", "attention_mask", "loss_mask", "logprobs", "advantages",
                 "prox_logp")
    # sum-reduced loss stats normalised to per-token means after each step
    PER_TOKEN_STAT_KEYS = (
        "importance_weight", "approx_kl", "clip_ratio", "dual_clip_ratio",
        "behave_kl", "behave_imp_weight", "entropy", "new_logp", "old_logp",
        "moe_aux_loss",
    )

    def __init__(self, config: PPOActorConfig, engine):
        self.config = config
        self.engine = engine

        def make_norm(norm_cfg):
            if norm_cfg is None:
                return None
            # NormConfig.group_size overrides when set; default to the GRPO
            # group size
            return Normalization(
                mean_level=norm_cfg.mean_level, std_level=norm_cfg.std_level,
                group_size=norm_cfg.group_size if norm_cfg.group_size > 1 else config.group_size,
                eps=norm_cfg.eps,
            )

        self.adv_norm = make_norm(config.adv_norm)
        self.reward_norm = make_norm(
            config.reward_norm or (NormConfig() if config.group_reward_norm else None))
        self._loss_fn = self._build_loss_fn()
        self._logp_hook = self._build_logp_hook()

    # ------------------------------------------------------------------

    def compute_logp(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Recompute current-policy logprobs (predictor-aligned [B, L])."""
        return self.engine.forward(batch, post_hook=self._logp_hook)

    def _build_logp_hook(self):
        temp = self.config.temperature
        vchunk = self.config.lm_head_chunk or None

        def hook(model_out, mb):
            labels = torch.roll(mb["input_ids"], -1, dims=-1)
            logp, _, _ = lm_logprobs_entropy(model_out, labels, temperature=temp,
                                             with_entropy=False, vocab_chunk=vchunk)
            return logp

        return hook

    # ------------------------------------------------------------------

    def compute_advantages(self, batch: Dict[str, np.ndarray]) -> None:
        """In place: add predictor-aligned advantages/logprobs/loss_mask."""
        cfg = self.config
        mask_tok = batch["loss_mask"].astype(np.float32)  # token-aligned
        B, L = mask_tok.shape

        # sequence-level reward shaping
        rewards = batch["rewards"].astype(np.float32).copy()
        seq_lens_completion = mask_tok.sum(-1)
        if cfg.mask_no_eos_with_zero and "no_eos" in batch:
            rewards = np.where(batch["no_eos"].astype(bool), 0.0, rewards)
        if cfg.overlong_reward_penalty and cfg.overlong_tokens > 0:
            # DAPO soft length penalty against the configured budget
            if cfg.max_new_tokens <= 0:
                raise ValueError("overlong_reward_penalty requires max_new_tokens to be "
                                 "set to the rollout's generation budget")
            overflow = seq_lens_completion - (cfg.max_new_tokens - cfg.overlong_tokens)
            penalty = np.clip(overflow / cfg.overlong_tokens, 0.0, 1.0) \
                * cfg.overlong_penalty_factor
            rewards = rewards - penalty
        rewards = (rewards + cfg.reward_bias) * cfg.reward_scaling
        rewards = np.clip(rewards, -cfg.reward_clip, cfg.reward_clip)
        if self.reward_norm is not None:
            rewards = self.reward_norm(rewards[:, None])[:, 0]

        # shift to predictor alignment
        mask = _roll_back(mask_tok)
        mask[:, -1] = 0.0
        prox_logp = batch.get("prox_logp")  # already predictor-aligned
        if prox_logp is not None and not cfg.use_decoupled_loss:
            # plain PPO with a recompute pass: the ratio is taken against the
            # recomputed policy
            old_logp = np.asarray(prox_logp, np.float32) * mask
        else:
            old_logp = _roll_back(batch["logprobs"].astype(np.float32)) * mask

        # token rewards: KL penalty + terminal reward
        tok_rewards = np.zeros((B, L), np.float32)
        if cfg.kl_ctl > 0 and "ref_logp" in batch:
            ref = _roll_back(batch["ref_logp"].astype(np.float32)) * mask
            kl = KLEstimator(cfg.kl_estimator)(old_logp, ref)
            tok_rewards -= cfg.kl_ctl * kl * mask
        # terminal reward at the last predictor position of each sequence
        idx = np.maximum(mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1), 0)
        has_completion = mask.sum(-1) > 0
        tok_rewards[np.arange(B), idx] += np.where(has_completion, rewards, 0.0)

        # GAE (values default 0: GRPO / reward-to-go); values are already
        # predictor-aligned and are not rolled
        values = batch.get("values")
        values = (values.astype(np.float32) * mask if values is not None
                  else np.zeros((B, L), np.float32))
        adv, returns = gae_padded(torch.from_numpy(tok_rewards), torch.from_numpy(values),
                                  torch.from_numpy(mask), cfg.discount, cfg.gae_lambda)
        adv, returns = adv.numpy(), returns.numpy()
        if self.adv_norm is not None:
            adv = self.adv_norm(adv, mask)

        batch["advantages"] = adv.astype(np.float32)
        batch["returns"] = returns.astype(np.float32)
        batch["logprobs"] = old_logp.astype(np.float32)
        batch["loss_mask"] = mask.astype(np.float32)
        batch["tot_rewards"] = rewards.astype(np.float32)
        if prox_logp is None and cfg.use_decoupled_loss:
            # without a recompute pass, proximal == behaviour policy
            batch["prox_logp"] = old_logp.astype(np.float32)

    # ------------------------------------------------------------------

    def _dynamic_filter(self, batch: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Drop groups whose rewards are all identical (zero advantage)."""
        g = self.config.group_size
        r = batch["rewards"].astype(np.float32)
        B = r.shape[0]
        if g <= 1 or B % g != 0:
            return None
        groups = r.reshape(-1, g)
        keep = np.repeat(~np.all(np.isclose(groups, groups[:, :1]), axis=1), g)
        if keep.all():
            return None
        if not keep.any():
            logger.warning("dynamic sampling rejected every group; keeping all")
            return None
        return np.nonzero(keep)[0]

    def ppo_update(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
        if self.config.dynamic_sampling:
            keep = self._dynamic_filter(batch)
            if keep is not None:
                batch = select_rows(batch, keep)
        train_view = {k: batch[k] for k in self.LOSS_KEYS if k in batch}
        mbs = split_padded_tensor_dict_into_mb_list(
            train_view, n_mbs=self.config.ppo_n_minibatches)
        return [self._train_one_mb(mb) for mb in mbs.mbs]

    def _build_loss_fn(self):
        cfg = self.config
        return functools.partial(
            grpo_loss_fn,
            eps_clip=cfg.eps_clip,
            c_clip=cfg.c_clip,
            behav_imp_weight_cap=cfg.behav_imp_weight_cap,
            temperature=cfg.temperature,
            use_decoupled_loss=cfg.use_decoupled_loss,
            eps_clip_higher=cfg.eps_clip_higher,
            vocab_chunk=cfg.lm_head_chunk or None,
        )

    def _train_one_mb(self, mb: Dict[str, np.ndarray]) -> Dict[str, float]:
        st = self.engine.train_batch(
            mb, self._loss_fn, loss_weight_fn=lambda b: float(np.sum(b["loss_mask"])))
        return self._finalize_mb_stats(st)

    def _finalize_mb_stats(self, st: Dict[str, float]) -> Dict[str, float]:
        n = max(st.pop("n_valid_tokens", 1.0), 1.0)
        for k in self.PER_TOKEN_STAT_KEYS:
            if k in st:
                st[k] = st[k] / n
        st["n_tokens"] = n
        with stats.DEFAULT_TRACKER.scope("ppo_actor"):
            stats.DEFAULT_TRACKER.scalar(**{k: v for k, v in st.items() if np.isscalar(v)})
        return st


class TorchPPOActor(TorchTrainEngine):
    """TorchTrainEngine + the PPOActor surface (the counterpart of
    `JaxPPOActor`)."""

    def __init__(self, config: PPOActorConfig, model_config=None, device=None):
        super().__init__(config, model_config, device)
        self.actor = PPOActor(config, self)

    def compute_logp(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        return self.actor.compute_logp(batch)

    def compute_advantages(self, batch: Dict[str, np.ndarray]) -> None:
        self.actor.compute_advantages(batch)

    def ppo_update(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
        return self.actor.ppo_update(batch)
