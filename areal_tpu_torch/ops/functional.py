"""Loss functions and token-level numerics in plain PyTorch (the port of
`areal_tpu/ops/functional.py`: masked means, logprob gathering, the KL
estimators and the decoupled-PPO / GRPO actor loss).

All reductions are masked *sums* plus explicit weights, so the engine can
normalise globally across micro-batches; softmax and log-softmax run in
f32 whatever the activation dtype.
"""

import os
from typing import Dict, Optional, Tuple

import torch

from areal_tpu_torch.models.transformer import LMOutput
from areal_tpu_torch.ops.fused_xent import fused_logprobs_entropy


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-8) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / (mask.sum() + eps)


def masked_normalize(x: torch.Tensor, mask: Optional[torch.Tensor], unbiased: bool = False,
                     eps: float = 1e-5) -> torch.Tensor:
    """Whiten x over masked entries."""
    if mask is None:
        mask = torch.ones_like(x)
    mask = mask.to(x.dtype)
    n = mask.sum()
    mean = (x * mask).sum() / torch.clamp(n, min=1.0)
    var = ((x - mean).square() * mask).sum() / torch.clamp(
        n - (1.0 if unbiased else 0.0), min=1.0)
    return (x - mean) * torch.rsqrt(var + eps) * mask


def gather_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(labels) from logits [..., V]; f32 log-softmax."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz


def gather_logprobs_entropy(logits: torch.Tensor,
                            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logprobs, entropy) in one pass."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    logp_all = logits - logz[..., None]
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return picked - logz, entropy


def lm_logprobs_entropy(
    out,  # LMOutput (deferred head) or materialised logits [..., V]
    labels: torch.Tensor,  # int [...]
    temperature: float = 1.0,
    with_entropy: bool = True,
    entropy_grad: bool = True,
    vocab_chunk: Optional[int] = None,  # None -> AREAL_LM_HEAD_CHUNK or 8192
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logprobs, entropy, argmax-correct) of `labels`, f32.

    With an `LMOutput` this runs the vocab-chunked fused head
    (`ops/fused_xent.py`); the JAX package's token-chunked alternative and
    its entropy clamp are not ported, and a final-logit softcap (gemma2,
    which the port does not run) raises."""
    inv_t = float(1.0 / temperature)
    if not isinstance(out, LMOutput):
        logits = out.float() * inv_t
        logp, ent = gather_logprobs_entropy(logits, labels)
        corr = (logits.argmax(dim=-1) == labels).float()
        return logp, ent, corr
    if out.logit_softcap is not None:
        raise NotImplementedError("a final-logit softcap needs the chunked head, not ported")
    shape = labels.shape
    D = out.hidden.shape[-1]
    lp, ent, corr = fused_logprobs_entropy(
        out.hidden.reshape(-1, D), out.head, labels.reshape(-1), temperature=temperature,
        vocab_chunk_width=int(vocab_chunk or os.environ.get("AREAL_LM_HEAD_CHUNK", 8192)),
        with_entropy=with_entropy, entropy_grad=entropy_grad,
    )
    return lp.reshape(shape), ent.reshape(shape), corr.reshape(shape)


def kl_estimate(logp: torch.Tensor, ref_logp: torch.Tensor, kind: str = "k1",
                clip: float = 20.0) -> torch.Tensor:
    """Schulman k1/k2/k3 estimators of KL(pi || ref) per token."""
    diff = torch.clamp(logp - ref_logp, -clip, clip)
    if kind == "k1":
        return diff
    if kind == "k2":
        return 0.5 * diff.square()
    if kind == "k3":
        return torch.exp(-diff) - 1.0 + diff
    raise ValueError(f"unknown KL estimator {kind}")


def ppo_actor_loss_fn(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    eps_clip: float,
    loss_mask: torch.Tensor,
    c_clip: Optional[float] = None,
    proximal_logprobs: Optional[torch.Tensor] = None,
    behav_imp_weight_cap: Optional[float] = None,
    eps_clip_higher: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoupled-PPO actor loss.  With `proximal_logprobs` the ratio is
    taken against the proximal policy and each token is reweighted by the
    (optionally capped) behaviour importance weight exp(prox - old).
    Returns (sum-reduced masked loss, stats dict of masked sums)."""
    denorm = proximal_logprobs if proximal_logprobs is not None else old_logprobs
    loss_mask = loss_mask.float()
    ratio = torch.exp(logprobs - denorm)
    clipped_ratio = torch.clamp(
        ratio, 1.0 - eps_clip,
        1.0 + (eps_clip_higher if eps_clip_higher is not None else eps_clip))
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    clip_mask = pg_loss1 < pg_loss2
    pg_loss = torch.maximum(pg_loss1, pg_loss2)
    if c_clip is not None:
        pg_loss3 = torch.sign(advantages) * c_clip * advantages
        dual_clip_mask = (advantages < 0) & (pg_loss3 < pg_loss)
        pg_loss = torch.where(advantages < 0, torch.minimum(pg_loss, pg_loss3), pg_loss)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)
    if proximal_logprobs is not None:
        behav_kl = denorm - old_logprobs
        behav_imp_weight = torch.exp(behav_kl)
        if behav_imp_weight_cap is not None:
            behav_mask = (behav_imp_weight <= behav_imp_weight_cap) & (loss_mask > 0)
        else:
            behav_mask = loss_mask > 0
        behav_imp_weight = torch.where(behav_mask, behav_imp_weight, 0.0)
        pg_loss = pg_loss * behav_imp_weight
        stat_behav_kl = (behav_kl * behav_mask).sum()
        stat_behav_w = (behav_imp_weight * behav_mask).sum()
    else:
        stat_behav_kl = torch.zeros((), device=logprobs.device)
        stat_behav_w = torch.zeros((), device=logprobs.device)
    loss = (pg_loss * loss_mask).sum()
    stats = {
        "importance_weight": (ratio * loss_mask).sum(),
        "approx_kl": ((logprobs - denorm) * loss_mask).sum(),
        "clip_ratio": (clip_mask * loss_mask).sum(),
        "dual_clip_ratio": (dual_clip_mask * loss_mask).sum(),
        "behave_kl": stat_behav_kl,
        "behave_imp_weight": stat_behav_w,
        "n_valid_tokens": loss_mask.sum(),
    }
    return loss, stats


def grpo_loss_fn(
    model_out,  # LMOutput or [..., V] logits
    batch: Dict[str, torch.Tensor],
    eps_clip: float,
    c_clip: Optional[float] = None,
    behav_imp_weight_cap: Optional[float] = None,
    temperature: float = 1.0,
    use_decoupled_loss: bool = True,
    entropy_coef: float = 0.0,
    eps_clip_higher: Optional[float] = None,
    vocab_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Packed GRPO/PPO policy loss over next-token logits.  batch keys
    ([..., T], predictor-aligned): input_ids, loss_mask, logprobs
    (behaviour), advantages, and optionally prox_logp."""
    labels = torch.roll(batch["input_ids"], -1, dims=-1)
    loss_mask = batch["loss_mask"].float()
    logprobs, entropy, _ = lm_logprobs_entropy(
        model_out, labels, temperature=temperature,
        # entropy is a logged stat unless an entropy bonus trains on it
        entropy_grad=bool(entropy_coef), vocab_chunk=vocab_chunk,
    )
    old_logp = batch["logprobs"]
    prox = batch.get("prox_logp") if use_decoupled_loss else None
    loss, stats = ppo_actor_loss_fn(
        logprobs=logprobs, old_logprobs=old_logp, advantages=batch["advantages"],
        eps_clip=eps_clip, loss_mask=loss_mask, c_clip=c_clip, proximal_logprobs=prox,
        behav_imp_weight_cap=behav_imp_weight_cap, eps_clip_higher=eps_clip_higher,
    )
    if entropy_coef:
        loss = loss - entropy_coef * (entropy * loss_mask).sum()
    stats["entropy"] = (entropy * loss_mask).sum()
    stats["new_logp"] = (logprobs * loss_mask).sum()
    stats["old_logp"] = (old_logp * loss_mask).sum()
    return loss, stats
