"""Loss functions and token-level numerics in plain PyTorch (the port of
`areal_tpu/ops/functional.py`: masked means, logprob gathering, the KL
estimators, the decoupled-PPO / GRPO actor loss, the LM heads with the
clamped entropy, and the critic, SFT, pairwise reward and DPO losses).

All reductions are masked *sums* plus explicit weights, so the engine can
normalise globally across micro-batches; softmax and log-softmax run in
f32 whatever the activation dtype.
"""

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def next_token_labels(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The token each position predicts: the batch's `labels` when the
    train engine formed them from whole rows before sharding them over sp
    (a sequence shard's last position predicts the next shard's first
    token), else the next token of the row (`input_ids` rolled by one; the
    last position wraps to the first, where no loss is taken)."""
    labels = batch.get("labels")
    return labels if labels is not None else torch.roll(batch["input_ids"], -1, dims=-1)


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


def _chunk_len(n: int, target: int) -> int:
    """The largest chunk length <= target that divides n."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def _clamped_entropy(logits: torch.Tensor, entropy_clamp: float) -> torch.Tensor:
    """Entropy of the policy renormalised over the top (1 - entropy_clamp)
    fraction of the vocabulary: the bottom tail is masked out before the
    softmax (the AEnt recipe's clamped softmax entropy), so an entropy bonus
    cannot be farmed by spreading mass over junk tokens.

    The threshold is the keep-th largest logit of each row, found as the
    (V - keep + 1)-th smallest by `torch.kthvalue` (JAX takes `top_k`,
    whose [tokens, keep] indices at a 151,936-token vocab would be
    gigabytes a chunk); `logits >= kth` keeps ties exactly as JAX does.
    Gradients flow through the masked softmax only: the mask carries none."""
    V = logits.shape[-1]
    keep = max(1, V - int(V * entropy_clamp))
    with torch.no_grad():
        kth = torch.kthvalue(logits, V - keep + 1, dim=-1, keepdim=True).values
        mask = logits >= kth
    clamped = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    logz = torch.logsumexp(clamped, dim=-1)
    p = torch.softmax(clamped, dim=-1)
    return logz - torch.where(mask, p * logits, 0.0).sum(dim=-1)


def _head_chunk(hc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                cap: Optional[float], inv_t: float, with_entropy: bool,
                entropy_grad: bool, entropy_clamp: float = 0.0):
    """One token chunk of the chunked head: (logprobs, entropy, correct)."""
    logits = (hc @ head).float()
    if cap:
        # the final softcap is part of the model's distribution: before
        # temperature
        logits = torch.tanh(logits / cap) * cap
    logits = logits * inv_t
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lc[:, None].long())[:, 0]
    if with_entropy:
        z, lz = (logits, logz) if entropy_grad else (logits.detach(), logz.detach())
        if entropy_clamp > 0:
            ent = _clamped_entropy(z, entropy_clamp)
        else:
            ent = lz - (torch.softmax(z, dim=-1) * z).sum(dim=-1)
        corr = (logits.argmax(dim=-1) == lc).float()
    else:
        ent = corr = torch.zeros_like(logz)
    return picked - logz, ent, corr


def chunked_logprobs_entropy(
    hidden: torch.Tensor,  # [N, D]
    head: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # int [N]
    temperature: float = 1.0,
    logit_softcap: Optional[float] = None,
    chunk: int = 1024,
    with_entropy: bool = True,
    entropy_grad: bool = True,
    entropy_clamp: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The token-chunked head (JAX's `lm_logprobs_entropy` chunked path,
    there a rematerialised `lax.scan`): f32 logits of one chunk of tokens
    at a time, the softcap before temperature, each chunk recomputed in the
    backward (`torch.utils.checkpoint`), so only one chunk's [c, V] logits
    exist at once.  Chunks are the largest divisor of N up to `chunk`.
    With `entropy_clamp > 0` the entropy is `_clamped_entropy`'s.

    `entropy_grad=False` computes the entropy outside the autograd graph
    (the GRPO stats-only case), as the fused head does.  JAX's chunked
    path differentiates it regardless, which changes no gradient of a loss
    without an entropy term; here a graph that the loss's backward never
    walks would keep every chunk's recomputed logits alive for as long as
    the entropy stat is (on a 256,000-column vocab, gigabytes per chunk)."""
    N = hidden.shape[0]
    c = _chunk_len(N, chunk)
    inv_t = float(1.0 / temperature)
    parts = [
        checkpoint(_head_chunk, hidden[i:i + c], head, labels[i:i + c], logit_softcap, inv_t,
                   with_entropy, entropy_grad, entropy_clamp, use_reentrant=False)
        for i in range(0, N, c)
    ]
    return tuple(torch.cat(p) for p in zip(*parts))


def lm_logprobs_entropy(
    out,  # LMOutput (deferred head) or materialised logits [..., V]
    labels: torch.Tensor,  # int [...]
    temperature: float = 1.0,
    with_entropy: bool = True,
    entropy_grad: bool = True,
    vocab_chunk: Optional[int] = None,  # None -> AREAL_LM_HEAD_CHUNK or 8192
    chunk: int = 1024,
    entropy_clamp: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logprobs, entropy, argmax-correct) of `labels`, f32.

    With an `LMOutput` this runs the vocab-chunked fused head
    (`ops/fused_xent.py`), or, under a final-logit softcap (gemma2) or an
    entropy clamp (AEnt: a per-token threshold over the whole vocab row),
    the token-chunked head (`chunked_logprobs_entropy`, `chunk` tokens at a
    time), as the JAX package decides."""
    inv_t = float(1.0 / temperature)
    if not isinstance(out, LMOutput):
        logits = out.float() * inv_t
        logp, ent = gather_logprobs_entropy(logits, labels)
        if entropy_clamp > 0:
            ent = _clamped_entropy(logits, entropy_clamp)
        corr = (logits.argmax(dim=-1) == labels).float()
        return logp, ent, corr
    shape = labels.shape
    D = out.hidden.shape[-1]
    if out.logit_softcap is not None or entropy_clamp > 0:
        lp, ent, corr = chunked_logprobs_entropy(
            out.hidden.reshape(-1, D), out.head, labels.reshape(-1), temperature,
            out.logit_softcap, chunk, with_entropy, entropy_grad, entropy_clamp)
    else:
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
    (behaviour), advantages, and optionally prox_logp and labels
    (`next_token_labels`)."""
    labels = next_token_labels(batch)
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


def ppo_critic_loss_fn(
    values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    loss_mask: torch.Tensor,
    eps_clip_value: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped value loss: 0.5 * the masked sum of the larger of the plain
    and the clipped squared error."""
    loss_mask = loss_mask.float()
    err = (values - returns).square()
    if eps_clip_value is not None:
        clipped = old_values + torch.clamp(values - old_values, -eps_clip_value, eps_clip_value)
        err_clipped = (clipped - returns).square()
        clip_mask = err_clipped > err
        err = torch.maximum(err, err_clipped)
    else:
        clip_mask = torch.zeros_like(err, dtype=torch.bool)
    loss = 0.5 * (err * loss_mask).sum()
    return loss, {
        "value_clip_ratio": (clip_mask * loss_mask).sum(),
        "n_valid_tokens": loss_mask.sum(),
    }


def sft_loss_fn(model_out, batch: Dict[str, torch.Tensor],
                vocab_chunk: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token cross-entropy over next-token targets, a masked sum, with a
    MoE penalty weighted per valid token when the model has one."""
    mask = batch["loss_mask"].float()
    logprobs, _, correct = lm_logprobs_entropy(model_out, next_token_labels(batch),
                                               entropy_grad=False, vocab_chunk=vocab_chunk)
    loss = -(logprobs * mask).sum()
    aux = getattr(model_out, "aux_loss", None)
    if aux is not None:
        loss = loss + aux * mask.sum()
    return loss, {
        "loss_sum": loss,
        "n_valid_tokens": mask.sum(),
        "correct_tokens": (correct * mask).sum(),
    }


def pairwise_reward_loss_fn(
    chosen_scores: torch.Tensor,
    rejected_scores: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bradley-Terry pairwise loss; `pair_mask` leaves filler pairs out."""
    margin = chosen_scores - rejected_scores
    pair_mask = torch.ones_like(margin) if pair_mask is None else pair_mask.float()
    loss = -(F.logsigmoid(margin) * pair_mask).sum()
    return loss, {
        "acc": ((margin > 0) * pair_mask).sum(),
        "margin": (margin * pair_mask).sum(),
        "n_pairs": pair_mask.sum(),
    }


def dpo_loss_fn(
    policy_chosen_logp: torch.Tensor,
    policy_rejected_logp: torch.Tensor,
    ref_chosen_logp: torch.Tensor,
    ref_rejected_logp: torch.Tensor,
    beta: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Direct preference optimization loss over sequence logprobs."""
    h = beta * ((policy_chosen_logp - policy_rejected_logp)
                - (ref_chosen_logp - ref_rejected_logp))
    loss = -F.logsigmoid(h).sum()
    return loss, {"acc": (h > 0).sum().float(),
                  "n_pairs": torch.tensor(float(h.numel()), device=h.device)}
