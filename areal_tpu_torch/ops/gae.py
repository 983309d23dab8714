"""Generalised Advantage Estimation over padded batches and packed buffers
(the port of `areal_tpu/ops/gae.py` `gae_padded` and `gae_segments`,
reverse `lax.scan`s there): plain PyTorch reverse loops over time,
vectorised over rows.

    delta[t] = r[t] + gamma * V[t+1] - V[t]
    adv[t]   = delta[t] + gamma * lam * adv[t+1]

Positions with mask 0 (trailing padding and interior holes such as
multi-turn user tokens) freeze the carry and the bootstrap value, so each
loss token connects to the next loss token with one gamma * lam step.
"""

from typing import Optional, Tuple

import torch


def gae_padded(
    rewards: torch.Tensor,  # [B, L]
    values: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] loss mask; holes allowed
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), f32 [B, L], zero off the mask; the
    bootstrap value after the last masked token is 0 (terminal)."""
    mask = mask.float()
    rewards = rewards.float() * mask
    values = values.float() * mask
    B, L = rewards.shape
    lastgaelam = torch.zeros(B, dtype=torch.float32, device=rewards.device)
    nextvalues = torch.zeros(B, dtype=torch.float32, device=rewards.device)
    adv = torch.empty_like(rewards)
    for t in range(L - 1, -1, -1):
        m = mask[:, t]
        delta = rewards[:, t] + gamma * nextvalues - values[:, t]
        newgaelam = delta + gamma * lam * lastgaelam
        lastgaelam = m * newgaelam + (1.0 - m) * lastgaelam
        nextvalues = m * values[:, t] + (1.0 - m) * nextvalues
        adv[:, t] = lastgaelam
    adv = adv * mask
    returns = adv + values
    return adv, returns * mask


def gae_segments(
    rewards: torch.Tensor,  # [T] packed
    values: torch.Tensor,  # [T]
    segment_ids: torch.Tensor,  # [T], -1 on filler
    gamma: float,
    lam: float,
    loss_mask: Optional[torch.Tensor] = None,  # [T]; holes allowed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over a packed flat buffer: the carry and the bootstrap value
    reset to 0 where the segment id changes (each sequence ends terminal),
    filler (-1) contributes nothing, and `loss_mask` holes inside a segment
    freeze the carry as in `gae_padded`.  Returns (advantages, returns), f32
    [T], zero off the mask."""
    valid = segment_ids >= 0
    m = valid.float()
    if loss_mask is not None:
        m = m * loss_mask.float()
    rewards = rewards.float() * m
    values = values.float() * m
    # position t continues into t + 1 when both hold the same segment
    same = torch.zeros_like(m)
    same[:-1] = ((segment_ids[1:] == segment_ids[:-1]) & valid[1:]).float()
    lastgaelam = torch.zeros((), dtype=torch.float32, device=rewards.device)
    nextvalues = torch.zeros((), dtype=torch.float32, device=rewards.device)
    adv = torch.empty_like(rewards)
    for t in range(rewards.shape[0] - 1, -1, -1):
        lastgaelam = lastgaelam * same[t]
        nextvalues = nextvalues * same[t]
        delta = rewards[t] + gamma * nextvalues - values[t]
        newgaelam = delta + gamma * lam * lastgaelam
        lastgaelam = m[t] * newgaelam + (1.0 - m[t]) * lastgaelam
        nextvalues = m[t] * values[t] + (1.0 - m[t]) * nextvalues
        adv[t] = lastgaelam
    adv = adv * m
    returns = adv + values
    return adv, returns * m
