"""Generalised Advantage Estimation over padded batches (the port of
`areal_tpu/ops/gae.py gae_padded`, a reverse `lax.scan` there): a plain
PyTorch reverse loop over time, vectorised over rows.

    delta[t] = r[t] + gamma * V[t+1] - V[t]
    adv[t]   = delta[t] + gamma * lam * adv[t+1]

Positions with mask 0 (trailing padding and interior holes such as
multi-turn user tokens) freeze the carry and the bootstrap value, so each
loss token connects to the next loss token with one gamma * lam step.
"""

from typing import Tuple

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
