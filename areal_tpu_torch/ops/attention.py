"""Masked grouped-query attention in plain PyTorch (the port of
`areal_tpu/ops/attention.py` `make_attention_mask` and `naive_attention`).

Prefill attention runs `naive_attention` as it does in the JAX serving
path; it is no kernel there either.  Its op order (scores in the compute
dtype, then f32, scale, optional softcap, mask to `MASK_VALUE`, softmax,
probabilities cast to the value dtype, then PV) is also the op order of
the ragged decode kernel and its plain version (`ops/ragged_decode.py`).
"""

import math
from typing import Optional

import torch

MASK_VALUE = -2.3819763e38


def make_attention_mask(
    segment_ids: torch.Tensor,  # [B, T] int, -1 = padding
    positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """-> bool [B, 1, T, T]: same segment, not padding, causal by position
    within the segment (and inside the window when one is set)."""
    seg_q = segment_ids[:, :, None]
    seg_k = segment_ids[:, None, :]
    same = (seg_q == seg_k) & (seg_q >= 0)
    mask = same & (positions[:, None, :] <= positions[:, :, None])
    if sliding_window is not None:
        mask &= positions[:, None, :] > positions[:, :, None] - sliding_window
    return mask[:, None, :, :]


def softmax_last(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis written out (max, exp, sum, divide), the
    order `jax.nn.softmax` and the CUDA kernel both use."""
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def naive_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    mask: torch.Tensor,  # bool [B, 1, T, S] (or [B, 1, 1, T, S])
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with an f32 softmax.  Returns [B, T, Hq, hd]
    in q's dtype."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", q, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask.ndim == 4:
        mask = mask[:, :, None]  # [B, 1, 1, T, S]
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = softmax_last(scores)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, hd)
