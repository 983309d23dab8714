"""Masked grouped-query attention (the port of `areal_tpu/ops/attention.py`
`make_attention_mask`, `naive_attention` and `segment_attention`).

Prefill attention runs `naive_attention` as it does in the JAX serving
path; it is no kernel there either.  `segment_attention` (and
`make_segment_attention`, which the model's layer loop calls) is the
training entry point: the flash kernels (`ops/flash_attention.py`) when
`flash_supported` admits the shape, as JAX takes splash when
`splash_supported` does, and `naive_attention` outside that gate.
`naive_attention`'s op order (scores in the compute
dtype, then f32, scale, optional softcap, mask to `MASK_VALUE`, softmax,
probabilities cast to the value dtype, then PV) is also the op order of
the ragged decode kernel and its plain version (`ops/ragged_decode.py`).
"""

import math
from typing import Callable, Optional

import torch

from areal_tpu_torch.ops.flash_attention import flash_supported, segment_flash_attention

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


def make_segment_attention(
    segment_ids: torch.Tensor,  # int [B, T], -1 = padding
    positions: torch.Tensor,  # int [B, T] (per-segment positions)
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """`attend(q, k, v)` for packed rows with these segment ids: the flash
    kernels when `flash_supported` admits the shape, else `naive_attention`
    over a mask built here once, so a layer loop reuses it (as JAX's
    `_backbone` builds its mask once)."""
    T = segment_ids.shape[1]
    if flash_supported(T, num_heads, num_kv_heads, head_dim):
        seg = segment_ids.to(torch.int32).contiguous()

        def attend(q, k, v):
            return segment_flash_attention(q, k, v, seg, sliding_window, logit_softcap)
    else:
        mask = make_attention_mask(segment_ids, positions, sliding_window)

        def attend(q, k, v):
            return naive_attention(q, k, v, mask, logit_softcap)
    return attend


def segment_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    segment_ids: torch.Tensor,  # int [B, T], -1 = padding
    positions: torch.Tensor,  # int [B, T] (per-segment positions)
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal segment-masked self-attention over packed rows.  Segments must
    be contiguous with positions +1 per slot (the `pack_into_rows` layout),
    so buffer-index causality equals position causality."""
    _, _, Hq, hd = q.shape
    attend = make_segment_attention(segment_ids, positions, Hq, k.shape[2], hd,
                                    sliding_window, logit_softcap)
    return attend(q, k, v)
