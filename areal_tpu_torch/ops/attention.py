"""Masked grouped-query attention (the port of `areal_tpu/ops/attention.py`
`make_attention_mask`, `naive_attention` and `segment_attention`).

Prefill attention runs `naive_attention` as it does in the JAX serving
path; it is no kernel there either.  `segment_attention` (and
`make_segment_attention`, which the model's layer loop calls) is the
training entry point: the flash kernels (`ops/flash_attention.py`) when
`flash_supported` admits the shape and the windows are uniform, as JAX
takes splash when `splash_supported` does, and `naive_attention` outside
that gate, under gemma2's per-layer windows and when the config's
`attn_impl` says "naive".
`naive_attention`'s op order (scores in the compute
dtype, then f32, scale, optional softcap, mask to `MASK_VALUE`, softmax,
probabilities cast to the value dtype, then PV) is also the op order of
the ragged decode kernel and its plain version (`ops/ragged_decode.py`).

Under a mesh with an sp axis > 1 (`parallel/mesh.py`) the layer loop
holds one sequence shard of each packed row, and `make_segment_attention`
is the port of `_sharded_splash`: the rank's T/sp query rows attend the
whole row's K/V.  The kv segment ids (and positions) are gathered over
sp once per forward, K and V once per layer (`distributed.seq_gather`,
whose backward sum-scatters the dK/dV partials of every shard back to
their owner), and the flash kernels run with the shard's query offset.
The naive rung and gemma2's per-layer windows mask the rank's rows
against the gathered K/V with a [Tq, Tk] mask, which is what GSPMD
makes of the JAX package's naive path when `splash_supported(..., sp)`
fails.  `attn_impl="ring"` raises there: the JAX package runs
`ring_attention`, which the port has not ported yet.
"""

import math
import warnings
from typing import Callable, Optional

import torch

from areal_tpu_torch.ops.flash_attention import flash_supported, segment_flash_attention
from areal_tpu_torch.parallel import distributed

MASK_VALUE = -2.3819763e38
ATTN_IMPLS = ("auto", "splash", "naive", "ring")


def make_attention_mask(
    segment_ids: torch.Tensor,  # [B, T] int, -1 = padding
    positions: torch.Tensor,  # [B, T] int
    sliding_window: Optional[int] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, S]; default segment_ids
    kv_positions: Optional[torch.Tensor] = None,  # [B, S]; default positions
) -> torch.Tensor:
    """-> bool [B, 1, T, S]: same segment, not padding, causal by position
    within the segment (and inside the window when one is set).  The keys
    are the queries unless `kv_segment_ids` and `kv_positions` say
    otherwise (a sequence shard's queries against the whole row)."""
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    kv_pos = positions if kv_positions is None else kv_positions
    seg_q = segment_ids[:, :, None]
    seg_k = kv_seg[:, None, :]
    same = (seg_q == seg_k) & (seg_q >= 0)
    mask = same & (kv_pos[:, None, :] <= positions[:, :, None])
    if sliding_window is not None:
        mask &= kv_pos[:, None, :] > positions[:, :, None] - sliding_window
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
    per_layer_window: bool = False,
    attn_impl: str = "auto",
    mesh=None,
) -> Callable[..., torch.Tensor]:
    """`attend(q, k, v, sliding=False)` for packed rows with these segment
    ids, the ladder JAX's `_backbone` climbs: with `per_layer_window`
    (gemma2's alternation) `naive_attention` over two masks built here
    once, the windowed one where `sliding`; else, unless `attn_impl` is
    "naive", the flash kernels when `flash_supported` admits the shape (a
    uniform window and the softcap go to the kernels); else
    `naive_attention` over one mask built once, so a layer loop reuses it.
    "auto" and "splash" both mean the flash kernels where they fit.
    Without a sequence-parallel mesh "ring" warns, as JAX does without
    one, and climbs the same ladder; with one it raises (not ported).

    Under a mesh (`parallel/mesh.py`) whose sp axis is > 1, `segment_ids`
    and `positions` are this rank's sequence shard ([B, T/sp]) and so are
    the q, k, v `attend` gets: the kv ids and positions are gathered here
    once, K and V in each `attend`, and the shard's queries attend the
    whole row (module docstring)."""
    sp = mesh.sp if mesh is not None else 1
    if attn_impl == "ring":
        if sp > 1:
            raise NotImplementedError(
                "attn_impl='ring' under an sp > 1 mesh runs the JAX package's ring_attention "
                "(areal_tpu/ops/attention.py:248), which is not ported yet (ROADMAP M9b)")
        reason = ("per-layer sliding windows (gemma2) are mask-based" if per_layer_window
                  else "the mesh has no sp>1 axis")
        warnings.warn(f"attn_impl='ring' requested but unused: {reason}; falling back to "
                      "the splash/naive ladder", stacklevel=2)
    group = mesh.groups["sp"] if sp > 1 else None
    q_start = mesh.coords["sp"] * segment_ids.shape[1] if sp > 1 else 0
    kv_seg = distributed.seq_gather(segment_ids, group)
    kv_pos = distributed.seq_gather(positions, group)
    T = kv_seg.shape[1]  # the whole row

    def gathered(k, v):
        return distributed.seq_gather(k, group), distributed.seq_gather(v, group)

    if per_layer_window:
        mask = make_attention_mask(segment_ids, positions, None, kv_seg, kv_pos)
        mask_win = make_attention_mask(segment_ids, positions, sliding_window, kv_seg, kv_pos)

        def attend(q, k, v, sliding=False):
            k, v = gathered(k, v)
            return naive_attention(q, k, v, mask_win if sliding else mask, logit_softcap)
    elif attn_impl != "naive" and flash_supported(T, num_heads, num_kv_heads, head_dim, sp):
        seg = segment_ids.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous() if sp > 1 else None

        def attend(q, k, v, sliding=False):
            k, v = gathered(k, v)
            return segment_flash_attention(q, k, v, seg, sliding_window, logit_softcap,
                                           q_start, kv_seg)
    else:
        mask = make_attention_mask(segment_ids, positions, sliding_window, kv_seg, kv_pos)

        def attend(q, k, v, sliding=False):
            k, v = gathered(k, v)
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
