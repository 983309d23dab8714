"""Decoder-only transformer (the port of `areal_tpu/models/transformer.py`):
the serving half (KV-cache prefill, suffix prefill over a cached prefix,
ragged decode) and the training half
(segment-masked forward over packed rows with a deferred LM head).

The JAX package keeps parameters as a scan-stacked pytree; the port keeps
them in an `nn.Module` whose state-dict names are the HF checkpoint names
(`model.layers.N.self_attn.q_proj.weight`, ...), with `nn.Linear`'s
[out, in] weight layout.  Weights live in `param_dtype` (the served model:
the compute dtype; the trainer: f32 masters) and are cast to the compute
dtype at each use, as JAX's `_proj` does; when the two are equal the cast
is free.

The public functions keep the JAX package's layouts, so tests compare like
with like: q is [B, T, Hq, hd], the KV cache is a dict of
[L, S, M, Hkv, hd] tensors, the page table is an int32 `rows` array, and
the deferred head is [D, V].  Unlike JAX's pure functions,
`forward_prefill`, `forward_prefill_cached` and `forward_decode` write the
cache IN PLACE (and return the same dict).

Training attention (`_backbone`, through `ops.attention`'s
`make_segment_attention`) takes the flash kernels when `flash_supported`
admits the packed row shape and `naive_attention` otherwise, the decision
JAX's `_backbone` makes with `splash_supported`.
`remat` checkpoints each layer (`torch.utils.checkpoint`, the `full` rung);
the other rungs and layer grouping raise NotImplementedError.

Covered: what Qwen2.5 and `tiny_config` use — RMSNorm, RoPE, q/k/v bias,
SwiGLU, tied or untied heads.  Other families raise NotImplementedError.
"""

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.ops.attention import (
    make_attention_mask,
    make_segment_attention,
    naive_attention,
)
from areal_tpu_torch.ops.kv_copy import copy_kv_prefix
from areal_tpu_torch.ops.ragged_decode import ragged_paged_attention

Cache = Dict[str, torch.Tensor]


def check_supported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for model families this slice does not
    serve (they come with later slices)."""
    unsupported = {
        "MoE": cfg.num_experts > 0,
        "VLM": cfg.vision is not None,
        "learned positions": cfg.pos_emb != "rope",
        "LayerNorm": cfg.norm_type != "rmsnorm",
        "non-gated MLP": not cfg.mlp_gated,
        "MLP or attention-output biases": cfg.mlp_bias or cfg.attn_output_bias,
        "sandwich norms": cfg.sandwich_norms,
        "sliding windows": cfg.sliding_window is not None,
        "logit softcaps": bool(cfg.attn_logit_softcap or cfg.final_logit_softcap),
        "qk norm": cfg.qk_norm,
        "gemma scaling": (cfg.scale_embeddings or cfg.norm_unit_offset
                          or cfg.query_pre_attn_scalar is not None),
        "activation other than silu": cfg.hidden_act != "silu",
    }
    found = [name for name, hit in unsupported.items() if hit]
    if found:
        raise NotImplementedError(
            f"the torch port does not serve {', '.join(found)} yet "
            f"({cfg.hf_architecture})"
        )


def check_trainable(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for the training knobs not ported yet: the
    remat rungs other than `full` and layer grouping."""
    check_supported(cfg)
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported; use 'full'")
    if cfg.layer_group_size > 1:
        raise NotImplementedError("layer_group_size > 1 is not ported; use 1")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm, result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, T] -> f32 cos/sin [B, T, head_dim // 2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, hd]; HF 'half rotation' convention, f32 math."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Linear(nn.Linear):
    """`nn.Linear` whose weight and bias are cast to the input's dtype at
    use (a no-op when they already match)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    """q/k/v/o projections (HF names); attention itself is the caller's."""

    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        D, hd = cfg.hidden_size, cfg.head_dim_
        self.num_heads, self.num_kv_heads, self.head_dim = cfg.num_heads, cfg.num_kv_heads, hd
        self.q_proj = Linear(D, cfg.q_size, bias=cfg.qkv_bias, dtype=dtype)
        self.k_proj = Linear(D, cfg.kv_size, bias=cfg.qkv_bias, dtype=dtype)
        self.v_proj = Linear(D, cfg.kv_size, bias=cfg.qkv_bias, dtype=dtype)
        self.o_proj = Linear(cfg.q_size, D, bias=False, dtype=dtype)

    def qkv(self, h: torch.Tensor):
        """h [B, T, D] -> q [B, T, Hq, hd], k/v [B, T, Hkv, hd]."""
        B, T = h.shape[:2]
        q = self.q_proj(h).reshape(B, T, self.num_heads, self.head_dim)
        k = self.k_proj(h).reshape(B, T, self.num_kv_heads, self.head_dim)
        v = self.v_proj(h).reshape(B, T, self.num_kv_heads, self.head_dim)
        return q, k, v


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(h)) * up(h))."""

    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(D, Fd, bias=False, dtype=dtype)
        self.up_proj = Linear(D, Fd, bias=False, dtype=dtype)
        self.down_proj = Linear(Fd, D, bias=False, dtype=dtype)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.self_attn = Attention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.mlp = MLP(cfg, dtype)

    def forward(self, x, cos, sin, attend):
        """One block; `attend(q, k, v) -> [B, T, Hq, hd]` is the path's
        attention (prefill, ragged decode, or segment attention over packed
        rows)."""
        B, T = x.shape[:2]
        q, k, v = self.self_attn.qkv(self.input_layernorm(x))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        x = x + self.self_attn.o_proj(attend(q, k, v).reshape(B, T, -1))
        return x + self.mlp(self.post_attention_layernorm(x))


class Backbone(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)


class Transformer(nn.Module):
    """The model.  `state_dict()` names are HF checkpoint names; weights are
    held in `param_dtype` (default: the compute dtype)."""

    def __init__(self, cfg: TransformerConfig, param_dtype: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        dtype = torch_dtype(param_dtype or cfg.dtype)
        self.cfg = cfg
        self.model = Backbone(cfg, dtype)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)
        )

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype."""
        return F.embedding(ids, self.model.embed_tokens.weight.to(torch_dtype(self.cfg.dtype)))

    def head(self) -> torch.Tensor:
        """The LM head [V, D] in the compute dtype."""
        w = self.model.embed_tokens.weight if self.lm_head is None else self.lm_head.weight
        return w.to(torch_dtype(self.cfg.dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + head, in the compute dtype."""
        return F.linear(self.model.norm(x), self.head())


def build_model(cfg: TransformerConfig, device: DeviceLike = None,
                param_dtype: Optional[str] = None) -> Transformer:
    """An uninitialised model on `device` (built on the meta device first,
    so no default init runs), weights in `param_dtype` (default: the
    compute dtype), gradients off."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg, param_dtype)
    return model.to_empty(device=dev).requires_grad_(False)


def init_params(cfg: TransformerConfig, seed: int = 0, device: DeviceLike = None,
                param_dtype: Optional[str] = None) -> Transformer:
    """Random model: weights normal / sqrt(fan_in) (fan_in is the input
    width of each [out, in] matrix), norms one, biases zero, drawn from a
    seeded generator on `device` (the card unless device='cpu'), held in
    `param_dtype` (default: the compute dtype)."""
    model = build_model(cfg, device, param_dtype)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                w = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
                p.copy_(w / math.sqrt(p.shape[1]))
    return model


def init_kv_cache(cfg: TransformerConfig, n_slots: int, max_len: int,
                  dtype: str = "bfloat16", device: DeviceLike = None) -> Cache:
    shape = (cfg.num_layers, n_slots, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=torch_dtype(dtype), device=dev),
        "v": torch.zeros(shape, dtype=torch_dtype(dtype), device=dev),
    }


# ---------------------------------------------------------------------------
# KV-cache forward paths (generation engine)
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward_prefill(
    model: Transformer,
    input_ids: torch.Tensor,  # [S, P] padded prompt bucket
    prompt_lens: torch.Tensor,  # [S]
    cache: Cache,
    slot_ids: torch.Tensor,  # [S] cache row each prompt row fills
) -> Tuple[torch.Tensor, Cache]:
    """Prefill prompts into cache rows `slot_ids` (written in place: K/V of
    the whole bucket [0, P)); returns (last-real-token logits [S, V], cache).
    Attention is `naive_attention` over the prompt, as in the JAX path."""
    cfg = model.cfg
    S, P = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(P, device=dev).expand(S, P)
    seg = torch.where(positions < prompt_lens[:, None], 0, -1)
    mask = make_attention_mask(seg, positions)
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    x = model.embed(input_ids)
    slot_ids = slot_ids.long()
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[slot_ids, :P] = k.to(ck.dtype)
            cv[slot_ids, :P] = v.to(cv.dtype)
            return naive_attention(q, k, v, mask)

        x = layer(x, cos, sin, attend)
    last = torch.clamp(prompt_lens.long() - 1, min=0)
    x = x[torch.arange(S, device=dev), last]
    return model.logits(x), cache


@torch.no_grad()
def forward_prefill_cached(
    model: Transformer,
    input_ids: torch.Tensor,  # [S, P] padded SUFFIX tokens
    starts: torch.Tensor,  # int [S]: cache position where each suffix begins
    suffix_lens: torch.Tensor,  # int [S]: real suffix tokens per row
    cache: Cache,
    slot_ids: torch.Tensor,  # int [S]: physical cache row of each row
    copy_src: Optional[torch.Tensor] = None,  # int [S]: prefix-KV source row
    copy_block: int = 0,  # bucketed copy length (0: no fan-out copy)
    key_window: Optional[int] = None,  # bucketed attended span
) -> Tuple[torch.Tensor, Cache]:
    """Prefill only a suffix of each row, attending over the row's cached
    prefix [0, starts) plus the causal suffix: the engine's KV prefix reuse.
    Returns (last-real-token logits [S, V], cache), the cache written in
    place.

    With `copy_src`/`copy_block`, each row's prefix K/V [0, copy_block) is
    first copied from row `copy_src[row]` (`ops.kv_copy.copy_kv_prefix`, one
    gather and one scatter per K and V), so GRPO siblings ride their
    representative's prefix in the same call; a row that reuses its own
    retained prefix passes itself as the source.  The caller guarantees
    every source row's [0, starts) is valid before the call.

    Attention reads the span [0, K), K = `key_window` (a bucketed bound on
    the deepest row's start + suffix; M when omitted), through
    `naive_attention`, as the JAX path does.  Suffix positions past the
    cache's end (padding of a row near the end) are dropped by the JAX
    scatter; here they are written into the last cache row, the engine's
    scratch row, which no real row reads."""
    cfg = model.cfg
    S, P = input_ids.shape
    dev = input_ids.device
    M = cache["k"].shape[2]
    slot_ids = slot_ids.long()
    if copy_block and copy_src is not None:
        copy_kv_prefix(cache, copy_src, slot_ids, copy_block)
    K = min(key_window, M) if key_window else M
    positions = starts.long()[:, None] + torch.arange(P, device=dev)[None, :]  # [S, P]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    x = model.embed(input_ids)
    # q at global position g attends cache positions <= g; padding rows
    # (offsets >= suffix_lens) compute values that are never read
    mask = (torch.arange(K, device=dev)[None, None, :] <= positions[:, :, None])[:, None]
    in_range = positions < M
    wrows = torch.where(in_range, slot_ids[:, None], cache["k"].shape[1] - 1)
    wpos = torch.where(in_range, positions, 0)
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[wrows, wpos] = k.to(ck.dtype)
            cv[wrows, wpos] = v.to(cv.dtype)
            kr = ck[slot_ids, :K].to(q.dtype)
            vr = cv[slot_ids, :K].to(q.dtype)
            return naive_attention(q, kr, vr, mask)

        x = layer(x, cos, sin, attend)
    last = torch.clamp(suffix_lens.long() - 1, min=0)
    x = x[torch.arange(S, device=dev), last]
    return model.logits(x), cache


@torch.no_grad()
def forward_decode(
    model: Transformer,
    tokens: torch.Tensor,  # [B] last token per slot (not yet in the cache)
    lengths: torch.Tensor,  # int32 [B] cache fill per slot
    cache: Cache,
    rows: torch.Tensor,  # int32 [B] physical cache row per slot (page table)
    *,
    page_size: int,  # page granularity of the ragged kernel
    key_window: Optional[int] = None,  # bucketed attended span K
    active: Optional[torch.Tensor] = None,  # bool [B]; False drops the write
) -> Tuple[torch.Tensor, Cache]:
    """One decode step for the slot grid; returns (logits [B, V], cache).

    Each layer's attention is one `ragged_paged_attention` call: the new
    token's K/V lands at cache position `lengths[b]` of row `rows[b]`
    (clamped to K - 1; inactive slots drop the write), and attention reads
    only the occupied pages.  On the card that is the CUDA kernel; there
    is no other decode attention path."""
    cfg = model.cfg
    B = tokens.shape[0]
    M = cache["k"].shape[2]
    K = min(key_window, M) if key_window else M
    dev = tokens.device
    positions = lengths.long()[:, None]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    x = model.embed(tokens[:, None])
    mask = (torch.arange(K, device=dev)[None, :] <= positions)[:, None, :]  # [B, 1, K]
    widx = torch.clamp(lengths, max=K - 1)
    if active is not None:
        widx = torch.where(active, widx, M)
    widx = widx.to(torch.int32)[:, None].contiguous()
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv):
            out, _, _ = ragged_paged_attention(
                q, k.to(ck.dtype), v.to(cv.dtype), ck, cv, rows, lengths,
                widx, mask, key_window=K, page_size=page_size,
                logit_softcap=cfg.attn_logit_softcap,
            )
            return out

        x = layer(x, cos, sin, attend)
    return model.logits(x[:, 0]), cache


# ---------------------------------------------------------------------------
# Training forward over packed rows
# ---------------------------------------------------------------------------


class LMOutput(NamedTuple):
    """Deferred language-model head: final-norm hidden states and the head
    matrix, so the [tokens, vocab] logits only ever exist one vocab chunk
    at a time (`ops/fused_xent.py`)."""

    hidden: torch.Tensor  # [B, T, D] in the compute dtype
    head: torch.Tensor  # [D, V] in the compute dtype (a view of [V, D])
    aux_loss: Optional[torch.Tensor] = None  # MoE penalty (dense: None)
    logit_softcap: Optional[float] = None


def _backbone(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
              segment_ids: torch.Tensor) -> torch.Tensor:
    """Layer loop -> final-norm hidden [B, T, D] in the compute dtype.

    Attention is `make_segment_attention`'s: the flash kernels when the
    packed row shape passes `flash_supported`, else `naive_attention` over
    a mask built once.  With `cfg.remat` and gradients enabled each layer
    runs under `torch.utils.checkpoint` (the `full` rung: the backward
    recomputes the layer, attention forward included)."""
    cfg = model.cfg
    check_trainable(cfg)
    x = model.embed(input_ids)
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    attend = make_segment_attention(segment_ids, positions, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim_, cfg.sliding_window, cfg.attn_logit_softcap)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.model.layers:
        if remat:
            x = checkpoint(layer, x, cos, sin, attend, use_reentrant=False)
        else:
            x = layer(x, cos, sin, attend)
    return model.model.norm(x)


def forward_hidden(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
                   segment_ids: torch.Tensor) -> torch.Tensor:
    """Backbone forward -> final-norm hidden states [B, T, D]."""
    return _backbone(model, input_ids, positions, segment_ids)


def forward(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
            segment_ids: torch.Tensor) -> torch.Tensor:
    """Full forward -> logits [B, T, V] in the compute dtype."""
    x = forward_hidden(model, input_ids, positions, segment_ids)
    return F.linear(x, model.head())


def forward_lm(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
               segment_ids: torch.Tensor) -> LMOutput:
    """Backbone forward with a deferred LM head (see LMOutput)."""
    x = _backbone(model, input_ids, positions, segment_ids)
    return LMOutput(hidden=x, head=model.head().t(),
                    logit_softcap=model.cfg.final_logit_softcap)
