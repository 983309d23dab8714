"""Decoder-only transformer (the port of `areal_tpu/models/transformer.py`):
the serving half (KV-cache prefill, suffix prefill over a cached prefix,
ragged decode) and the training half
(segment-mask forward over packed rows with a deferred LM head).

The JAX package keeps parameters as a scan-stacked pytree; the port keeps
them in an `nn.Module` whose state-dict names are the HF checkpoint names
(`model.layers.N.self_attn.q_proj.weight`, ...), with `nn.Linear`'s
[out, in] weight layout.  Every family keeps Llama-style names; GPT-2's own
dialect (`transformer.h.N.*`, fused Conv1D q/k/v) is translated only when
a checkpoint is read or written (`models/hf.py`), as the JAX package does.
Weights live in `param_dtype` (the served model: the compute dtype; the
trainer: f32 masters) and are cast to the compute dtype at each use, as
JAX's `_proj` does; when the two are equal the cast is free.

The public functions keep the JAX package's layouts, so tests compare like
with like: q is [B, T, Hq, hd], the KV cache is a dict of
[L, S, M, Hkv, hd] tensors, the page table is an int32 `rows` array, and
the deferred head is [D, V].  Unlike JAX's pure functions,
`forward_prefill`, `forward_prefill_cached` and `forward_decode` write the
cache IN PLACE (and return the same dict).

The dense families' knobs, as the reference has them: RMSNorm (with
gemma's unit offset) or LayerNorm with bias; silu, tanh-gelu or exact
gelu; gated or plain (biased) MLPs; q/k/v and attention-output biases;
qwen3's qk norm before rope; gemma's embedding scale and
`query_pre_attn_scalar`; gemma2's sandwich norms, attention and final
logit softcaps and per-layer sliding windows (`layer_sliding_flags`);
mistral's uniform window; gpt2's learned positions in place of rope.

Training attention (`_backbone`, through `ops.attention`'s
`make_segment_attention`) takes the flash kernels when `flash_supported`
admits the packed row shape (head dim 128 or 256) and `naive_attention`
otherwise, and always with per-layer windows or under `attn_impl`
"naive": the decision JAX's `_backbone` makes with `splash_supported`.
`remat` puts one checkpoint around each group of `layer_group_size`
layers, keeping what the `remat_policy` rung keeps (`models/remat.py`:
`full`, `dots`, `save_attn`, `save_mlp`, `carry_offload`, on the
`attn_out` and `mlp_out` tags JAX names).  MoE, VLM and LoRA configs
raise NotImplementedError.
"""

import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from areal_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from areal_tpu_torch.models import remat
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
    """Raise NotImplementedError for the configs this port does not run
    (MoE, VLM and LoRA come with later slices)."""
    unsupported = {
        "MoE": cfg.num_experts > 0,
        "VLM": cfg.vision is not None,
        "LoRA": cfg.lora_rank > 0,
    }
    found = [name for name, hit in unsupported.items() if hit]
    if found:
        raise NotImplementedError(
            f"the torch port does not serve {', '.join(found)} yet "
            f"({cfg.hf_architecture})"
        )


def check_trainable(cfg: TransformerConfig) -> None:
    """Raise what JAX's `_backbone` raises: ValueError for an unknown remat
    rung (with remat on) and for a `layer_group_size` that does not divide
    the depth; and `check_supported`'s NotImplementedError."""
    check_supported(cfg)
    if cfg.remat:
        remat.check_rung(cfg.remat_policy)
    if cfg.num_layers % max(1, cfg.layer_group_size):
        raise ValueError(
            f"layer_group_size={cfg.layer_group_size} must divide num_layers={cfg.num_layers}: "
            "a trailing partial group would silently change the remat boundary")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """f32 RMSNorm, result in x's dtype.  `unit_offset` reads the weight as
    zero-centred (scale 1 + w), the gemma convention."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (x * w).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Mean-centred f32 LayerNorm with bias (gpt2), result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def activation(cfg: TransformerConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The MLP's activation (JAX's `_act`)."""
    if cfg.hidden_act == "silu":
        return F.silu
    if cfg.hidden_act in ("gelu_pytorch_tanh", "gelu_tanh"):
        return functools.partial(F.gelu, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu
    raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")


def rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: multiplying a tensor of
    that dtype by it equals JAX's multiply by `jnp.asarray(value, dtype)`."""
    return float(torch.tensor(value, dtype=dtype))


def layer_sliding_flags(cfg: TransformerConfig) -> List[bool]:
    """Per layer, whether it takes the sliding window (gemma2's
    alternation); all False when windows are uniform (mistral: every
    layer's mask carries the window) or absent."""
    if _per_layer_window(cfg):
        return [bool(s) for s in cfg.layer_is_sliding]
    return [False] * cfg.num_layers


def _per_layer_window(cfg: TransformerConfig) -> bool:
    return cfg.sliding_window is not None and cfg.layer_is_sliding is not None


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


def _rope(cfg: TransformerConfig, positions: torch.Tensor):
    """(cos, sin) for rope families; None for learned positions."""
    if cfg.pos_emb != "rope":
        return None
    return rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)


class Linear(nn.Linear):
    """`nn.Linear` whose weight and bias are cast to the input's dtype at
    use (a no-op when they already match)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Norm(nn.Module):
    """The config's norm (JAX's `_norm`): RMSNorm, with gemma's unit offset
    when the config says so, or LayerNorm with a bias."""

    def __init__(self, cfg: TransformerConfig, dim: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.layernorm = cfg.norm_type == "layernorm"
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype)) if self.layernorm else None
        self.eps = cfg.rms_norm_eps
        self.unit_offset = cfg.norm_unit_offset

    def forward(self, x):
        if self.layernorm:
            return layer_norm(x, self.weight, self.bias, self.eps)
        return rms_norm(x, self.weight, self.eps, self.unit_offset)


class Attention(nn.Module):
    """q/k/v/o projections (HF names) and qwen3's q/k norms; attention
    itself is the caller's."""

    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        D, hd = cfg.hidden_size, cfg.head_dim_
        self.num_heads, self.num_kv_heads, self.head_dim = cfg.num_heads, cfg.num_kv_heads, hd
        self.q_proj = Linear(D, cfg.q_size, bias=cfg.qkv_bias, dtype=dtype)
        self.k_proj = Linear(D, cfg.kv_size, bias=cfg.qkv_bias, dtype=dtype)
        self.v_proj = Linear(D, cfg.kv_size, bias=cfg.qkv_bias, dtype=dtype)
        self.o_proj = Linear(cfg.q_size, D, bias=cfg.attn_output_bias, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = Norm(cfg, hd, dtype)
            self.k_norm = Norm(cfg, hd, dtype)
        else:
            self.q_norm = self.k_norm = None
        # gemma2: kernels scale scores by hd^-0.5; pre-scaling q makes the
        # net softmax scale query_pre_attn_scalar^-0.5 (a scale of exactly
        # 1, as at Gemma-2-2B's hd 256, is skipped: multiplying by it is
        # the identity)
        self.q_scale = (None if cfg.query_pre_attn_scalar is None
                        else hd ** 0.5 / cfg.query_pre_attn_scalar ** 0.5)
        if self.q_scale == 1.0:
            self.q_scale = None

    def qkv(self, h: torch.Tensor):
        """h [B, T, D] -> q [B, T, Hq, hd], k/v [B, T, Hkv, hd] (JAX's
        `_qkv`: the q/k norms and q's pre-scale come before rope)."""
        B, T = h.shape[:2]
        q = self.q_proj(h).reshape(B, T, self.num_heads, self.head_dim)
        k = self.k_proj(h).reshape(B, T, self.num_kv_heads, self.head_dim)
        v = self.v_proj(h).reshape(B, T, self.num_kv_heads, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.q_scale is not None:
            q = q * rounded(self.q_scale, q.dtype)
        return q, k, v


class MLP(nn.Module):
    """Gated: down(act(gate(h)) * up(h)); plain (gpt2): down(act(up(h))),
    with biases when the config has them."""

    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        self.act = activation(cfg)
        bias = cfg.mlp_bias and not cfg.mlp_gated  # JAX's gated MLP has none
        self.gate_proj = Linear(D, Fd, bias=False, dtype=dtype) if cfg.mlp_gated else None
        self.up_proj = Linear(D, Fd, bias=bias, dtype=dtype)
        self.down_proj = Linear(Fd, D, bias=bias, dtype=dtype)

    def forward(self, h):
        if self.gate_proj is None:
            return self.down_proj(self.act(self.up_proj(h)))
        return self.down_proj(self.act(self.gate_proj(h)) * self.up_proj(h))


class DecoderLayer(nn.Module):
    """One block.  gemma2's sandwich layout keeps its HF names: its
    `post_attention_layernorm` normalises the attention output and
    `pre_feedforward_layernorm` is the pre-MLP norm, which the other
    families call `post_attention_layernorm`."""

    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        D = cfg.hidden_size
        self.sandwich = cfg.sandwich_norms
        self.input_layernorm = Norm(cfg, D, dtype)
        self.self_attn = Attention(cfg, dtype)
        self.post_attention_layernorm = Norm(cfg, D, dtype)
        if self.sandwich:
            self.pre_feedforward_layernorm = Norm(cfg, D, dtype)
            self.post_feedforward_layernorm = Norm(cfg, D, dtype)
        self.mlp = MLP(cfg, dtype)

    def forward(self, x, rope, attend):
        """`rope` is (cos, sin) or None (learned positions); `attend(q, k, v)
        -> [B, T, Hq, hd]` is the path's attention (prefill, ragged decode,
        or segment attention over packed rows) for this layer."""
        B, T = x.shape[:2]
        q, k, v = self.self_attn.qkv(self.input_layernorm(x))
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        with remat.tag("attn_out"):
            attn = attend(q, k, v)
        delta = self.self_attn.o_proj(attn.reshape(B, T, -1))
        if self.sandwich:
            x = x + self.post_attention_layernorm(delta)
            with remat.tag("mlp_out"):
                ffn = self.mlp(self.pre_feedforward_layernorm(x))
            return x + self.post_feedforward_layernorm(ffn)
        x = x + delta
        h = self.post_attention_layernorm(x)
        with remat.tag("mlp_out"):
            ffn = self.mlp(h)
        return x + ffn


class Backbone(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        if cfg.pos_emb == "learned":
            self.embed_positions = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.norm = Norm(cfg, cfg.hidden_size, dtype)


class Transformer(nn.Module):
    """The model.  `state_dict()` names are HF checkpoint names; weights are
    held in `param_dtype` (default: the compute dtype)."""

    def __init__(self, cfg: TransformerConfig, param_dtype: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        activation(cfg)  # an unknown activation raises here, not mid-forward
        dtype = torch_dtype(param_dtype or cfg.dtype)
        self.cfg = cfg
        self.model = Backbone(cfg, dtype)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)
        )

    def embed(self, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype (JAX's `_embed`): gemma
        multiplies by sqrt(D) rounded to the compute dtype; gpt2 adds the
        learned position rows (positions past the table, which only
        padding reaches, read its last row)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = F.embedding(ids, self.model.embed_tokens.weight.to(dtype))
        if cfg.scale_embeddings:
            x = x * rounded(cfg.hidden_size ** 0.5, dtype)
        if cfg.pos_emb == "learned":
            table = self.model.embed_positions.weight
            x = x + F.embedding(positions.clamp(max=table.shape[0] - 1), table.to(dtype))
        return x

    def head(self) -> torch.Tensor:
        """The LM head [V, D] in the compute dtype."""
        w = self.model.embed_tokens.weight if self.lm_head is None else self.lm_head.weight
        return w.to(torch_dtype(self.cfg.dtype))

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Head (+ the final softcap) over final-norm hidden states, in the
        compute dtype (JAX's `_head_logits`)."""
        logits = F.linear(x, self.head())
        cap = self.cfg.final_logit_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + head (+ the final softcap), in the compute dtype."""
        return self.head_logits(self.model.norm(x))


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
    width of each [out, in] matrix; the embedding tables' width), norms the
    identity (one, or zero for gemma's unit-offset weights), biases zero,
    drawn from a seeded generator on `device` (the card unless
    device='cpu'), held in `param_dtype` (default: the compute dtype)."""
    model = build_model(cfg, device, param_dtype)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    norm_one = 0.0 if cfg.norm_unit_offset else 1.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(norm_one)
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


def _window_masks(cfg: TransformerConfig, mask: torch.Tensor, key_pos: torch.Tensor,
                  query_pos: torch.Tensor) -> List[torch.Tensor]:
    """Each layer's mask over cache positions: `mask` (causal) narrowed to
    keys inside the window (key > query - window) on the layers that slide
    (every layer for a uniform window).  `key_pos` and `query_pos`
    broadcast against `mask`."""
    if cfg.sliding_window is None:
        return [mask] * cfg.num_layers
    win = mask & (key_pos > query_pos - cfg.sliding_window)
    if not _per_layer_window(cfg):
        return [win] * cfg.num_layers
    return [win if s else mask for s in layer_sliding_flags(cfg)]


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
    Attention is `naive_attention` over the prompt, each layer with its
    window mask and the attention softcap, as in the JAX path."""
    cfg = model.cfg
    S, P = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(P, device=dev).expand(S, P)
    seg = torch.where(positions < prompt_lens[:, None], 0, -1)
    mask = make_attention_mask(seg, positions)
    masks = _window_masks(cfg, mask, positions[:, None, None, :], positions[:, None, :, None])
    rope = _rope(cfg, positions)
    x = model.embed(input_ids, positions)
    slot_ids = slot_ids.long()
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv, m=masks[i]):
            ck[slot_ids, :P] = k.to(ck.dtype)
            cv[slot_ids, :P] = v.to(cv.dtype)
            return naive_attention(q, k, v, m, cfg.attn_logit_softcap)

        x = layer(x, rope, attend)
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
    `naive_attention` with each layer's window mask, as the JAX path does.
    Suffix positions past the cache's end (padding of a row near the end)
    are dropped by the JAX scatter; here they are written into the last
    cache row, the engine's scratch row, which no real row reads."""
    cfg = model.cfg
    S, P = input_ids.shape
    dev = input_ids.device
    M = cache["k"].shape[2]
    slot_ids = slot_ids.long()
    if copy_block and copy_src is not None:
        copy_kv_prefix(cache, copy_src, slot_ids, copy_block)
    K = min(key_window, M) if key_window else M
    positions = starts.long()[:, None] + torch.arange(P, device=dev)[None, :]  # [S, P]
    rope = _rope(cfg, positions)
    x = model.embed(input_ids, positions)
    # q at global position g attends cache positions <= g; padding rows
    # (offsets >= suffix_lens) compute values that are never read
    key_pos = torch.arange(K, device=dev)[None, None, None, :]
    query_pos = positions[:, None, :, None]
    masks = _window_masks(cfg, key_pos <= query_pos, key_pos, query_pos)  # [S, 1, P, K]
    in_range = positions < M
    wrows = torch.where(in_range, slot_ids[:, None], cache["k"].shape[1] - 1)
    wpos = torch.where(in_range, positions, 0)
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv, m=masks[i]):
            ck[wrows, wpos] = k.to(ck.dtype)
            cv[wrows, wpos] = v.to(cv.dtype)
            kr = ck[slot_ids, :K].to(q.dtype)
            vr = cv[slot_ids, :K].to(q.dtype)
            return naive_attention(q, kr, vr, m, cfg.attn_logit_softcap)

        x = layer(x, rope, attend)
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
    only the occupied pages under the layer's mask (the window, where the
    layer slides, counted over cache indices).  On the card that is the
    CUDA kernel; there is no other decode attention path."""
    cfg = model.cfg
    B = tokens.shape[0]
    M = cache["k"].shape[2]
    K = min(key_window, M) if key_window else M
    dev = tokens.device
    positions = lengths.long()[:, None]
    rope = _rope(cfg, positions)
    x = model.embed(tokens[:, None], positions)
    key_pos = torch.arange(K, device=dev)[None, None, :]
    masks = _window_masks(cfg, key_pos <= positions[:, :, None], key_pos,
                          positions[:, :, None])  # [B, 1, K]
    widx = torch.clamp(lengths, max=K - 1)
    if active is not None:
        widx = torch.where(active, widx, M)
    widx = widx.to(torch.int32)[:, None].contiguous()
    for i, layer in enumerate(model.model.layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attend(q, k, v, ck=ck, cv=cv, m=masks[i]):
            out, _, _ = ragged_paged_attention(
                q, k.to(ck.dtype), v.to(cv.dtype), ck, cv, rows, lengths,
                widx, m, key_window=K, page_size=page_size,
                logit_softcap=cfg.attn_logit_softcap,
            )
            return out

        x = layer(x, rope, attend)
    return model.logits(x[:, 0]), cache


# ---------------------------------------------------------------------------
# Training forward over packed rows
# ---------------------------------------------------------------------------


class LMOutput(NamedTuple):
    """Deferred language-model head: final-norm hidden states and the head
    matrix, so the [tokens, vocab] logits only ever exist one chunk at a
    time (`ops/fused_xent.py`, or the token-chunked head of
    `ops/functional.py` under a final softcap)."""

    hidden: torch.Tensor  # [B, T, D] in the compute dtype
    head: torch.Tensor  # [D, V] in the compute dtype (a view of [V, D])
    aux_loss: Optional[torch.Tensor] = None  # MoE penalty (dense: None)
    logit_softcap: Optional[float] = None


def _backbone(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
              segment_ids: torch.Tensor) -> torch.Tensor:
    """Layer loop -> final-norm hidden [B, T, D] in the compute dtype.

    Attention is `make_segment_attention`'s: the flash kernels when the
    packed row shape passes `flash_supported`, the windows are uniform and
    `cfg.attn_impl` is not "naive", else `naive_attention` over masks built
    once (with per-layer windows, the windowed mask on the sliding layers).
    With `cfg.remat` and gradients enabled each group of
    `cfg.layer_group_size` layers runs under one checkpoint with the
    `cfg.remat_policy` rung (`models/remat.py`; `full`: the backward
    recomputes the group, attention forward included)."""
    cfg = model.cfg
    check_trainable(cfg)
    x = model.embed(input_ids, positions)
    rope = _rope(cfg, positions)
    attend = make_segment_attention(segment_ids, positions, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim_, cfg.sliding_window, cfg.attn_logit_softcap,
                                    per_layer_window=_per_layer_window(cfg),
                                    attn_impl=cfg.attn_impl)
    layers = list(zip(model.model.layers, layer_sliding_flags(cfg)))
    G = max(1, cfg.layer_group_size)

    def run_group(x, group):
        for layer, sliding in group:
            x = layer(x, rope, functools.partial(attend, sliding=sliding))
        return x

    for i in range(0, len(layers), G):
        group = layers[i:i + G]
        if cfg.remat and torch.is_grad_enabled():
            x = remat.checkpoint(functools.partial(run_group, group=group), x,
                                 cfg.remat_policy)
        else:
            x = run_group(x, group)
    return model.model.norm(x)


def forward_hidden(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
                   segment_ids: torch.Tensor) -> torch.Tensor:
    """Backbone forward -> final-norm hidden states [B, T, D]."""
    return _backbone(model, input_ids, positions, segment_ids)


def forward(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
            segment_ids: torch.Tensor) -> torch.Tensor:
    """Full forward -> logits [B, T, V] in the compute dtype (the final
    softcap applied)."""
    return model.head_logits(forward_hidden(model, input_ids, positions, segment_ids))


def forward_packed(model: Transformer, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """`forward` over a packed dict of flat [T] buffers (`input_ids`,
    `positions`, `segment_ids`) -> logits [T, V]."""
    ids, pos, seg = (packed[k][None, :] for k in ("input_ids", "positions", "segment_ids"))
    return forward(model, ids, pos, seg)[0]


def forward_lm(model: Transformer, input_ids: torch.Tensor, positions: torch.Tensor,
               segment_ids: torch.Tensor) -> LMOutput:
    """Backbone forward with a deferred LM head (see LMOutput)."""
    x = _backbone(model, input_ids, positions, segment_ids)
    return LMOutput(hidden=x, head=model.head().t(),
                    logit_softcap=model.cfg.final_logit_softcap)
