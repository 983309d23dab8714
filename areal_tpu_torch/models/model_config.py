"""Model architecture config (the port's copy of
`areal_tpu/models/model_config.py`, which is framework-free).

One frozen dataclass covers the decoder-only families the reference parses
from HF `config.json`: llama/mistral, qwen2, qwen3, gemma, gemma2 and gpt2,
with the MoE and vision fields as the reference has them and its LoRA
rank.  The copy
keeps `TransformerConfig` with its HF interop (`from_hf`, `to_hf_dict`) and
the `tiny_config`/`qwen25_1p5b` presets, and of the training knobs the
remat rungs, the layer grouping and the attention implementation (the
scan unroll has no counterpart: eager PyTorch runs no scan; MoE capacity
comes with a later slice).  The served model holds its weights in the
compute `dtype`; the trainer holds f32 masters (the `param_dtype` argument
of the model builders, not a config field) and casts them to `dtype` at
each use.  The port's model raises `NotImplementedError` on MoE, VLM and
LoRA configs.
"""

import json
import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class VisionConfig:
    """ViT vision tower (Qwen2-VL family shape: patchified pixels in,
    spatially-merged embeddings at the text width out)."""

    patch_size: int = 14
    temporal_patch_size: int = 2
    in_channels: int = 3
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    spatial_merge_size: int = 2  # 2x2 patches -> one embedding
    out_hidden_size: int = 4096  # text model width
    rms_norm_eps: float = 1e-6
    # Qwen2.5-VL windowed attention: blocks NOT in fullatt_block_indexes
    # attend only within window_size x window_size pixel tiles of their
    # image.  window_size == 0 means full attention in every block
    # (Qwen2-VL behavior).
    window_size: int = 0
    fullatt_block_indexes: tuple = ()

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def replace(self, **kw) -> "VisionConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # qwen2
    qk_norm: bool = False  # qwen3
    attn_logit_softcap: Optional[float] = None  # gemma2
    sliding_window: Optional[int] = None
    # per-layer attention kinds (gemma2/3 alternate sliding/full): tuple of
    # bools, True = this layer uses the sliding window.  None = uniform
    # (every layer slides iff sliding_window is set, the mistral behavior).
    layer_is_sliding: Optional[tuple] = None

    # gemma-family structure knobs (reference keeps a gemma converter,
    # realhf/api/from_hf/gemma.py; defaults reproduce the llama family)
    hidden_act: str = "silu"  # silu | gelu_pytorch_tanh | gelu
    scale_embeddings: bool = False  # multiply embeds by sqrt(hidden_size)
    norm_unit_offset: bool = False  # RMSNorm weight stored zero-centered
    sandwich_norms: bool = False  # gemma2: extra norms on attn/ffn outputs
    final_logit_softcap: Optional[float] = None  # gemma2 lm-head tanh cap
    query_pre_attn_scalar: Optional[float] = None  # softmax scale = qpas^-0.5

    # gpt2-family structure knobs (reference: realhf/api/from_hf/gpt2.py)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm (mean-centred + bias)
    pos_emb: str = "rope"  # rope | learned (wpe table added to embeds)
    mlp_gated: bool = True  # False: w_up -> act -> w_down (no gate branch)
    attn_output_bias: bool = False  # bias on the attention out-projection
    mlp_bias: bool = False  # biases on the MLP projections

    # MoE (mixtral / qwen3-moe); num_experts == 0 means dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    moe_impl: str = "capacity"  # capacity | dropless

    # LoRA (0 = off); the port refuses adapted configs
    lora_rank: int = 0

    # numerics: compute/activation dtype (also the served weights' dtype)
    dtype: str = "bfloat16"
    remat: bool = True  # checkpoint each layer (or layer group) in the training forward
    # what a checkpoint keeps (models/remat.py): "full" nothing; "dots" the
    # projections' products; "save_attn" / "save_mlp" the tagged attention /
    # MLP output; "carry_offload" both tags, in pinned host memory
    remat_policy: str = "full"  # full | dots | save_attn | save_mlp | carry_offload
    # one checkpoint around each group of this many consecutive layers;
    # must divide num_layers
    layer_group_size: int = 1
    # training attention: "auto" and "splash" take the flash kernels where
    # flash_supported admits the shape, "naive" forces naive_attention,
    # "ring" (sequence parallelism, which one card has not) warns and takes
    # the auto ladder
    attn_impl: str = "auto"  # auto | splash | naive | ring

    # vision-language (None = text-only); Qwen2-VL-style mrope: the rope
    # frequency bands are split into (temporal, height, width) sections
    vision: Optional[VisionConfig] = None
    image_token_id: Optional[int] = None
    mrope_section: Optional[tuple] = None  # e.g. (16, 24, 24); sums to hd/2

    # bookkeeping
    hf_architecture: str = "LlamaForCausalLM"
    bos_token_id: Optional[int] = 1
    eos_token_id: Optional[int] = 2

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim_

    def replace(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    # HF interop
    # ------------------------------------------------------------------

    @classmethod
    def from_hf(cls, path_or_dict) -> "TransformerConfig":
        """Build from an HF `config.json` (path to a checkpoint dir, a json
        file, or an already-parsed dict)."""
        if isinstance(path_or_dict, dict):
            d = path_or_dict
        else:
            p = path_or_dict
            if os.path.isdir(p):
                p = os.path.join(p, "config.json")
            with open(p) as f:
                d = json.load(f)
        archs = d.get("architectures") or ["LlamaForCausalLM"]
        arch = archs[0]
        model_type = d.get("model_type", "llama")
        if model_type == "gpt2":
            # entirely different key names (n_embd/n_layer/...) and block
            # structure: LayerNorm, learned positions, fused-qkv Conv1D,
            # non-gated gelu MLP, biases throughout, always-tied head
            act = d.get("activation_function", "gelu_new")
            return cls(
                vocab_size=d["vocab_size"],
                hidden_size=d["n_embd"],
                intermediate_size=d.get("n_inner") or 4 * d["n_embd"],
                num_layers=d["n_layer"],
                num_heads=d["n_head"],
                num_kv_heads=d["n_head"],
                max_position_embeddings=d.get("n_positions", 1024),
                rms_norm_eps=float(d.get("layer_norm_epsilon", 1e-5)),
                tie_word_embeddings=True,
                qkv_bias=True,
                attn_output_bias=True,
                mlp_bias=True,
                mlp_gated=False,
                norm_type="layernorm",
                pos_emb="learned",
                # pass unknown activations through: _act raises loudly for
                # unsupported ones instead of silently running gelu
                hidden_act=(
                    "gelu_pytorch_tanh" if act in ("gelu_new", "gelu_pytorch_tanh")
                    else act
                ),
                hf_architecture=arch,
                bos_token_id=d.get("bos_token_id", 50256),
                eos_token_id=d.get("eos_token_id", 50256),
            )
        qkv_bias = bool(d.get("attention_bias", False))
        qk_norm = False
        if model_type == "qwen2":
            # qwen2 HF configs carry no attention_bias flag; bias is implied
            qkv_bias = d.get("attention_bias", True)
        if model_type in ("qwen3", "qwen3_moe"):
            qkv_bias = bool(d.get("attention_bias", False))
            qk_norm = True
        gemma = model_type.startswith("gemma")
        if gemma and model_type not in ("gemma", "gemma2"):
            # gemma3+ adds qk-norm / local-rope / different layer_types
            # semantics — loading it with gemma1/2 structure would run but
            # silently produce wrong logits
            raise ValueError(
                f"unsupported gemma variant {model_type!r}: only gemma and "
                "gemma2 checkpoints are implemented"
            )
        num_layers = d["num_hidden_layers"]
        layer_is_sliding = None
        sliding_window = (
            d.get("sliding_window")
            if d.get("use_sliding_window", model_type == "mistral")
            else None
        )
        if model_type == "gemma2":
            # alternating local/global attention; HF encodes it as
            # layer_types, older configs imply sliding on even layers
            sliding_window = d.get("sliding_window")
            lt = d.get("layer_types")
            if lt is not None:
                layer_is_sliding = tuple(t == "sliding_attention" for t in lt)
            else:
                layer_is_sliding = tuple(
                    i % 2 == 0 for i in range(num_layers)
                )
            if sliding_window is None or not any(layer_is_sliding):
                # no layer actually slides: drop the window entirely so the
                # uniform-window (mistral) path can't window every layer
                layer_is_sliding = None
                sliding_window = None
        num_heads = d["num_attention_heads"]
        n_experts = d.get("num_local_experts", d.get("num_experts", 0)) or 0
        if (
            n_experts > 0
            and model_type.startswith("qwen")
            and not d.get("norm_topk_prob", False)
        ):
            # this repo's router always renormalizes top-k gates (the
            # mixtral/released-qwen-moe convention); a checkpoint trained
            # with norm_topk_prob=false has different routing semantics
            import warnings

            warnings.warn(
                "checkpoint config has norm_topk_prob=false but this "
                "runtime renormalizes top-k gates — routing semantics "
                "will diverge from the original model",
                stacklevel=2,
            )
        eos = d.get("eos_token_id", 2)
        if isinstance(eos, list):
            eos = eos[0]
        # activation key precedence per model type, matching transformers
        # >=4.57: Gemma2MLP reads config.hidden_activation (default tanh),
        # GemmaMLP reads config.hidden_act only (hidden_activation ignored,
        # legacy 'gelu' runs EXACT gelu), everything else reads hidden_act —
        # pinned by test_legacy_gemma_act_parity
        if model_type == "gemma2":
            hidden_act = d.get("hidden_activation") or "gelu_pytorch_tanh"
        elif gemma:
            hidden_act = d.get("hidden_act") or "gelu_pytorch_tanh"
        else:
            hidden_act = d.get("hidden_act") or "silu"
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d.get("intermediate_size", 4 * d["hidden_size"]),
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=d.get("num_key_value_heads", num_heads),
            head_dim=d.get("head_dim", 256 if gemma else None),
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            rope_theta=float(d.get("rope_theta", 10000.0)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
            tie_word_embeddings=bool(d.get("tie_word_embeddings", gemma)),
            qkv_bias=qkv_bias,
            qk_norm=qk_norm,
            sliding_window=sliding_window,
            layer_is_sliding=layer_is_sliding,
            hidden_act=hidden_act,
            scale_embeddings=gemma,
            norm_unit_offset=gemma,
            sandwich_norms=model_type == "gemma2",
            final_logit_softcap=(
                d.get("final_logit_softcapping")
                if model_type == "gemma2"
                else None
            ),
            attn_logit_softcap=(
                d.get("attn_logit_softcapping")
                if model_type == "gemma2"
                else None
            ),
            query_pre_attn_scalar=(
                float(d["query_pre_attn_scalar"])
                if d.get("query_pre_attn_scalar") is not None
                and model_type == "gemma2"
                else None
            ),
            num_experts=d.get("num_local_experts", d.get("num_experts", 0)) or 0,
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            # real HF MoE checkpoints (mixtral/qwen3-moe) are dropless;
            # running them through the capacity path silently drops tokens
            # under routing imbalance and makes logits batch-size-dependent
            moe_impl="dropless" if n_experts > 0 else "capacity",
            hf_architecture=arch,
            bos_token_id=d.get("bos_token_id", 1),
            eos_token_id=eos,
            # qwen2-VL-style vision config (this repo's saver emits the same
            # shape, so VLM checkpoints round-trip)
            vision=(
                VisionConfig(
                    patch_size=vd.get("patch_size", 14),
                    temporal_patch_size=vd.get("temporal_patch_size", 2),
                    in_channels=vd.get("in_channels", 3),
                    hidden_size=vd.get("hidden_size", 1280),
                    intermediate_size=vd.get("intermediate_size", 5120),
                    num_layers=vd.get("depth", vd.get("num_hidden_layers", 32)),
                    num_heads=vd.get("num_heads", 16),
                    spatial_merge_size=vd.get("spatial_merge_size", 2),
                    out_hidden_size=vd.get("out_hidden_size", d["hidden_size"]),
                    window_size=vd.get("window_size", 0) or 0,
                    fullatt_block_indexes=tuple(
                        vd.get("fullatt_block_indexes", ()) or ()
                    ),
                )
                if (vd := d.get("vision_config")) is not None
                else None
            ),
            image_token_id=d.get("image_token_id"),
            mrope_section=(
                tuple(d["rope_scaling"]["mrope_section"])
                if isinstance(d.get("rope_scaling"), dict)
                and d["rope_scaling"].get("mrope_section")
                else None
            ),
        )

    def to_hf_dict(self) -> dict:
        """Emit an HF-compatible config dict (for saving checkpoints that
        inference servers / transformers can load back)."""
        arch = self.hf_architecture
        if arch == "GPT2LMHeadModel":
            return {
                "architectures": [arch],
                "model_type": "gpt2",
                "vocab_size": self.vocab_size,
                "n_embd": self.hidden_size,
                "n_inner": self.intermediate_size,
                "n_layer": self.num_layers,
                "n_head": self.num_heads,
                "n_positions": self.max_position_embeddings,
                "n_ctx": self.max_position_embeddings,
                "layer_norm_epsilon": self.rms_norm_eps,
                "activation_function": (
                    "gelu_new" if self.hidden_act == "gelu_pytorch_tanh"
                    else self.hidden_act
                ),
                "tie_word_embeddings": True,
                "torch_dtype": "bfloat16",
                "bos_token_id": self.bos_token_id,
                "eos_token_id": self.eos_token_id,
            }
        model_type = {
            "LlamaForCausalLM": "llama",
            "Qwen2ForCausalLM": "qwen2",
            "Qwen3ForCausalLM": "qwen3",
            "MistralForCausalLM": "mistral",
            "Qwen3MoeForCausalLM": "qwen3_moe",
            "MixtralForCausalLM": "mixtral",
            "GemmaForCausalLM": "gemma",
            "Gemma2ForCausalLM": "gemma2",
        }.get(arch, "llama")
        d = {
            "architectures": [arch],
            "model_type": model_type,
            "vocab_size": self.vocab_size,
            "hidden_size": self.hidden_size,
            "intermediate_size": self.intermediate_size,
            "num_hidden_layers": self.num_layers,
            "num_attention_heads": self.num_heads,
            "num_key_value_heads": self.num_kv_heads,
            "max_position_embeddings": self.max_position_embeddings,
            "rope_theta": self.rope_theta,
            "rms_norm_eps": self.rms_norm_eps,
            "tie_word_embeddings": self.tie_word_embeddings,
            "hidden_act": self.hidden_act,
            "torch_dtype": "bfloat16",
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
        }
        if self.head_dim is not None:
            d["head_dim"] = self.head_dim
        if model_type in ("qwen2", "qwen3", "mistral", "llama", "qwen3_moe"):
            d["attention_bias"] = self.qkv_bias
        if model_type.startswith("gemma"):
            # transformers' gemma configs read hidden_activation
            d["hidden_activation"] = self.hidden_act
            d["attention_bias"] = self.qkv_bias
        if model_type == "gemma2":
            if self.query_pre_attn_scalar is not None:
                d["query_pre_attn_scalar"] = self.query_pre_attn_scalar
            if self.attn_logit_softcap is not None:
                d["attn_logit_softcapping"] = self.attn_logit_softcap
            if self.final_logit_softcap is not None:
                d["final_logit_softcapping"] = self.final_logit_softcap
            if self.sliding_window is not None:
                d["sliding_window"] = self.sliding_window
            if self.layer_is_sliding is not None:
                d["layer_types"] = [
                    "sliding_attention" if s else "full_attention"
                    for s in self.layer_is_sliding
                ]
        if self.num_experts > 0:
            key = "num_local_experts" if model_type == "mixtral" else "num_experts"
            d[key] = self.num_experts
            d["num_experts_per_tok"] = self.num_experts_per_tok
            d["norm_topk_prob"] = True  # the routing this repo computes
            if self.moe_intermediate_size is not None:
                d["moe_intermediate_size"] = self.moe_intermediate_size
        if self.sliding_window is not None and model_type != "gemma2":
            d["sliding_window"] = self.sliding_window
            d["use_sliding_window"] = True
        if self.vision is not None:
            v = self.vision
            d["vision_config"] = {
                "patch_size": v.patch_size,
                "temporal_patch_size": v.temporal_patch_size,
                "in_channels": v.in_channels,
                "hidden_size": v.hidden_size,
                "intermediate_size": v.intermediate_size,
                "depth": v.num_layers,
                "num_heads": v.num_heads,
                "spatial_merge_size": v.spatial_merge_size,
                "out_hidden_size": v.out_hidden_size,
            }
            if v.window_size:
                d["vision_config"]["window_size"] = v.window_size
                d["vision_config"]["fullatt_block_indexes"] = list(
                    v.fullatt_block_indexes
                )
            if self.image_token_id is not None:
                d["image_token_id"] = self.image_token_id
            if self.mrope_section is not None:
                d["rope_scaling"] = {
                    "type": "mrope",
                    "mrope_section": list(self.mrope_section),
                }
        return d


# Presets ------------------------------------------------------------------

def tiny_config(**kw) -> TransformerConfig:
    base = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        max_position_embeddings=512,
        dtype="float32",
        remat=False,
    )
    base.update(kw)
    return TransformerConfig(**base)


def qwen25_1p5b() -> TransformerConfig:
    """Qwen2.5-1.5B shapes — the reference's small benchmark model class
    (BASELINE.md: 1.5B R1-Distill)."""
    return TransformerConfig(
        vocab_size=151936,
        hidden_size=1536,
        intermediate_size=8960,
        num_layers=28,
        num_heads=12,
        num_kv_heads=2,
        max_position_embeddings=32768,
        rope_theta=1000000.0,
        tie_word_embeddings=True,
        qkv_bias=True,
        hf_architecture="Qwen2ForCausalLM",
    )
