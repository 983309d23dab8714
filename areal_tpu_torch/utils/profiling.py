"""FLOPs and MFU accounting (the port of `areal_tpu/utils/profiling.py`
`param_count`, `train_flops_per_token` and `mfu`), with NVIDIA peaks.

The peak is the card's dense bf16 tensor-core rate from NVIDIA's data
sheets (SXM parts), looked up from `torch.cuda.get_device_name`; it assumes
the full power limit, so a card set below it reaches less.
"""

from typing import Optional

import torch

from areal_tpu_torch.models.model_config import TransformerConfig

# dense bf16 TFLOP/s by device name prefix
PEAK_TFLOPS = {
    "NVIDIA H100": 989.0,
    "NVIDIA H200": 989.0,
}


def device_peak_tflops(device: Optional[int] = None) -> Optional[float]:
    """Dense bf16 peak of a CUDA card, None for an unknown card or without
    one."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for prefix in sorted(PEAK_TFLOPS, key=len, reverse=True):
        if name.startswith(prefix):
            return PEAK_TFLOPS[prefix]
    return None


def param_count(cfg: TransformerConfig) -> int:
    """Analytic parameter count of the dense/MoE transformer."""
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    attn = D * (cfg.q_size + 2 * cfg.kv_size) + cfg.q_size * D
    if cfg.num_experts > 0:
        Fm = cfg.moe_intermediate_size or F
        ffn = cfg.num_experts * 3 * D * Fm + D * cfg.num_experts
    else:
        ffn = 3 * D * F
    embed = V * D * (1 if cfg.tie_word_embeddings else 2)
    return L * (attn + ffn + 2 * D) + embed + D


def train_flops_per_token(cfg: TransformerConfig, ctx_len: int) -> float:
    """fwd+bwd FLOPs per trained token: 6P (active params only for MoE)
    plus causal attention's qk^T and pv matmuls at segment length
    `ctx_len`.  Remat recompute is not counted (model FLOPs, not hardware
    FLOPs)."""
    P = param_count(cfg)
    if cfg.num_experts > 0:
        Fm = cfg.moe_intermediate_size or cfg.intermediate_size
        dense_share = cfg.num_experts_per_tok * 3 * cfg.hidden_size * Fm
        all_experts = cfg.num_experts * 3 * cfg.hidden_size * Fm
        P = P - cfg.num_layers * (all_experts - dense_share)
    attn = 6 * cfg.num_layers * cfg.q_size * ctx_len / 2  # causal half
    return 6.0 * P + 2.0 * attn


def mfu(tokens_per_sec: float, cfg: TransformerConfig, ctx_len: int, n_chips: int = 1,
        peak_tflops: Optional[float] = None) -> Optional[float]:
    peak = peak_tflops or device_peak_tflops()
    if not peak:
        return None
    achieved = tokens_per_sec * train_flops_per_token(cfg, ctx_len) / 1e12
    return achieved / (peak * n_chips)
