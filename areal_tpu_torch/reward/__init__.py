"""Rule-based rewards of the port (copies of `areal_tpu/reward/`)."""

from areal_tpu_torch.reward.math_parser import (
    extract_answer,
    gsm8k_reward_fn,
    math_equal,
)

__all__ = [
    "extract_answer",
    "math_equal",
    "gsm8k_reward_fn",
]
