"""GSM8K-style PPO with a learned critic over remote generation servers:
the port of `examples/math/gsm8k_ppo.py`.

    python -m areal_tpu_torch.examples.math.gsm8k_ppo                 # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.examples.math.gsm8k_ppo --device cpu --model tiny \\
        total_train_steps=2 async_training=false gconfig.max_new_tokens=16
    python -m areal_tpu_torch.examples.math.gsm8k_ppo --launch recover.mode=fault \\
        checkpointer.freq_steps=1 total_train_steps=3

The GRPO example's loop (`gsm8k_grpo.run`, with its servers, publish,
saver, recover and flags) with a `PPOConfig`: the critic's per-token
values are the GAE baseline of the actor's advantages, and the critic
regresses on the returns after the actor's update, on the same batch.
Each actor save writes the critic beside it (name "critic": the tied
backbone and `value_head.npy`), and every recover dump and load carries
its weights and optimizer state (`extra_engines`).  The config holds the
values of `examples/math/gsm8k_ppo.yaml`, with the gsm8k-synth problems
and random weights in place of openai/gsm8k and a checkpoint; the critic
starts from the actor's backbone unless `critic.path` is set.
"""

import dataclasses
import logging
import sys
from typing import List, Optional

from areal_tpu_torch.api.config import (
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOConfig,
    PPOCriticConfig,
)
from areal_tpu_torch.examples.math import gsm8k_grpo

MODULE = "areal_tpu_torch.examples.math.gsm8k_ppo"


def default_config() -> PPOConfig:
    """`examples/math/gsm8k_ppo.yaml`: the GRPO example's config with
    batch-level advantage normalisation and the critic's section."""
    base = gsm8k_grpo.default_config()
    config = PPOConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    config.experiment_name = "gsm8k-ppo"
    # with a learned baseline the normalisation is batch-level: the
    # estimator stays unbiased across groups
    config.actor.adv_norm = NormConfig(mean_level="batch", std_level="batch")
    config.critic = PPOCriticConfig(
        path="", init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
        ppo_n_minibatches=2, value_eps_clip=0.2, pack_length_quantum=512, max_pack_length=2048,
        mb_spec=MicroBatchSpec(n_mbs=2),
        optimizer=OptimizerConfig(lr=5e-6, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.001, weight_decay=0.01,
                                  gradient_clipping=1.0))
    return config


def parse_args(argv: Optional[List[str]] = None):
    return gsm8k_grpo.parse_args(argv, default_config)


def main(argv: Optional[List[str]] = None) -> int:
    return gsm8k_grpo.main(argv, default_config, MODULE)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
