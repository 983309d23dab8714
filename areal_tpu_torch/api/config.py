"""Train-side configuration dataclasses (the port's copy of the train
configs in `areal_tpu/api/config.py`).

Field names and defaults are the JAX package's, for the fields the port
reads; fields of what is not ported yet (meshes, LoRA, `async_stats`, the
scan unroll, the attention implementation switch, and the fields neither
package reads) are left out, so a config that sets them fails at
construction.  The remat rungs other than `full` and `layer_group_size`
> 1 are kept and raise at `TorchTrainEngine.initialize`.  The YAML/CLI
loader (`load_expr_config`) is not copied: the card's machine has no
`yaml`, and nothing on the port's path reads a config file yet.
"""

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class OptimizerConfig:
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.001
    gradient_clipping: float = 1.0


@dataclass
class MicroBatchSpec:
    n_mbs: int = 1  # gradient-accumulation micro-batches per train_batch


@dataclass
class TrainEngineConfig:
    path: str = ""  # HF checkpoint dir
    init_from_scratch: bool = False
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master weights and optimizer state
    gradient_checkpointing: bool = True
    remat_policy: str = "full"  # only "full" is ported
    layer_group_size: int = 1  # only 1 is ported
    # fused LM-head vocab chunk width, rounded up to a multiple of 128;
    # 0 = the AREAL_LM_HEAD_CHUNK env default (8192)
    lm_head_chunk: int = 0
    mb_spec: MicroBatchSpec = field(default_factory=MicroBatchSpec)
    optimizer: Optional[OptimizerConfig] = field(default_factory=OptimizerConfig)
    # packed row lengths are power-of-two multiples of this quantum
    pack_length_quantum: int = 512
    max_pack_length: int = 32768


@dataclass
class NormConfig:
    mean_level: Optional[str] = "group"  # batch | group | none/null
    std_level: Optional[str] = "group"
    group_size: int = 1
    eps: float = 1e-5


@dataclass
class PPOActorConfig(TrainEngineConfig):
    group_size: int = 1  # answers per prompt (GRPO group)
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    eps_clip_higher: Optional[float] = None  # asymmetric clipping (DAPO)
    c_clip: Optional[float] = None  # dual clip
    temperature: float = 1.0
    group_reward_norm: bool = False
    reward_norm: Optional[NormConfig] = None
    reward_scaling: float = 1.0
    reward_bias: float = 0.0
    reward_clip: float = 20.0
    overlong_reward_penalty: bool = False
    overlong_tokens: int = 0
    overlong_penalty_factor: float = 0.0
    max_new_tokens: int = 0  # generation budget of the overlong penalty
    mask_no_eos_with_zero: bool = False
    kl_ctl: float = 0.0
    kl_estimator: str = "k1"  # k1 | k2 | k3
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: Optional[NormConfig] = field(default_factory=NormConfig)
    recompute_logprob: bool = True  # the caller runs compute_logp before updating
    use_decoupled_loss: bool = True
    behav_imp_weight_cap: Optional[float] = None
    dynamic_sampling: bool = False
