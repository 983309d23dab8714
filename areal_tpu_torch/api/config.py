"""Configuration dataclasses (the port's copy of the train configs in
`areal_tpu/api/config.py`, of the generation and rollout configs the GRPO
loop reads: `GenerationHyperparameters`, `InferenceEngineConfig` with the
remote client's fields, and of the experiment configs the remote example
reads: `GenServerConfig`, `DatasetConfig`, `ClusterSpecConfig`,
`GRPOConfig`, and `PPOConfig` with its `PPOCriticConfig`), of the SFT and
reward-model experiments (`SFTConfig`, `RWConfig`), and of the training
job's infrastructure: `TimerConfig`, `SaverConfig`, `EvaluatorConfig`,
`RecoverConfig` and `StatsLoggerConfig`.

Field names and defaults are the JAX package's, for the fields the port
reads; fields of what is not ported yet (LoRA, `async_stats`, the scan
unroll, and the fields neither package reads) are left out, so a config
that sets them fails at construction.  `MeshConfig` has all five of the
JAX package's axes; the port runs dp and sp, and a config asking for
fsdp, tp or ep > 1 raises NotImplementedError at construction.  `remat_policy`,
`layer_group_size` and `attn_impl` take every value JAX takes, and
`TorchTrainEngine.initialize` rejects what JAX's engine rejects.  The YAML/CLI
loader (`load_expr_config`) is not copied: the card's machine has no
`yaml`.  The remote example (`examples/math/gsm8k_grpo.py`) builds its
`GRPOConfig` in code and takes `key.sub=value` overrides; `to_dict` is
the reference's, and `propagate_names` does what its loader does after
parsing: the experiment's names and file root fill the nested configs
that leave them empty.  `StatsLoggerConfig` has no wandb or tensorboard
fields (the port logs JSON lines only), and `RecoverConfig` has one field
the reference keeps as a constant, `keep_generations`.
"""

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Optional


@dataclass
class GenerationHyperparameters:
    """Per-request sampling config."""

    n_samples: int = 1
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    greedy: bool = False
    stop_token_ids: List[int] = field(default_factory=list)

    def new(self, **kwargs) -> "GenerationHyperparameters":
        return dataclasses.replace(self, **kwargs)


@dataclass
class InferenceEngineConfig:
    """Rollout-side config: the workflow executor's, and the remote
    client's (`core/remote.py`)."""

    # the fleet's name_resolve keys: servers and router are found under them
    experiment_name: str = ""
    trial_name: str = ""
    max_concurrent_rollouts: Optional[int] = None
    consumer_batch_size: int = 1
    max_head_offpolicyness: int = 0  # max staleness eta
    check_trajectory_format: bool = False
    schedule_policy: str = "round_robin"  # round_robin | least_requests
    setup_timeout: float = 120.0
    request_timeout: float = 3600.0
    request_retries: int = 3
    pause_grace_period: float = 0.0
    # how many times one trajectory may be resubmitted to another server
    # after a backend failure before it is declared lost, and how long a
    # failed server is kept out of re-placement
    failover_retries: int = 3
    failover_cooldown: float = 30.0


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


def check_ported_axes(fsdp: int, tp: int, ep: int) -> None:
    """Raise NotImplementedError for the mesh axes the port does not run
    yet (fsdp on FSDP2, tp and ep on DTensor: ROADMAP M9b)."""
    asked = [f"{n}={v}" for n, v in (("fsdp", fsdp), ("tp", tp), ("ep", ep)) if v > 1]
    if asked:
        raise NotImplementedError(
            f"mesh axes {', '.join(asked)} are not ported yet (ROADMAP M9b: fsdp on FSDP2, "
            "tp and ep on DTensor); the port runs dp and sp")


@dataclass
class MeshConfig:
    """How a train engine lays its ranks out as a (dp, fsdp, ep, sp, tp)
    mesh (`parallel/mesh.py`): the JAX package's fields and defaults."""

    data_parallel_size: int = 1
    fsdp_parallel_size: int = 1
    sequence_parallel_size: int = 1
    tensor_parallel_size: int = 1
    expert_parallel_size: int = 1

    def __post_init__(self):
        check_ported_axes(self.fsdp_parallel_size, self.tensor_parallel_size,
                          self.expert_parallel_size)

    @property
    def world_size(self) -> int:
        return (self.data_parallel_size * self.fsdp_parallel_size
                * self.sequence_parallel_size * self.tensor_parallel_size)


@dataclass
class TrainEngineConfig:
    path: str = ""  # HF checkpoint dir
    init_from_scratch: bool = False
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master weights and optimizer state
    gradient_checkpointing: bool = True
    # what each checkpoint keeps (models/remat.py): full | dots | save_attn |
    # save_mlp | carry_offload
    remat_policy: str = "full"
    # one checkpoint around each group of this many layers; must divide the
    # model's depth
    layer_group_size: int = 1
    # training attention, forwarded onto the model config unless that sets
    # its own: auto | splash (the flash kernels where they fit) | naive |
    # ring (not ported: raises under an sp > 1 mesh; without one it warns
    # and runs auto, as JAX does)
    attn_impl: str = "auto"
    # fused LM-head vocab chunk width, rounded up to a multiple of 128;
    # 0 = the AREAL_LM_HEAD_CHUNK env default (8192)
    lm_head_chunk: int = 0
    mb_spec: MicroBatchSpec = field(default_factory=MicroBatchSpec)
    optimizer: Optional[OptimizerConfig] = field(default_factory=OptimizerConfig)
    # packed row lengths are power-of-two multiples of this quantum (a
    # multiple of the mesh's sp size)
    pack_length_quantum: int = 512
    max_pack_length: int = 32768
    mesh: MeshConfig = field(default_factory=MeshConfig)


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


@dataclass
class PPOCriticConfig(TrainEngineConfig):
    value_eps_clip: float = 0.2
    ppo_n_minibatches: int = 4
    mask_no_eos_with_zero: bool = False


@dataclass
class GenServerConfig:
    """The generation server a launcher starts (`launcher/local.py`), with
    the flags of `python -m areal_tpu_torch.gen.server`."""

    model_path: str = ""
    dtype: str = "bfloat16"  # weights and KV cache
    max_seqs: int = 64  # continuous-batching slots
    max_context_len: int = 8192
    page_size: int = 128  # KV page and prompt bucket
    host: str = "127.0.0.1"
    port: int = 0  # 0 = pick a free port
    random_seed: int = 1
    # speculative decoding: prompt-lookup drafts verified in one dispatch;
    # the emitted streams are those of plain decode at any temperature, so
    # this is a speed knob.  spec_ladder lists the static draft-length
    # rungs; spec_draft_len > 0 pins D instead of adapting.
    spec_decode: bool = False
    spec_ladder: List[int] = field(default_factory=list)
    spec_draft_len: int = 0


@dataclass
class NameResolveConfig:
    """The rendezvous store (`utils/name_resolve.py`): memory (one process)
    or nfs (a directory the fleet shares; "" = under the temp dir).  The
    JAX package's http and etcd3 backends are not ported."""

    type: str = "memory"  # memory | nfs
    nfs_record_root: str = ""


@dataclass
class ClusterSpecConfig:
    # "" = `build/experiments` under the checkout (`examples/math/gsm8k_grpo.py`)
    fileroot: str = ""
    name_resolve: NameResolveConfig = field(default_factory=NameResolveConfig)


@dataclass
class DatasetConfig:
    path: str = ""
    type: str = ""
    batch_size: int = 1
    shuffle: bool = True
    drop_last: bool = True
    max_length: Optional[int] = None


@dataclass
class TimerConfig:
    freq_epochs: Optional[int] = None
    freq_steps: Optional[int] = None
    freq_secs: Optional[int] = None


@dataclass
class SaverConfig(TimerConfig):
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""


@dataclass
class EvaluatorConfig(TimerConfig):
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""


@dataclass
class RecoverConfig(TimerConfig):
    mode: str = "disabled"  # disabled | auto | fault | resume
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""
    retries: int = 3
    # recover generations kept on disk after a dump (the reference's
    # KEEP_GENERATIONS): the live one and, at 2, one to fall back to
    keep_generations: int = 2


@dataclass
class StatsLoggerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""


@dataclass
class GRPOConfig:
    """The GRPO experiment: the fields `examples/math/gsm8k_grpo.py`
    reads.  Left out with what they configure: the launcher's resources,
    the tokenizer path and the multi-turn and agent workflows."""

    experiment_name: str = "my-exp"
    trial_name: str = "my-trial"
    # the device split (`api/alloc.py`); its gen part's dp size is the
    # number of generation servers the launcher starts ("" = one)
    allocation_mode: str = ""
    seed: int = 1
    total_train_epochs: int = 1
    total_train_steps: Optional[int] = None
    cluster: ClusterSpecConfig = field(default_factory=ClusterSpecConfig)
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    async_training: bool = True
    # trainer -> server weight sync: "disk" (HF snapshot) or "transfer"
    # (chunks over HTTP into the servers' memory)
    weight_update_mode: str = "disk"
    # transfer only: commit without aborting in-flight generation
    weight_update_live_commit: bool = True
    gconfig: GenerationHyperparameters = field(default_factory=GenerationHyperparameters)
    rollout: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    gen_server: GenServerConfig = field(default_factory=GenServerConfig)
    actor: PPOActorConfig = field(default_factory=PPOActorConfig)
    # the frozen reference policy of the KL term (built when actor.kl_ctl > 0)
    ref: Optional[TrainEngineConfig] = None
    valid_dataset: Optional[DatasetConfig] = None
    saver: SaverConfig = field(default_factory=SaverConfig)
    checkpointer: SaverConfig = field(default_factory=SaverConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    recover: RecoverConfig = field(default_factory=RecoverConfig)
    stats_logger: StatsLoggerConfig = field(default_factory=StatsLoggerConfig)


@dataclass
class PPOConfig(GRPOConfig):
    """PPO with a learned critic: `GRPOConfig` plus the value model's
    engine (`examples/math/gsm8k_ppo.py`)."""

    critic: PPOCriticConfig = field(default_factory=PPOCriticConfig)


@dataclass
class SFTConfig:
    """Supervised finetuning (`examples/sft/gsm8k_sft.py`): the fields of
    the reference's experiment config that the SFT loop reads, and the
    model's engine."""

    experiment_name: str = "my-exp"
    trial_name: str = "my-trial"
    seed: int = 1
    total_train_epochs: int = 1
    total_train_steps: Optional[int] = None
    cluster: ClusterSpecConfig = field(default_factory=ClusterSpecConfig)
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    saver: SaverConfig = field(default_factory=SaverConfig)
    stats_logger: StatsLoggerConfig = field(default_factory=StatsLoggerConfig)
    model: TrainEngineConfig = field(default_factory=TrainEngineConfig)


@dataclass
class RWConfig(SFTConfig):
    """The Bradley-Terry reward model (`examples/rw/hhrlhf_rw.py`): the
    same fields, the model a value head over the backbone."""


def to_dict(cfg) -> Any:
    """A dataclass tree as plain dicts and lists (what the recover
    fingerprint hashes)."""
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def propagate_names(cfg, fileroot: str) -> None:
    """Fill the experiment and trial names, and `fileroot`, into every
    top-level sub-config that carries them and leaves them empty (the
    reference loader's last step)."""
    for f in fields(cfg):
        sub = getattr(cfg, f.name)
        if not is_dataclass(sub):
            continue
        for name, value in (("experiment_name", cfg.experiment_name),
                            ("trial_name", cfg.trial_name), ("fileroot", fileroot)):
            if hasattr(sub, name) and getattr(sub, name) in ("", None):
                setattr(sub, name, value)
