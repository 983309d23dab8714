"""I/O descriptors (the port's copies of `ModelRequest`, `ModelResponse`,
`FinetuneSpec`, `WeightUpdateMeta`, `SaveLoadMeta` and `RolloutStat` from
`areal_tpu/api/io_struct.py`).

Between processes the port publishes weights on the "disk" path only
(`WeightUpdateMeta` keeps the fields of that path, and `TorchTrainEngine`
refuses any other type); the colocated loop hands them over in memory
(`engine/colocated.py`).  `SaveLoadMeta` is the descriptor of
`save`/`load`, which come with a later slice.
"""

import uuid
from dataclasses import dataclass, field
from typing import Any, List, Literal, Optional

from areal_tpu_torch.api.config import GenerationHyperparameters


@dataclass
class ModelRequest:
    """One generation request travelling from a workflow to an engine."""

    rid: str = field(default_factory=lambda: str(uuid.uuid4()))
    input_ids: List[int] = field(default_factory=list)
    gconfig: GenerationHyperparameters = field(default_factory=GenerationHyperparameters)
    tokenizer: Any = None
    trace_id: str = ""

    def copy(self) -> "ModelRequest":
        return ModelRequest(
            rid=self.rid,
            input_ids=list(self.input_ids),
            gconfig=self.gconfig.new(),
            tokenizer=self.tokenizer,
            trace_id=self.trace_id,
        )


@dataclass
class ModelResponse:
    """Generation result; `output_versions` carries the weight version that
    produced each output token, the behaviour policy of decoupled PPO."""

    input_tokens: List[int] = field(default_factory=list)
    output_tokens: List[int] = field(default_factory=list)
    output_logprobs: List[float] = field(default_factory=list)
    output_versions: List[int] = field(default_factory=list)
    stop_reason: Literal["length", "stop", "interrupt", "abort"] = "stop"
    latency: float = float("inf")
    ttft: float = float("inf")

    @property
    def input_len(self) -> int:
        return len(self.input_tokens)

    @property
    def output_len(self) -> int:
        return len(self.output_tokens)


@dataclass
class FinetuneSpec:
    total_train_epochs: int
    dataset_size: int
    train_batch_size: int

    def __post_init__(self):
        if self.train_batch_size <= 0:
            raise ValueError(f"train_batch_size={self.train_batch_size} must be > 0")
        if self.dataset_size < self.train_batch_size:
            raise ValueError(
                f"dataset_size={self.dataset_size} < train_batch_size="
                f"{self.train_batch_size}: zero steps per epoch (drop_last)"
            )

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch

    @property
    def steps_per_epoch(self) -> int:
        return self.dataset_size // self.train_batch_size


@dataclass
class WeightUpdateMeta:
    """How fresh trainer weights reach generation servers.  "disk": the
    trainer writes an HF snapshot `path/v{version}` (staged in a temp dir
    and renamed) and the server reloads it on `/update_weights_from_disk`."""

    type: Literal["disk", "transfer"] = "disk"
    path: Optional[str] = None  # the snapshot root


@dataclass
class SaveLoadMeta:
    path: str
    weight_format: str = "safetensors"
    with_optim: bool = False
    tokenizer: Any = None
    processor: Any = None
    base_model_path: Optional[str] = None


@dataclass
class RolloutStat:
    submitted: int = 0
    accepted: int = 0
    running: int = 0
    # rollouts that settled without acceptance (should_accept veto or an
    # episode failure), so submitted == accepted + rejected + running is
    # checkable at every transition
    rejected: int = 0
