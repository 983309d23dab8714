"""I/O descriptors (the port's copies of `ModelRequest`, `ModelResponse`,
`FinetuneSpec`, `WeightUpdateMeta`, `SaveLoadMeta`, `StepInfo` and `RolloutStat` from
`areal_tpu/api/io_struct.py`).

Also the remote client's wire descriptors (`HttpRequest`,
`HttpGenerationResult`, `WeightUpdateRequests`).  Between processes the
port publishes weights on the "disk" path or the "transfer" path
(`WeightUpdateMeta`); the colocated loop hands them over in memory
(`engine/colocated.py`).  `SaveLoadMeta` is the descriptor of the train
engine's `save`/`load`.
"""

import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Literal, Optional

from areal_tpu_torch.api.config import GenerationHyperparameters


@dataclass
class ModelRequest:
    """One generation request travelling from a workflow to an engine."""

    rid: str = field(default_factory=lambda: str(uuid.uuid4()))
    input_ids: List[int] = field(default_factory=list)
    gconfig: GenerationHyperparameters = field(default_factory=GenerationHyperparameters)
    tokenizer: Any = None
    # VLM pixels: the wire form exists, but the port serves no VLM yet and
    # the remote client refuses a request that carries them
    pixel_values: Optional[Any] = None
    # GRPO siblings over one prompt share a group id and expected size, so
    # the client keeps them on one server
    group_id: str = ""
    group_n: int = 0
    trace_id: str = ""

    def copy(self) -> "ModelRequest":
        return ModelRequest(
            rid=self.rid,
            input_ids=list(self.input_ids),
            gconfig=self.gconfig.new(),
            tokenizer=self.tokenizer,
            pixel_values=self.pixel_values,
            group_id=self.group_id,
            group_n=self.group_n,
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
    """How fresh trainer weights reach generation servers.

    - "disk": the trainer writes an HF snapshot `path/v{version}` (staged
      in a temp dir and renamed) and the server reloads it on
      `/update_weights_from_disk`.
    - "transfer": the trainer streams its bf16 tensors in pieces of at
      most `chunk_mb` MiB to every server's `/update_weights_chunk`, the
      server assembles them on its device (`prepare`), and a `commit`
      swaps them in: live (in-flight requests decode on under the new
      weights) or, with `live_commit=False`, after aborting them.
    """

    type: Literal["disk", "transfer"] = "disk"
    path: Optional[str] = None  # the snapshot root
    chunk_mb: int = 256
    live_commit: bool = True
    experiment_name: str = ""
    trial_name: str = ""
    # disk updates only: the exact version the servers must load (None:
    # each server loads the newest v{N} snapshot)
    version: Optional[int] = None

    @classmethod
    def from_disk(cls, experiment_name: str, trial_name: str, file_root: str,
                  name: str = "default") -> "WeightUpdateMeta":
        path = os.path.join(file_root, "checkpoints", experiment_name, trial_name, name,
                            "weight_update")
        return cls(type="disk", path=path, experiment_name=experiment_name,
                   trial_name=trial_name)

    @classmethod
    def from_transfer(cls, experiment_name: str = "", trial_name: str = "",
                      chunk_mb: int = 256, live_commit: bool = True) -> "WeightUpdateMeta":
        return cls(type="transfer", chunk_mb=chunk_mb, live_commit=live_commit,
                   experiment_name=experiment_name, trial_name=trial_name)


@dataclass
class SaveLoadMeta:
    path: str
    weight_format: str = "safetensors"
    with_optim: bool = False
    tokenizer: Any = None
    processor: Any = None
    base_model_path: Optional[str] = None


@dataclass
class StepInfo:
    epoch: int
    epoch_step: int
    global_step: int
    steps_per_epoch: int


@dataclass
class RolloutStat:
    submitted: int = 0
    accepted: int = 0
    running: int = 0
    # rollouts that settled without acceptance (should_accept veto or an
    # episode failure), so submitted == accepted + rejected + running is
    # checkable at every transition
    rejected: int = 0


@dataclass
class HttpRequest:
    endpoint: str
    payload: Dict[str, Any]
    method: str = "POST"


@dataclass
class HttpGenerationResult:
    output_tokens: List[int]
    output_logprobs: List[float]
    stop_reason: str
    version: int = -1
    # prompt tokens served from resident K/V (0 until prefix reuse is ported)
    cache_hit_tokens: int = 0


@dataclass
class WeightUpdateRequests:
    requests: List[HttpRequest] = field(default_factory=list)
