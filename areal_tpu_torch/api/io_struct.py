"""Trainer I/O descriptors (the port's copies of `FinetuneSpec`,
`WeightUpdateMeta` and `SaveLoadMeta` from `areal_tpu/api/io_struct.py`).

The port publishes weights on the "disk" path only: `WeightUpdateMeta`
keeps the fields of that path, and `TorchTrainEngine` refuses any other
type.  `SaveLoadMeta` is the descriptor of `save`/`load`, which come with
a later slice.
"""

from dataclasses import dataclass
from typing import Any, Literal, Optional


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
