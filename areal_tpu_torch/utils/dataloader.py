"""Stateful batch dataloader over list-like datasets (the port's copy of
`areal_tpu/utils/dataloader.py`): deterministic per-epoch shuffling and
drop_last batching, a batch being the list of its items, and the
checkpointable iteration state (`state_dict` / `load_state_dict`) that a
recover generation stores, so a resumed run continues the epoch's order
where the dump left it.  The reference's `collate_fn` is not ported.
"""

import random
from typing import Any, Dict, Iterator, List, Sequence


class StatefulDataLoader:
    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self._batch_idx = 0  # next batch index within the epoch

    def _order(self, epoch: int) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random((self.seed, epoch).__hash__()).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Any]:
        order = self._order(self._epoch)
        n_batches = len(self)
        while self._batch_idx < n_batches:
            s = self._batch_idx * self.batch_size
            batch_idx = order[s : s + self.batch_size]
            self._batch_idx += 1
            yield [self.dataset[i] for i in batch_idx]
        self._epoch += 1
        self._batch_idx = 0

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "batch_idx": self._batch_idx}

    def load_state_dict(self, state: Dict[str, int]):
        self._epoch = state["epoch"]
        self._batch_idx = state["batch_idx"]


def cycle_dataloader(dataloader: StatefulDataLoader) -> Iterator[Any]:
    while True:
        yielded = False
        for batch in dataloader:
            yielded = True
            yield batch
        if not yielded:
            raise ValueError(
                "dataloader produced zero batches (dataset smaller than "
                "batch_size with drop_last?) — cycling would spin forever"
            )
