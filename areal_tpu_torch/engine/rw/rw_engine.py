"""Bradley-Terry pairwise reward-model engine (the port of
`areal_tpu/engine/rw/rw_engine.py` `JaxRewardModelEngine`): batches
interleave (chosen, rejected) rows, a sequence's score is the value head's
output at its last token, and the loss is -log sigmoid(chosen - rejected).

Pairing needs a sequence's identity, so this engine lays out one sequence
per row instead of packing: rows of the bucketed length, most of each
padding, and the row count rounded to a multiple of n_mbs x the mesh's row
shards x 2, so that no pair straddles a shard; the rounding adds rows that
are filler from end to end (every segment id -1), whose pairs score
nothing.  The flash kernels run on this layout as on packed rows.
"""

from typing import Dict

import numpy as np
import torch

from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic
from areal_tpu_torch.ops.functional import pairwise_reward_loss_fn
from areal_tpu_torch.utils.data import RowPackedBatch


def _rw_loss(values: torch.Tensor, mb):
    """values [R, L]: rows alternate chosen / rejected, each one sequence
    (segment 0) or filler."""
    lens = (mb["segment_ids"] >= 0).sum(dim=-1)
    idx = torch.clamp(lens - 1, min=0)
    scores = torch.gather(values.float(), -1, idx[:, None])[:, 0]
    real = lens > 0  # filler rows score nothing
    return pairwise_reward_loss_fn(scores[0::2], scores[1::2],
                                   pair_mask=real[0::2] & real[1::2])


def _pair_weight(data: Dict[str, np.ndarray]) -> float:
    return float(np.sum(np.any(data["segment_ids"] >= 0, axis=-1)) // 2 or 1)


class TorchRewardModelEngine(TorchPPOCritic):
    def _prepare_rows(self, batch: Dict[str, np.ndarray], n_mbs: int):
        """One sequence per row, row index = sequence index (the
        chosen/rejected interleaving survives)."""
        if self.mesh.sp > 1:
            raise NotImplementedError("the reward model scores a row's last token: its rows "
                                      "are not sharded over sp")
        mask = batch["attention_mask"].astype(bool)
        B, L = mask.shape
        row_len = self._row_len(batch)
        mult = n_mbs * self.mesh.row_shards * 2  # pairs never straddle a shard
        R = -(-B // mult) * mult
        lens = mask.sum(-1).astype(np.int32)
        if lens.max(initial=0) > row_len:
            raise ValueError(f"sequence of length {int(lens.max())} exceeds max_pack_length "
                             f"bucket {row_len}")
        data = {}
        for k, arr in batch.items():
            if k == "attention_mask" or not (arr.ndim >= 2 and arr.shape[:2] == (B, L)):
                continue
            buf = np.zeros((R, row_len, *arr.shape[2:]), arr.dtype)
            for i in range(B):  # a copy a sequence: L may exceed row_len
                buf[i, :lens[i]] = arr[i, :lens[i]]
            data[k] = buf
        seg = np.full((R, row_len), -1, np.int32)
        pos = np.zeros((R, row_len), np.int32)
        for i in range(B):
            seg[i, :lens[i]] = 0
            pos[i, :lens[i]] = np.arange(lens[i])
        data["segment_ids"] = seg
        data["positions"] = pos
        data["input_ids"] = data["input_ids"].astype(np.int32)
        data["labels"] = np.roll(data["input_ids"], -1, axis=-1)
        placements = [[(i, int(lens[i]))] if i < B else [] for i in range(R)]
        return RowPackedBatch(data=data, placements=placements, row_len=row_len), data, row_len

    @staticmethod
    def _pair_stats(stats: Dict[str, float]) -> Dict[str, float]:
        stats["acc"] = stats.get("acc", 0.0) / max(stats.get("n_pairs", 1.0), 1.0)
        return stats

    def train_rw(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if batch["attention_mask"].shape[0] % 2:
            raise ValueError("reward batches must interleave chosen/rejected pairs")
        return self._pair_stats(self.train_batch(batch, _rw_loss, _pair_weight))

    def evaluate_rw(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._pair_stats(self.eval_batch(batch, _rw_loss, _pair_weight))
