"""Padded and row-packed batch helpers (the port's numpy copy of what the
training slice uses from `areal_tpu/utils/data.py`).

Batches are `dict[str, np.ndarray]` on the host: per-token keys are padded
[B, L] arrays beside a boolean "attention_mask" whose valid tokens form a
prefix of each row.  The train engine row-packs them (`pack_into_rows`)
into [R, row_len] rows with int32 `segment_ids` (-1 = padding) and
per-segment `positions`; segments are contiguous inside a row, which is
what the flash-attention kernels rely on.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from areal_tpu_torch.utils.datapack import allocate_balanced_mbs

MbList = List[Dict[str, np.ndarray]]


def _is_per_token(arr: np.ndarray, batch: int, seqlen: int) -> bool:
    return arr.ndim >= 2 and arr.shape[0] == batch and arr.shape[1] == seqlen


def seq_lens(batch: Dict[str, np.ndarray]) -> np.ndarray:
    if "attention_mask" in batch:
        return batch["attention_mask"].astype(np.int64).sum(-1)
    if "cu_seqlens" in batch:
        cu = batch["cu_seqlens"]
        return (cu[1:] - cu[:-1]).astype(np.int64)
    raise ValueError("batch has neither attention_mask nor cu_seqlens")


def select_rows(batch: Dict[str, np.ndarray], idx: Sequence[int]) -> Dict[str, np.ndarray]:
    idx = np.asarray(idx, dtype=np.int64)
    return {k: v[idx] if isinstance(v, np.ndarray) and v.ndim >= 1 else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# micro-batch splitting
# ---------------------------------------------------------------------------


@dataclass
class MicroBatchList:
    mbs: MbList
    groups: List[List[int]]  # original row indices per micro-batch
    forward_indices: List[int]  # flattened order rows were dispatched in

    def merge_outputs(self, outputs: List[np.ndarray]) -> np.ndarray:
        """Per-row outputs produced per micro-batch -> original batch order."""
        flat = np.concatenate(outputs, axis=0)
        inv = np.empty(len(self.forward_indices), dtype=np.int64)
        inv[np.asarray(self.forward_indices)] = np.arange(len(self.forward_indices))
        return flat[inv]


def split_padded_tensor_dict_into_mb_list(
    batch: Dict[str, np.ndarray],
    n_mbs: int = 1,
    max_tokens_per_mb: Optional[int] = None,
) -> MicroBatchList:
    """Balanced micro-batch split of a padded batch."""
    groups = allocate_balanced_mbs(seq_lens(batch), max_tokens_per_mb, n_mbs)
    groups = [sorted(g) for g in groups if g]
    mbs = [select_rows(batch, g) for g in groups]
    return MicroBatchList(mbs=mbs, groups=groups,
                          forward_indices=[i for g in groups for i in g])


# ---------------------------------------------------------------------------
# normalization / KL estimators
# ---------------------------------------------------------------------------


class Normalization:
    """Masked mean/std normalization at batch or group level."""

    def __init__(self, mean_level: Optional[str] = "batch", std_level: Optional[str] = "batch",
                 group_size: int = 1, eps: float = 1e-5):
        for lvl in (mean_level, std_level):
            if lvl not in (None, "none", "batch", "group"):
                raise ValueError(f"bad normalization level {lvl!r}")
        self.mean_level = None if mean_level in (None, "none") else mean_level
        self.std_level = None if std_level in (None, "none") else std_level
        self.group_size = group_size
        self.eps = eps

    @staticmethod
    def _masked_moments(x: np.ndarray, mask: np.ndarray, axis=None):
        cnt = np.maximum(mask.sum(axis=axis, keepdims=True), 1)
        mean = (x * mask).sum(axis=axis, keepdims=True) / cnt
        var = (((x - mean) ** 2) * mask).sum(axis=axis, keepdims=True) / cnt
        return mean, np.sqrt(var)

    def _per_group(self, x: np.ndarray, mask: np.ndarray, which: int) -> np.ndarray:
        """Group moment `which` (0 mean, 1 std), broadcast back to x."""
        B, g = x.shape[0], self.group_size
        assert B % g == 0, (B, g)
        view = (B // g, g, *x.shape[1:])
        moment = self._masked_moments(
            x.reshape(view), mask.reshape(view), axis=tuple(range(1, x.ndim + 1)))[which]
        return np.broadcast_to(
            np.repeat(moment.reshape(-1), g).reshape(B, *([1] * (x.ndim - 1))), x.shape)

    def __call__(self, x: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        if mask is None:
            mask = np.ones_like(x, dtype=np.float32)
        mask = mask.astype(np.float32)
        if self.mean_level == "batch":
            mean, _ = self._masked_moments(x, mask)
        elif self.mean_level == "group":
            mean = self._per_group(x, mask, 0)
        else:
            mean = np.zeros_like(x)
        centered = x - mean
        if self.std_level == "batch":
            _, std = self._masked_moments(x, mask)
        elif self.std_level == "group":
            std = self._per_group(x, mask, 1)
        else:
            std = None
        denom = 1.0 if std is None else std + self.eps
        return np.where(mask > 0, centered / denom, x * 0.0)


class KLEstimator:
    """k1/k2/k3 KL estimators (http://joschu.net/blog/kl-approx.html)."""

    def __init__(self, kind: str = "k1", clip: float = 20.0):
        if kind not in ("k1", "k2", "k3"):
            raise ValueError(kind)
        self.kind = kind
        self.clip = clip

    def __call__(self, logp: np.ndarray, ref_logp: np.ndarray) -> np.ndarray:
        log_ratio = np.clip(logp - ref_logp, -self.clip, self.clip)
        if self.kind == "k1":
            return log_ratio
        if self.kind == "k2":
            return 0.5 * log_ratio**2
        return np.expm1(-log_ratio) + log_ratio  # k3


# ---------------------------------------------------------------------------
# row-packed representation (the training layout)
# ---------------------------------------------------------------------------


@dataclass
class RowPackedBatch:
    """Sequences FFD-packed into fixed-length rows [R, row_len];
    `placements[r]` lists (orig_index, length) in order for row r."""

    data: Dict[str, np.ndarray]
    placements: List[List[tuple]]
    row_len: int

    @property
    def n_rows(self) -> int:
        return len(self.placements)


def pack_into_rows(
    batch: Dict[str, np.ndarray],
    row_len: int,
    rows_multiple: int = 1,
    rows_bucket_pow2: bool = False,
) -> RowPackedBatch:
    """Padded [B, L] batch -> RowPackedBatch: first-fit-decreasing over rows
    of capacity `row_len`; the row count is padded to a multiple of
    `rows_multiple` (and, with `rows_bucket_pow2`, to a power-of-two
    multiple of it) with empty rows."""
    mask = batch["attention_mask"].astype(bool)
    B, L = mask.shape
    lens = mask.sum(-1).astype(np.int64)
    if lens.max(initial=0) > row_len:
        raise ValueError(f"sequence of length {int(lens.max())} exceeds row_len {row_len}")
    rows: List[List[tuple]] = []
    space: List[int] = []
    for i in np.argsort(-lens, kind="stable"):
        n = int(lens[i])
        if n == 0:
            continue
        for r in range(len(rows)):
            if space[r] >= n:
                rows[r].append((int(i), n))
                space[r] -= n
                break
        else:
            rows.append([(int(i), n)])
            space.append(row_len - n)
    R = max(1, len(rows))
    if rows_multiple > 1:
        R = ((R + rows_multiple - 1) // rows_multiple) * rows_multiple
    if rows_bucket_pow2:
        mult = max(rows_multiple, 1)
        R = (1 << max(0, (R // mult) - 1).bit_length()) * mult
    while len(rows) < R:
        rows.append([])

    out: Dict[str, np.ndarray] = {}
    for k, arr in batch.items():
        if k == "attention_mask" or not _is_per_token(arr, B, L):
            continue
        buf = np.zeros((R, row_len, *arr.shape[2:]), dtype=arr.dtype)
        for r, row in enumerate(rows):
            ofs = 0
            for i, n in row:
                buf[r, ofs: ofs + n] = arr[i, :n]
                ofs += n
        out[k] = buf
    seg = np.full((R, row_len), -1, dtype=np.int32)
    pos = np.zeros((R, row_len), dtype=np.int32)
    for r, row in enumerate(rows):
        ofs = 0
        for s, (i, n) in enumerate(row):
            seg[r, ofs: ofs + n] = s
            pos[r, ofs: ofs + n] = np.arange(n, dtype=np.int32)
            ofs += n
    out["segment_ids"] = seg
    out["positions"] = pos
    return RowPackedBatch(data=out, placements=rows, row_len=row_len)


def unpack_rows(rp: RowPackedBatch, row_outputs: np.ndarray, batch_size: int,
                max_len: int) -> np.ndarray:
    """Per-token row outputs [R, row_len, ...] -> padded [B, max_len, ...]."""
    out = np.zeros((batch_size, max_len, *row_outputs.shape[2:]), row_outputs.dtype)
    for r, row in enumerate(rp.placements):
        ofs = 0
        for i, n in row:
            out[i, :n] = row_outputs[r, ofs: ofs + n]
            ofs += n
    return out
