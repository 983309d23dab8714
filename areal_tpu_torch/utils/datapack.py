"""Length bucketing and balanced micro-batch allocation (the port's copy of
`areal_tpu/utils/datapack.py`: its numpy paths, without the native
dataplane dispatch)."""

from typing import List, Optional, Sequence

import numpy as np


def ffd_allocate(sizes: Sequence[int], capacity: int, min_groups: int = 1) -> List[List[int]]:
    """First-fit-decreasing: pack items (by index) into the fewest bins of
    `capacity`, with at least `min_groups` bins.  Items larger than capacity
    get singleton bins."""
    sizes = np.asarray(sizes)
    if len(sizes) == 0:
        return [[] for _ in range(min_groups)]
    if min_groups > len(sizes):
        raise ValueError(f"cannot split {len(sizes)} items into {min_groups} non-empty groups")
    bins: List[List[int]] = []
    loads: List[int] = []
    for idx in np.argsort(-sizes, kind="stable"):
        size = int(sizes[idx])
        for b in range(len(bins)):
            if loads[b] + size <= capacity:
                bins[b].append(int(idx))
                loads[b] += size
                break
        else:
            bins.append([int(idx)])
            loads.append(size)
    while len(bins) < min_groups:
        # steal the last item of the heaviest multi-item bin
        donor = max((b for b in range(len(bins)) if len(bins[b]) > 1), key=lambda b: loads[b])
        item = bins[donor].pop()
        loads[donor] -= int(sizes[item])
        bins.append([item])
        loads.append(int(sizes[item]))
    return bins


def balanced_partition(sizes: Sequence[int], k: int) -> List[List[int]]:
    """Split items into exactly k groups minimizing the max group load
    (greedy LPT)."""
    sizes = np.asarray(sizes)
    if k <= 0:
        raise ValueError("k must be positive")
    groups: List[List[int]] = [[] for _ in range(k)]
    loads = np.zeros(k, dtype=np.int64)
    for idx in np.argsort(-sizes, kind="stable"):
        b = int(np.argmin(loads))
        groups[b].append(int(idx))
        loads[b] += int(sizes[idx])
    return groups


def allocate_balanced_mbs(sizes: Sequence[int], max_tokens_per_mb: Optional[int] = None,
                          n_mbs: int = 1) -> List[List[int]]:
    """Micro-batch allocation: FFD under a token cap when given, else an even
    LPT split into n_mbs groups."""
    if max_tokens_per_mb and max_tokens_per_mb > 0:
        return ffd_allocate(sizes, max_tokens_per_mb, min_groups=max(1, n_mbs))
    return balanced_partition(sizes, max(1, n_mbs))


def round_up_to_bucket(n: int, quantum: int, max_len: Optional[int] = None) -> int:
    """Round a length up to the next power-of-two multiple of `quantum`
    ({1,2,4,...}*quantum), capped at `max_len`.  The engine's prompt
    buckets, decode key windows and packed row lengths ride this ladder."""
    if n <= 0:
        return quantum
    bucket = quantum
    while bucket < n:
        bucket *= 2
    if max_len is not None:
        bucket = min(bucket, max_len)
    return bucket
