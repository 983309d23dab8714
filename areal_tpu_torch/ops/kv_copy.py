"""Cross-slot KV prefix fan-out and device<->host prefix transfers (the
port of `areal_tpu/ops/kv_copy.py`).

GRPO samples every group as `group_size` requests over the same prompt.
The engine prefills one representative per prefix cluster and copies the
computed prefix K/V from the representative's cache row into every
sibling's row, one batched gather and one scatter per K and V for all
clusters of an admission pass, so siblings prefill only their own suffix.

- `block` (copied positions) comes from the engine's prompt-bucket ladder
  (`round_up_to_bucket`), and destination rows are padded to a power of
  two with the scratch row (a scratch-to-scratch self-copy writes the
  values it read).
- Copying a full `block >= prefix_len` needs no mask: positions in
  `[prefix_len, block)` hold the representative's (or stale) K/V, and every
  consumer writes them before attending them (the sibling's suffix prefill
  writes `[prefix_len, prefix_len + P)` before its queries run; decode
  writes position `lengths` before attending `<= lengths`).

The host tier's `gather_kv_prefix` and `scatter_kv_prefix` move one
physical row's positions `[0, block)` of every layer, `{k, v}: [L, block,
Hkv, hd]`, in the cache's dtype: the engine stages them through a pinned
host buffer, and the round trip is bit-identical.

The JAX functions are XLA gathers, slices and scatters, no Pallas kernel,
so the port's are plain torch indexing.
"""

from typing import Dict

import torch


def gather_kv_prefix(
    cache: Dict[str, torch.Tensor],  # {"k", "v"}: [L, S, M, Hkv, hd]
    row: int,  # physical cache row to extract
    block: int,  # bucketed prefix length (positions extracted)
) -> Dict[str, torch.Tensor]:
    """Cache positions [0, block) of one physical row, {key: [L, block, Hkv,
    hd]}: views into the cache, which the caller copies out (a spill or a
    handoff export) before anything writes the row again."""
    return {key: buf[:, row, :block] for key, buf in cache.items()}


def scatter_kv_prefix(
    cache: Dict[str, torch.Tensor],
    host_kv: Dict[str, torch.Tensor],  # {key: [L, block, Hkv, hd]} from a gather
    row: int,  # physical cache row to restore into
) -> Dict[str, torch.Tensor]:
    """Write a spilled prefix back into one physical row (a swap-in), in
    place; returns `cache`.  The bytes land as they were gathered: a
    swapped-in prefix attends exactly like one that never left the
    device."""
    for key, buf in cache.items():
        blk = host_kv[key]
        buf[:, row, :blk.shape[1]].copy_(blk, non_blocking=True)
    return cache


def copy_kv_prefix(
    cache: Dict[str, torch.Tensor],  # {"k", "v"}: [L, S, M, Hkv, hd]
    src_slots: torch.Tensor,  # int [d]: source cache row per destination
    dst_slots: torch.Tensor,  # int [d]: destination rows (scratch-padded)
    block: int,  # bucketed prefix length (positions copied)
) -> Dict[str, torch.Tensor]:
    """Copy cache positions [0, block) of row `src_slots[i]` into row
    `dst_slots[i]` for every layer, in place; returns `cache`.

    Every source row is gathered before any destination is written, so a
    row that is its own source (a retained prefix riding the same call)
    copies itself unchanged, and a row that is another's source is read
    before it could be written."""
    src = src_slots.long()
    dst = dst_slots.long()
    for buf in cache.values():
        blk = buf[:, src, :block]  # a gathered copy: [L, d, block, Hkv, hd]
        buf[:, dst, :block] = blk
    return cache
