"""Ragged paged-decode attention: the wrapper of the CUDA kernel
`csrc/ragged_decode.cu` and its plain PyTorch version.

The port of `areal_tpu/ops/ragged_decode.py`.  One call is one layer's
decode (T = 1) or verify (T = D + 1) attention for the whole slot grid:
for each slot it appends the new K/V into the cache IN PLACE at `widx`
(index M drops the write), reads the slot's cache row through the page
table `rows`, and attends over the static key window K with the exact op
order of `ops/attention.py naive_attention`, reading only the pages the
slot's span covers (columns past them count as zero K/V).

`ragged_paged_attention` launches the kernel for CUDA tensors and raises
on what the kernel does not take; for CPU tensors it runs
`ragged_paged_attention_plain`.  There is no fallback between the two.
On the card one call runs the kernel's three passes over fixed chunks of
CHUNK key positions (scores, then probabilities and partial PV, then the
partials combined in chunk order; see `csrc/ragged_decode.cu`) with f32
scratch allocated here; `ragged_paged_attention.launches` counts one per
call.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops.attention import naive_attention

# dynamic shared memory a Hopper block may opt into (H100 / H200)
SMEM_LIMIT = 232448
CHUNK = 64  # key positions per block of the kernel's split-K grid

_DTYPES = (torch.float32, torch.bfloat16)


def n_chunks(key_window: int) -> int:
    """Blocks along the key axis: fixed chunks of CHUNK key positions."""
    return -(-key_window // CHUNK)


def smem_bytes(T: int, group: int, head_dim: int, kv_itemsize: int = 4) -> int:
    """Shared memory of the kernel's widest block (the scores pass): one
    chunk of cached keys, each row padded by 16 bytes, the f32 query rows
    [T*group, hd] and the chunk's f32 scores [T*group, CHUNK].  It does not
    grow with the key window."""
    R = T * group
    return CHUNK * (head_dim * kv_itemsize + 16) + 4 * R * (head_dim + CHUNK)


def scratch_floats(B: int, T: int, Hq: int, Hkv: int, head_dim: int,
                   key_window: int) -> int:
    """f32 scratch of one call: scores [B, Hkv, R, K], chunk maxima and sums
    [B, Hkv, R, chunks] each, partial outputs [B, Hkv, chunks, R, hd], with
    R = T * Hq / Hkv query rows per kv head."""
    rows = B * T * Hq  # B * Hkv * R
    nc = n_chunks(key_window)
    return rows * (key_window + 2 * nc + nc * head_dim)


def ragged_supported(max_key_window: int, num_heads: int, num_kv_heads: int,
                     head_dim: int, T: int = 1) -> bool:
    """Static gate for an engine: heads that group, a head dim of whole
    16-byte f32 vectors, and the widest block's shared memory (an f32
    cache, the larger case) inside one Hopper block.  The key window only
    sizes the scratch.  Evaluated once at engine init; an engine that fails
    it raises there."""
    return (
        max_key_window > 0
        and num_kv_heads > 0
        and num_heads % num_kv_heads == 0
        and head_dim % 8 == 0
        and smem_bytes(T, num_heads // num_kv_heads, head_dim) <= SMEM_LIMIT
    )


def _copied_end(lengths: torch.Tensor, T: int, K: int, page: int) -> torch.Tensor:
    """Per slot, the end of the columns the kernel copies: the occupied
    span [0, len + T) rounded up to whole pages, or K when the span reaches
    past the last full page (the static tail)."""
    n_full = K // page
    span = torch.clamp(lengths.long() + T, max=K)
    npages = torch.clamp((span + page - 1) // page, max=n_full)
    return torch.where(span > n_full * page, K, npages * page)


def ragged_paged_attention_plain(
    q, k_new, v_new, ck, cv, rows, lengths, widx, mask, *,
    key_window: int, page_size: int, logit_softcap: Optional[float] = None,
):
    """The kernel's function in plain PyTorch (any device).  Same
    arguments and in-place cache append as `ragged_paged_attention`."""
    B, T = q.shape[:2]
    M = ck.shape[1]
    K = min(key_window, M)
    page = min(page_size, K)
    keep = widx < M
    slot_rows = rows.long()[:, None].expand(B, T)[keep]
    ck[slot_rows, widx.long()[keep]] = k_new[keep]
    cv[slot_rows, widx.long()[keep]] = v_new[keep]
    end = _copied_end(lengths, T, K, page)
    valid = (torch.arange(K, device=q.device)[None, :] < end[:, None])[:, :, None, None]
    rl = rows.long()
    kk = torch.where(valid, ck[rl, :K], 0).to(q.dtype)
    vv = torch.where(valid, cv[rl, :K], 0).to(q.dtype)
    out = naive_attention(q, kk, vv, mask[:, None], logit_softcap)
    return out, ck, cv


@functools.cache
def _launcher():
    fn = _build.load("ragged_decode").ragged_decode_launch
    fn.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_new, v_new, ck, cv, rows, lengths, widx, mask, K) -> None:
    B, T, Hq, hd = q.shape
    S, M, Hkv, hd_c = ck.shape
    tensors = dict(q=q, k_new=k_new, v_new=v_new, ck=ck, cv=cv, rows=rows,
                   lengths=lengths, widx=widx, mask=mask)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or ck.dtype not in _DTYPES:
        raise TypeError(f"q and the cache must be float32 or bfloat16, got "
                        f"{q.dtype} and {ck.dtype}")
    for name in ("k_new", "v_new", "cv"):
        if tensors[name].dtype != ck.dtype:
            raise TypeError(f"{name} must have the cache dtype {ck.dtype} "
                            "(the caller casts before the call)")
    for name in ("rows", "lengths", "widx"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if mask.dtype != torch.bool:
        raise TypeError("mask must be bool")
    want = {
        "k_new": (B, T, Hkv, hd), "v_new": (B, T, Hkv, hd),
        "cv": (S, M, Hkv, hd), "rows": (B,), "lengths": (B,),
        "widx": (B, T), "mask": (B, T, K),
    }
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if K <= 0:
        raise ValueError(f"key window {K} must be positive")
    if hd_c != hd or Hq % Hkv or hd % 8:
        raise ValueError(f"unsupported heads: Hq={Hq} Hkv={Hkv} hd={hd} "
                         f"(cache hd {hd_c}; hd a multiple of 8)")
    need = smem_bytes(T, Hq // Hkv, hd, ck.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"{T * Hq // Hkv} query rows per kv head at hd {hd} need "
                         f"{need} bytes of shared memory per block, above {SMEM_LIMIT}")
    for name in ("ck", "cv"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel copies "
                             "16-byte vectors)")


def ragged_paged_attention(
    q: torch.Tensor,  # [B, T, Hq, hd] compute dtype (rope applied)
    k_new: torch.Tensor,  # [B, T, Hkv, hd] cache dtype (the caller casts)
    v_new: torch.Tensor,  # [B, T, Hkv, hd]
    ck: torch.Tensor,  # [S, M, Hkv, hd] one layer's keys, appended IN PLACE
    cv: torch.Tensor,  # [S, M, Hkv, hd] one layer's values, appended IN PLACE
    rows: torch.Tensor,  # int32 [B] physical cache row per slot (page table)
    lengths: torch.Tensor,  # int32 [B] cache fill per slot
    widx: torch.Tensor,  # int32 [B, T] write positions; M = drop
    mask: torch.Tensor,  # bool [B, T, K] attended cache positions
    *,
    key_window: int,  # compute width K (a bucket of the prompt ladder)
    page_size: int,  # page granularity (the prompt-bucket quantum)
    logit_softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns `(out [B, T, Hq, hd], ck, cv)`; ck and cv are the caller's
    tensors, written in place.  Rows must be distinct per slot (the page
    table guarantees it), so no two blocks write the same cache row."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_new, v_new, ck, cv, rows, lengths, widx, mask,
            key_window=key_window, page_size=page_size,
            logit_softcap=logit_softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, not {q.device}")
    B, T, Hq, hd = q.shape
    S, M, Hkv, _ = ck.shape
    K = min(key_window, M)
    page = min(page_size, K)
    _check(q, k_new, v_new, ck, cv, rows, lengths, widx, mask, K)
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_floats(B, T, Hq, Hkv, hd, K), dtype=torch.float32,
                          device=q.device)
    err = _launcher()(
        q.device.index or 0, int(q.dtype == torch.bfloat16),
        int(ck.dtype == torch.bfloat16),
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), rows.data_ptr(), lengths.data_ptr(), widx.data_ptr(),
        mask.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, T, Hq, Hkv, hd, M, K, page,
        1.0 / math.sqrt(hd), float(logit_softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ragged_decode kernel launch failed: CUDA error {err}")
    _build.count_launch(ragged_paged_attention)
    return out, ck, cv


ragged_paged_attention.launches = 0
