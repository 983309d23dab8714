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
On the card the variant follows from (dtype, T, rows, hd) alone
(`variant`), two of them ONE launch with no scratch for bf16 q and cache:
- "dec": at most DEC_MAX_ROWS query rows a kv head (T * group) at a head
  dim in DEC_HEAD_DIMS, which is every family's decode (T = 1) and the
  short verifies.  A thread block cluster per (kv head, slot) splits the
  key axis into fixed chunks of CHUNK positions dealt out to its blocks by
  position; each block brings the K and V tiles of its copied chunks by
  TMA and walks them once with FlashAttention's online softmax (P
  rounded against a running maximum, within the bf16 tolerance of the
  plain version); the partials meet in fixed order through distributed
  shared memory.
- "tc": a verify (T > 1) of TC_MIN_ROWS to TC_MAX_ROWS rows a kv head at
  a head dim of at most TC_MAX_HEAD_DIM, a cluster per (kv head, slot) on
  wider tensor-core tiles.
- "passes": the rest (f32 and mixed calls, longer verifies) run the
  CUDA-core passes over the same chunks (scores, then probabilities and
  partial PV, then the partials combined in chunk order; see
  `csrc/ragged_decode.cu`) with f32 scratch allocated here.
The three sum in other orders, so in bf16 a row computed on one variant
may differ in the last bit from the same row on another.
`ragged_paged_attention.launches` counts one per call, `.launches_dec`
and `.launches_tc` the calls on those variants, and `.launches_verify`
the calls at T > 1 (a speculative verify).
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
# query rows of a kv head (T * group) each one-launch variant takes: up to
# 16 the decode kernel (one m16 tile of rows); 17 to 64 at T > 1 the
# verify kernel, whose block past 64 rows would not fit
DEC_MAX_ROWS = 16
TC_MIN_ROWS, TC_MAX_ROWS = DEC_MAX_ROWS + 1, 64
DEC_HEAD_DIMS = (64, 128, 256)  # whole 64-column panels of its TMA tiles
TC_MAX_HEAD_DIM = 256

_DTYPES = (torch.float32, torch.bfloat16)


def n_chunks(key_window: int) -> int:
    """Blocks along the key axis: fixed chunks of CHUNK key positions."""
    return -(-key_window // CHUNK)


def smem_bytes(T: int, group: int, head_dim: int, kv_itemsize: int = 4) -> int:
    """Shared memory of the CUDA-core scores pass's block, the widest of
    the passes; it does not grow with the key window: one chunk of cached
    keys, each row padded by 16 bytes, the f32 query rows [R, hd] and the
    chunk's f32 scores [R, CHUNK], R = T * group.  (The tensor-core
    one-launch variants' blocks are bounded by their rows and head dims.)"""
    R = T * group
    return CHUNK * (head_dim * kv_itemsize + 16) + 4 * R * (head_dim + CHUNK)


def scratch_floats(B: int, T: int, Hq: int, Hkv: int, head_dim: int,
                   key_window: int, tensor_cores: bool = False) -> int:
    """f32 scratch of one call.  None for the one-launch variants (both on
    the tensor cores, they keep everything on chip); on the CUDA-core
    passes scores [B, Hkv, R, K], chunk maxima and sums [B, Hkv, R,
    chunks] each, partial outputs [B, Hkv, chunks, R, hd], with R = T * Hq
    / Hkv query rows per kv head."""
    if tensor_cores:
        return 0
    rows = B * T * Hq  # B * Hkv * R
    nc = n_chunks(key_window)
    return rows * (key_window + 2 * nc + nc * head_dim)


def variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, T: int, group: int,
            head_dim: int) -> str:
    """The kernel a call runs, by (dtype, T, rows, hd) alone, as
    `ragged_decode_launch` picks it: "dec" for bf16 q and cache with at
    most DEC_MAX_ROWS query rows (T * group) a kv head at a head dim in
    DEC_HEAD_DIMS; "tc" for a bf16 verify (T > 1) of TC_MIN_ROWS to
    TC_MAX_ROWS at a head dim of at most TC_MAX_HEAD_DIM; "passes" (the
    CUDA-core passes) for the rest: f32 and mixed calls (the tensor cores
    would round f32 operands), longer verifies, other head dims."""
    R = T * group
    if q_dtype == kv_dtype == torch.bfloat16:
        if R <= DEC_MAX_ROWS and head_dim in DEC_HEAD_DIMS:
            return "dec"
        if T > 1 and TC_MIN_ROWS <= R <= TC_MAX_ROWS and head_dim <= TC_MAX_HEAD_DIM:
            return "tc"
    return "passes"


def ragged_supported(max_key_window: int, num_heads: int, num_kv_heads: int,
                     head_dim: int, T: int = 1, q_dtype: torch.dtype = torch.float32,
                     kv_dtype: torch.dtype = torch.float32) -> bool:
    """Static gate for an engine that decodes (T = 1) and verifies at up to
    T rows a slot: heads that group, a head dim of whole 16-byte vectors,
    and every call from T = 1 to T on a variant that takes it: a
    one-launch variant (`variant`), or the CUDA-core passes, whose scores
    pass must fit its shared memory at the cache's itemsize.  The key window
    only sizes the scratch.  Evaluated once at engine init; an engine that
    fails it raises there."""
    if not (max_key_window > 0 and num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and head_dim % 8 == 0):
        return False
    group = num_heads // num_kv_heads
    item = torch.empty((), dtype=kv_dtype).element_size()
    return all(variant(q_dtype, kv_dtype, t, group, head_dim) != "passes"
               or smem_bytes(t, group, head_dim, item) <= SMEM_LIMIT
               for t in range(1, T + 1))


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
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
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
    on_chip = variant(q.dtype, ck.dtype, T, Hq // Hkv, hd) != "passes"
    need = smem_bytes(T, Hq // Hkv, hd, ck.element_size())
    if not on_chip and need > SMEM_LIMIT:
        raise ValueError(f"{T * Hq // Hkv} query rows per kv head at hd {hd} need "
                         f"{need} bytes of shared memory per block, above {SMEM_LIMIT}")
    # the kernels copy 16-byte vectors: the caches always, q and the new
    # rows too on the one-launch variants
    for name in ("ck", "cv") + (("q", "k_new", "v_new") if on_chip else ()):
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
    v = variant(q.dtype, ck.dtype, T, Hq // Hkv, hd)
    out = torch.empty_like(q)
    n_scratch = scratch_floats(B, T, Hq, Hkv, hd, K, v != "passes")
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=q.device)
               if n_scratch else None)
    err = _launcher()(
        q.device.index or 0, int(q.dtype == torch.bfloat16),
        int(ck.dtype == torch.bfloat16),
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), rows.data_ptr(), lengths.data_ptr(), widx.data_ptr(),
        mask.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, T, Hq, Hkv, hd, M, S, K, page,
        1.0 / math.sqrt(hd), float(logit_softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ragged_decode kernel launch failed: CUDA error {err}")
    _build.count_launch(ragged_paged_attention, tensor_cores=v == "tc", verify=T > 1,
                        counter="launches_dec" if v == "dec" else None)
    return out, ck, cv


ragged_paged_attention.launches = ragged_paged_attention.launches_tc = 0
ragged_paged_attention.launches_dec = ragged_paged_attention.launches_verify = 0
