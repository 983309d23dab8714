"""Segment-masked causal flash attention: the wrappers of the CUDA kernels
`csrc/flash_attention.cu` (forward, dq, dk/dv), their plain PyTorch
versions, and the autograd function that joins them.

The port of the splash-attention kernel that `areal_tpu/ops/attention.py`
builds and launches on the training and logprob path.  Per row and q head
it computes softmax(q_s k^T) v over the keys of the same segment at or
before the query (buffer-index causality, which equals position causality
for the contiguous segments `pack_into_rows` emits), inside a left window
when one is set, with an optional logit softcap tanh(s / c) * c.

Scale order.  Like splash, `segment_flash_attention` multiplies q by
1/sqrt(hd) in q's dtype before the kernel (q_s, with the constant rounded
to that dtype), and autograd carries that product's gradient.
`naive_attention` instead scales the f32 scores; in bf16 the two orders
differ by a rounding, in f32 they agree to rounding.

Padding.  Splash masks only `q_seg == kv_seg`, so its padding (-1) attends
padding; `naive_attention` gives an all-masked row a uniform average.  Here
a query or key with segment id < 0 attends nothing: its output is 0 and its
lse -inf (the log of an empty sum), and no pair touching it is visited, so
it neither sends nor receives gradient.  Valid rows agree with both
references; gradients at valid positions do not depend on pad rows.

`segment_flash_attention`, `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv`
launch the kernels for CUDA tensors and raise on what they do not take;
for CPU tensors they run the plain versions (`*_plain`), which repeat the
kernels' arithmetic (f32 products and statistics, outputs rounded once to
the input dtype).  There is no fallback between the two.  Each kernel
wrapper counts its launches in `.launches`, and by head dim (128 or 256)
in `.launches_hd`.  Every wrapper picks its kernel by dtype and head dim:
bfloat16 runs on the tensor cores (counted again in `.launches_tc`),
float32 on the CUDA cores, whose f32 products the tensor cores (TF32 at
best) could not keep.  The bf16 forward at hd 128 and 256, and dq at hd
256, run on Hopper's warpgroup products (`wgmma`) on K/V tiles that TMA
loads once for two q heads of a GQA group, in a persistent grid for the
forward; at hd 256 the bf16 dk/dv kernel runs each key tile as a thread
block cluster whose blocks split the group's q heads; `dkv_plan` picks
its size from the grid.

Query offset.  Every function here also takes `q_start` and
`kv_segment_ids`: the queries are then rows [q_start, q_start + Tq) of
packed rows whose keys k and v hold all Tk positions, causality and the
window are taken on global positions, `segment_ids` are the queries' [B,
Tq] and `kv_segment_ids` the keys' [B, Tk] (of which the queries' are the
slice).  That is one sequence-parallel shard of `_sharded_splash`
(`ops/attention.py` runs it): dq is the shard's, and dk/dv are the shard's
partials over every key (zero for keys no query of the shard sees), to be
summed across shards.  q_start = 0 with no `kv_segment_ids` is the
unsharded call, arithmetic unchanged.

`segment_flash_attention` calls the forward through one
`torch.library` custom op, `areal_torch::flash_attention` (out and lse,
with the dq and dk/dv kernels as its registered backward), so that the
remat rungs' selective checkpointing (`models/remat.py`) sees the
attention as one op whose outputs it may keep instead of launching the
forward again.

Rounding on the tensor cores.  The forward rounds P to bfloat16 before its
PV product; its l and lse still sum the f32 P.  The backward rounds P to
bfloat16 before dV = P^T dO and dS before dK = dS^T Q and dQ = dS K.  Splash
and the plain versions keep P and dS in f32.  The statistics stay f32: lse
comes from the forward and di from `attention_di`.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops import _build

HEAD_DIMS = (128, 256)  # the kernels' head dims
_DTYPES = (torch.float32, torch.bfloat16)
DKV_MAX_CLUSTER = 8  # the portable thread block cluster size
# the hd-256 dk/dv grid's aim: about two blocks for each of the H100's 132
# SMs, which hold one block each, and at most 4 q heads walked per block
DKV_MIN_BLOCKS = 256
DKV_MAX_HEADS = 4


def flash_supported(T: int, Hq: int, Hkv: int, hd: int, sp: int = 1) -> bool:
    """Shapes the kernels take; everything else runs `naive_attention`, as
    JAX's `splash_supported` sends its misfits there.  It admits packed
    training rows with T >= 256, T % (128 * sp) == 0 (each of `sp`
    sequence shards a multiple of 128 rows) and a head dim of 128 (Qwen2.5,
    Qwen3, Llama) or 256 (Gemma); splash takes any multiple of 128, so a
    head dim of 384 or more takes the naive path here where JAX would run
    splash."""
    return (T >= 256 and T % (128 * sp) == 0 and hd in HEAD_DIMS and Hkv > 0
            and Hq % Hkv == 0)


def dkv_plan(Hq: int, Hkv: int, hd: int, bf16: bool, B: int = 1, Tk: int = 64) -> int:
    """Blocks per key tile of the dk/dv kernel for [B, Tk] rows: 1, except
    in bf16 at hd 256, where a thread block cluster per key tile splits the
    GQA group's q heads.  That block holds its 64 keys, two stages of 64 q
    and dO rows and the f32 P^T hand-over (219,136 bytes): one block per
    SM.  So the cluster size S is picked by the grid: the smallest power of
    two up to DKV_MAX_CLUSTER that divides the group, leaves each block at
    most DKV_MAX_HEADS q heads to walk, and gives the grid at least
    DKV_MIN_BLOCKS blocks (or the largest such divisor).  Each block beyond
    those pays the block's fixed cost (its K/V tile, the segment scans and
    the cluster's sum) for a shorter walk.  Gemma-2B's MQA (8 heads on one)
    takes 2 on 8 rows of 1024 and 4 on 4 rows; Gemma-7B's MHA takes 1.  The
    kernel refuses a size that is not a power of two dividing the group."""
    if not (bf16 and hd == 256):
        return 1
    group = Hq // Hkv
    base = Hkv * B * -(-Tk // 64)  # blocks at one per key tile
    cluster = 1
    while (cluster < DKV_MAX_CLUSTER and group % (2 * cluster) == 0
           and (group // cluster > DKV_MAX_HEADS or base * cluster < DKV_MIN_BLOCKS)):
        cluster *= 2
    return cluster


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _allowed(segment_ids: torch.Tensor, window: Optional[int], q_start: int = 0,
             kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool [B, 1, 1, Tq, Tk] (query, key): same valid segment, key at or
    before the query's global position q_start + i, inside the window."""
    kv = segment_ids if kv_segment_ids is None else kv_segment_ids
    Tq, Tk = segment_ids.shape[1], kv.shape[1]
    qi = torch.arange(q_start, q_start + Tq, device=segment_ids.device)
    kj = torch.arange(Tk, device=segment_ids.device)
    sq, sk = segment_ids[:, :, None], kv[:, None, :]
    mask = (sq == sk) & (sq >= 0) & (kj[None, :] <= qi[:, None])
    if window:
        mask &= kj[None, :] > qi[:, None] - window
    return mask[:, None, None]


def _scores(qs, k, softcap):
    """f32 scores [B, Hkv, G, T, S] and tanh(raw / c) (None without a cap)."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    raw = torch.einsum("btkgh,bskh->bkgts", qs.reshape(B, T, Hkv, Hq // Hkv, hd).float(),
                       k.float())
    if not softcap:
        return raw, None
    t = torch.tanh(raw / softcap)
    return t * softcap, t


def _to_bkgt(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, Hq, T] -> [B, Hkv, G, T]."""
    B, Hq, T = x.shape
    return x.reshape(B, Hkv, Hq // Hkv, T)


def flash_fwd_plain(qs, k, v, segment_ids, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_start: int = 0,
                    kv_segment_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function: (out [B, Tq, Hq, hd] in q's dtype,
    lse f32 [B, Hq, Tq])."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    s, _ = _scores(qs, k, softcap)
    mask = _allowed(segment_ids, window, q_start, kv_segment_ids)
    m = torch.where(mask, s, -torch.inf).amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    lt = l.permute(0, 3, 1, 2)[..., None]  # [B, T, Hkv, G, 1]
    out = torch.where(lt > 0, o / lt, 0.0).reshape(B, T, Hq, hd).to(qs.dtype)
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf).reshape(B, Hq, T)
    return out, lse


def _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap, q_start=0,
              kv_segment_ids=None):
    """The backward's P and dS [B, Hkv, G, Tq, Tk] in f32."""
    Hkv = k.shape[2]
    B, T, Hq, hd = qs.shape
    s, t = _scores(qs, k, softcap)
    mask = _allowed(segment_ids, window, q_start, kv_segment_ids)
    p = torch.where(mask, torch.exp(s - _to_bkgt(lse, Hkv)[..., None]), 0.0)
    dp = torch.einsum("btkgh,bskh->bkgts", dout.reshape(B, T, Hkv, Hq // Hkv, hd).float(),
                      v.float())
    ds = p * (dp - _to_bkgt(di, Hkv)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def flash_bwd_dq_plain(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                       softcap: Optional[float] = None, q_start: int = 0,
                       kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dq kernel's function: d loss / d q_s [B, Tq, Hq, hd] in q's
    dtype.  `di` [B, Hq, Tq] is sum(out * dout) over hd, in f32."""
    B, T, Hq, hd = qs.shape
    _, ds = _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap, q_start,
                      kv_segment_ids)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k.float())
    return dq.reshape(B, T, Hq, hd).to(qs.dtype)


def flash_bwd_dkv_plain(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_start: int = 0,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function: (dk, dv) [B, Tk, Hkv, hd] in k's
    dtype, summed over each kv head's q heads (with an offset: the shard's
    partials over every key)."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    p, ds = _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap, q_start,
                      kv_segment_ids)
    q5 = qs.reshape(B, T, Hkv, Hq // Hkv, hd).float()
    do5 = dout.reshape(B, T, Hkv, Hq // Hkv, hd).float()
    dk = torch.einsum("bkgts,btkgh->bskh", ds, q5)
    dv = torch.einsum("bkgts,btkgh->bskh", p, do5)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B, q_start, Tq, Tk, Hq, Hkv, hd, softcap, window, stream
    tail = [i] * 7 + [f, i, ptr]
    lib.flash_fwd.argtypes = [i, i] + [ptr] * 7 + tail
    lib.flash_bwd_dq.argtypes = [i, i] + [ptr] * 9 + tail
    lib.flash_bwd_dkv.argtypes = [i, i] + [ptr] * 10 + [i] + tail  # + dkv_plan
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check(qs, k, v, segment_ids, *extra, kv_segment_ids=None, q_start: int = 0) -> None:
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    B, T, Hq, hd = qs.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or Hq % Hkv:
        raise ValueError(f"unsupported heads Hq={Hq} Hkv={Hkv} hd={hd} (hd in {HEAD_DIMS})")
    if qs.device.type != "cuda":
        raise ValueError(f"the flash kernels run on cuda, not {qs.device}")
    if q_start < 0 or q_start + T > Tk:
        raise ValueError(f"query rows [{q_start}, {q_start + T}) outside the {Tk} keys")
    for name, t in dict(k=k, v=v, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
                        **{f"arg{i}": t for i, t in enumerate(extra)}).items():
        if t.device != qs.device:
            raise ValueError(f"{name} is on {t.device}, q on {qs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not qs.is_contiguous():
        raise ValueError("q must be contiguous")
    if qs.dtype not in _DTYPES or k.dtype != qs.dtype or v.dtype != qs.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {qs.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if segment_ids.dtype != torch.int32 or tuple(segment_ids.shape) != (B, T):
        raise TypeError(f"segment_ids must be int32 [{B}, {T}]")
    if kv_segment_ids.dtype != torch.int32 or tuple(kv_segment_ids.shape) != (B, Tk):
        raise TypeError(f"kv_segment_ids must be int32 [{B}, {Tk}]")
    if tuple(k.shape) != (B, Tk, Hkv, hd) or tuple(v.shape) != (B, Tk, Hkv, hd):
        raise ValueError(f"k, v must be [{B}, {Tk}, Hkv, {hd}], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _rows(qs, k, window, softcap, q_start):
    """The launch's trailing arguments: B, q_start, Tq, Tk, Hq, Hkv, hd,
    softcap, window, stream."""
    B, T, Hq, hd = qs.shape
    return (B, q_start, T, k.shape[1], Hq, k.shape[2], hd, float(softcap or 0.0),
            int(window or 0), torch.cuda.current_stream(qs.device).cuda_stream)


def _raise(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd(qs, k, v, segment_ids, window: Optional[int] = None,
              softcap: Optional[float] = None, q_start: int = 0,
              kv_segment_ids: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Tq, Hq, hd], lse f32 [B, Hq, Tq]) of pre-scaled q_s; the
    forward kernel on cuda, `flash_fwd_plain` on the CPU."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v, segment_ids, window, softcap, q_start, kv_segment_ids)
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    _check(qs, k, v, segment_ids, kv_segment_ids=kv_seg, q_start=q_start)
    B, T, Hq, hd = qs.shape
    out = torch.empty_like(qs)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=qs.device)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_fwd(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        segment_ids.data_ptr(), kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_rows(qs, k, window, softcap, q_start)), "flash_fwd")
    _build.count_launch(flash_fwd, tensor_cores=bf16, head_dim=hd)  # bf16: tensor cores
    return out, lse


def flash_bwd_dq(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                 softcap: Optional[float] = None, q_start: int = 0,
                 kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d loss / d q_s; the dq kernel on cuda, `flash_bwd_dq_plain` on the
    CPU."""
    if qs.device.type == "cpu":
        return flash_bwd_dq_plain(qs, k, v, segment_ids, dout, lse, di, window, softcap,
                                  q_start, kv_segment_ids)
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    _check(qs, k, v, segment_ids, dout, lse, di, kv_segment_ids=kv_seg, q_start=q_start)
    dq = torch.empty_like(qs)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_bwd_dq(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        segment_ids.data_ptr(), kv_seg.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), *_rows(qs, k, window, softcap, q_start)),
        "flash_bwd_dq")
    _build.count_launch(flash_bwd_dq, tensor_cores=bf16,
                        head_dim=qs.shape[-1])  # bf16: tensor cores
    return dq


def flash_bwd_dkv(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_start: int = 0,
                  kv_segment_ids: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) over all Tk keys, summed over each kv head's q heads; the
    dk/dv kernel on cuda, `flash_bwd_dkv_plain` on the CPU."""
    if qs.device.type == "cpu":
        return flash_bwd_dkv_plain(qs, k, v, segment_ids, dout, lse, di, window, softcap,
                                   q_start, kv_segment_ids)
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    _check(qs, k, v, segment_ids, dout, lse, di, kv_segment_ids=kv_seg, q_start=q_start)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_bwd_dkv(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        segment_ids.data_ptr(), kv_seg.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dkv_plan(qs.shape[2], k.shape[2], qs.shape[-1], bf16, k.shape[0], k.shape[1]),
        *_rows(qs, k, window, softcap, q_start)), "flash_bwd_dkv")
    _build.count_launch(flash_bwd_dkv, tensor_cores=bf16,
                        head_dim=qs.shape[-1])  # bf16: tensor cores
    return dk, dv


for _wrapper in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _wrapper.launches = _wrapper.launches_tc = 0
    _wrapper.launches_hd = dict.fromkeys(HEAD_DIMS, 0)


def attention_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = sum over hd of out * dout, f32 [B, Hq, T] (plain torch, as
    splash computes it outside its kernels)."""
    return (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()


@torch.library.custom_op("areal_torch::flash_attention", mutates_args=())
def flash_attention_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor, q_start: int,
                       window: int, softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of pre-scaled q_s (query rows from `q_start` of the keys'
    rows) through `flash_fwd` (window 0 and softcap 0 are off).  Its
    backward runs the dq and dk/dv kernels from the saved q_s, k, v, out
    and lse; under `torch.utils.checkpoint` the forward runs again during
    the backward unless the remat rung keeps its outputs."""
    return flash_fwd(qs, k, v, segment_ids, window or None, softcap or None, q_start,
                     kv_segment_ids)


def _flash_setup(ctx, inputs, output):
    qs, k, v, segment_ids, kv_segment_ids, q_start, window, softcap = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(qs, k, v, segment_ids, kv_segment_ids, out, lse)
    ctx.q_start, ctx.window, ctx.softcap = q_start, window or None, softcap or None


def _flash_backward(ctx, dout, _dlse):
    qs, k, v, segment_ids, kv_segment_ids, out, lse = ctx.saved_tensors
    dout = dout.contiguous()
    di = attention_di(out, dout)
    args = (ctx.window, ctx.softcap, ctx.q_start, kv_segment_ids)
    dq = flash_bwd_dq(qs, k, v, segment_ids, dout, lse, di, *args)
    dk, dv = flash_bwd_dkv(qs, k, v, segment_ids, dout, lse, di, *args)
    return dq, dk, dv, None, None, None, None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def scale_query(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(hd) in q's dtype, the constant rounded to that dtype
    first, as the splash path scales its input."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype).item()
    return q * scale


def segment_flash_attention(
    q: torch.Tensor,  # [B, Tq, Hq, hd] (rope applied, not scaled)
    k: torch.Tensor,  # [B, Tk, Hkv, hd]
    v: torch.Tensor,  # [B, Tk, Hkv, hd]
    segment_ids: torch.Tensor,  # int [B, Tq], -1 = padding
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    q_start: int = 0,
    kv_segment_ids: Optional[torch.Tensor] = None,  # int [B, Tk]; default segment_ids
) -> torch.Tensor:
    """Differentiable segment-masked causal attention over packed rows ->
    [B, Tq, Hq, hd] in q's dtype, the queries at rows [q_start, q_start +
    Tq) of the keys' rows.  Segments must be contiguous (the layout
    `pack_into_rows` emits).  With an offset, dk and dv are the shard's
    partials over every key."""
    qs = scale_query(q).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    kv_seg = seg if kv_segment_ids is None else kv_segment_ids.to(torch.int32).contiguous()
    out, _ = flash_attention_op(qs, k.contiguous(), v.contiguous(), seg, kv_seg, int(q_start),
                                int(sliding_window or 0), float(logit_softcap or 0.0))
    return out
