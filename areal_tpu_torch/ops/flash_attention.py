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
wrapper counts its launches in `.launches`.  Every wrapper picks its kernel
by dtype: bfloat16 runs on the tensor cores (counted again in
`.launches_tc`), float32 on the CUDA cores, whose f32 products the tensor
cores (TF32 at best) could not keep.

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

HEAD_DIM = 128  # the kernels' head dim
_DTYPES = (torch.float32, torch.bfloat16)


def flash_supported(T: int, Hq: int, Hkv: int, hd: int) -> bool:
    """Shapes the kernels take; everything else runs `naive_attention`, as
    JAX's `splash_supported` sends its misfits there.  It admits Qwen2.5's
    packed training rows (T >= 256, T % 128 == 0, hd 128); head dims other
    than 128 take the naive path here where JAX would run splash."""
    return T >= 256 and T % 128 == 0 and hd == HEAD_DIM and Hkv > 0 and Hq % Hkv == 0


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _allowed(segment_ids: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """bool [B, 1, 1, T, T] (query, key): same valid segment, key at or
    before the query, inside the window."""
    T = segment_ids.shape[1]
    idx = torch.arange(T, device=segment_ids.device)
    sq, sk = segment_ids[:, :, None], segment_ids[:, None, :]
    mask = (sq == sk) & (sq >= 0) & (idx[None, :] <= idx[:, None])
    if window:
        mask &= idx[None, :] > idx[:, None] - window
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
                    softcap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function: (out [B, T, Hq, hd] in q's dtype,
    lse f32 [B, Hq, T])."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    s, _ = _scores(qs, k, softcap)
    mask = _allowed(segment_ids, window)
    m = torch.where(mask, s, -torch.inf).amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    lt = l.permute(0, 3, 1, 2)[..., None]  # [B, T, Hkv, G, 1]
    out = torch.where(lt > 0, o / lt, 0.0).reshape(B, T, Hq, hd).to(qs.dtype)
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf).reshape(B, Hq, T)
    return out, lse


def _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap):
    """The backward's P and dS [B, Hkv, G, T, S] in f32."""
    Hkv = k.shape[2]
    B, T, Hq, hd = qs.shape
    s, t = _scores(qs, k, softcap)
    mask = _allowed(segment_ids, window)
    p = torch.where(mask, torch.exp(s - _to_bkgt(lse, Hkv)[..., None]), 0.0)
    dp = torch.einsum("btkgh,bskh->bkgts", dout.reshape(B, T, Hkv, Hq // Hkv, hd).float(),
                      v.float())
    ds = p * (dp - _to_bkgt(di, Hkv)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def flash_bwd_dq_plain(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's function: d loss / d q_s [B, T, Hq, hd] in q's dtype.
    `di` [B, Hq, T] is sum(out * dout) over hd, in f32."""
    B, T, Hq, hd = qs.shape
    _, ds = _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k.float())
    return dq.reshape(B, T, Hq, hd).to(qs.dtype)


def flash_bwd_dkv_plain(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function: (dk, dv) [B, T, Hkv, hd] in k's dtype,
    summed over each kv head's q heads."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    p, ds = _probs_ds(qs, k, v, segment_ids, dout, lse, di, window, softcap)
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
    tail = [i] * 5 + [f, i, ptr]  # B, T, Hq, Hkv, hd, softcap, window, stream
    lib.flash_fwd.argtypes = [i, i] + [ptr] * 6 + tail
    lib.flash_bwd_dq.argtypes = [i, i] + [ptr] * 8 + tail
    lib.flash_bwd_dkv.argtypes = [i, i] + [ptr] * 9 + tail
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check(qs, k, v, segment_ids, *extra) -> None:
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    if qs.device.type != "cuda":
        raise ValueError(f"the flash kernels run on cuda, not {qs.device}")
    for name, t in dict(k=k, v=v, segment_ids=segment_ids,
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
    if tuple(k.shape) != (B, T, Hkv, hd) or tuple(v.shape) != (B, T, Hkv, hd):
        raise ValueError(f"k, v must be [{B}, {T}, Hkv, {hd}], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hd != HEAD_DIM or Hq % Hkv:
        raise ValueError(f"unsupported heads Hq={Hq} Hkv={Hkv} hd={hd} (hd {HEAD_DIM})")


def _common(qs, window, softcap):
    B, T, Hq, hd = qs.shape
    return (B, T, Hq, hd, float(softcap or 0.0), int(window or 0),
            torch.cuda.current_stream(qs.device).cuda_stream)


def _raise(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd(qs, k, v, segment_ids, window: Optional[int] = None,
              softcap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, Hq, hd], lse f32 [B, Hq, T]) of pre-scaled q_s; the
    forward kernel on cuda, `flash_fwd_plain` on the CPU."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v, segment_ids, window, softcap)
    _check(qs, k, v, segment_ids)
    B, T, Hq, hd, cap, win, stream = _common(qs, window, softcap)
    out = torch.empty_like(qs)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=qs.device)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_fwd(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(),
        v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, Hq, k.shape[2], hd, cap, win, stream), "flash_fwd")
    _build.count_launch(flash_fwd, tensor_cores=bf16)  # bf16 runs on the tensor cores
    return out, lse


def flash_bwd_dq(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """d loss / d q_s; the dq kernel on cuda, `flash_bwd_dq_plain` on the
    CPU."""
    if qs.device.type == "cpu":
        return flash_bwd_dq_plain(qs, k, v, segment_ids, dout, lse, di, window, softcap)
    _check(qs, k, v, segment_ids, dout, lse, di)
    B, T, Hq, hd, cap, win, stream = _common(qs, window, softcap)
    dq = torch.empty_like(qs)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_bwd_dq(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(),
        v.data_ptr(), segment_ids.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), B, T, Hq, k.shape[2], hd, cap, win, stream),
        "flash_bwd_dq")
    _build.count_launch(flash_bwd_dq, tensor_cores=bf16)  # bf16 runs on the tensor cores
    return dq


def flash_bwd_dkv(qs, k, v, segment_ids, dout, lse, di, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), summed over each kv head's q heads; the dk/dv kernel on
    cuda, `flash_bwd_dkv_plain` on the CPU."""
    if qs.device.type == "cpu":
        return flash_bwd_dkv_plain(qs, k, v, segment_ids, dout, lse, di, window, softcap)
    _check(qs, k, v, segment_ids, dout, lse, di)
    B, T, Hq, hd, cap, win, stream = _common(qs, window, softcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bf16 = qs.dtype == torch.bfloat16
    _raise(_lib().flash_bwd_dkv(
        qs.device.index or 0, int(bf16), qs.data_ptr(), k.data_ptr(),
        v.data_ptr(), segment_ids.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, Hq, k.shape[2], hd, cap, win,
        stream), "flash_bwd_dkv")
    _build.count_launch(flash_bwd_dkv, tensor_cores=bf16)  # bf16 runs on the tensor cores
    return dk, dv


flash_fwd.launches = flash_fwd.launches_tc = 0
flash_bwd_dq.launches = flash_bwd_dq.launches_tc = 0
flash_bwd_dkv.launches = flash_bwd_dkv.launches_tc = 0


def attention_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = sum over hd of out * dout, f32 [B, Hq, T] (plain torch, as
    splash computes it outside its kernels)."""
    return (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()


class _SegmentFlashAttention(torch.autograd.Function):
    """Forward kernel; backward = dq and dk/dv kernels.  Saves q_s, k, v,
    out and lse; under `torch.utils.checkpoint` the forward runs again
    during the backward."""

    @staticmethod
    def forward(ctx, qs, k, v, segment_ids, window, softcap):
        out, lse = flash_fwd(qs, k, v, segment_ids, window, softcap)
        ctx.save_for_backward(qs, k, v, segment_ids, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, segment_ids, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = attention_di(out, dout)
        dq = flash_bwd_dq(qs, k, v, segment_ids, dout, lse, di, ctx.window, ctx.softcap)
        dk, dv = flash_bwd_dkv(qs, k, v, segment_ids, dout, lse, di, ctx.window, ctx.softcap)
        return dq, dk, dv, None, None, None


def scale_query(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(hd) in q's dtype, the constant rounded to that dtype
    first, as the splash path scales its input."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype).item()
    return q * scale


def segment_flash_attention(
    q: torch.Tensor,  # [B, T, Hq, hd] (rope applied, not scaled)
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    segment_ids: torch.Tensor,  # int [B, T], -1 = padding
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable segment-masked causal attention over packed rows ->
    [B, T, Hq, hd] in q's dtype.  Segments must be contiguous (the layout
    `pack_into_rows` emits)."""
    qs = scale_query(q).contiguous()
    return _SegmentFlashAttention.apply(
        qs, k.contiguous(), v.contiguous(), segment_ids.to(torch.int32).contiguous(),
        sliding_window, logit_softcap)
