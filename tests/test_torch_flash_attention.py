"""The torch port's segment flash attention against the JAX package.

The port's plain versions (`areal_tpu_torch/ops/flash_attention.py`, what
the wrappers run for CPU tensors) and their autograd function are held
against `areal_tpu`'s splash path (`segment_attention(impl="splash")`),
run in interpret mode on the CPU as tests/test_attention.py runs it, on
packed multi-segment rows with tail padding, a sliding window and a logit
softcap; the plain dq and dk/dv functions against autograd of the port's
`naive_attention`.  The CUDA kernels are held against the plain versions
on the card (`gpu` marker; skips without one).
"""

import math

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import attention as port_attn
from areal_tpu_torch.ops import flash_attention as fa

# out: f32 on both sides, the same softmax in another summation order
# (blockwise online against one pass) -> 1e-4 on valid rows, as
# tests/test_attention.py holds splash against naive.  Gradients: 1e-3
# relative to the largest element, as that file does.
OUT_ATOL = 1e-4
GRAD_RTOL = 1e-3


@pytest.fixture
def interpret(monkeypatch):
    from areal_tpu.ops import attention as jax_attn

    monkeypatch.setattr(jax_attn, "INTERPRET", True)


def _packed(seed, B=1, T=256, Hq=4, Hkv=2, hd=128, n_segs=3):
    """numpy q, k, v, cotangent, segment ids and positions: contiguous
    segments, 16 tokens of tail padding (as tests/test_attention.py)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    seg = np.full((B, T), -1, np.int32)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        bounds = sorted(rng.choice(np.arange(32, T - 32), n_segs - 1, replace=False))
        start = 0
        for s, end in enumerate(list(bounds) + [T - 16]):
            seg[b, start:end] = s
            pos[b, start:end] = np.arange(end - start)
            start = end
    return q, k, v, g, seg, pos


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-9)


def _port_out_grads(q, k, v, g, seg, window=None, softcap=None):
    """Port's out and grads of sum(out * g * valid) (pad rows carry no
    cotangent, as they reach no loss)."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.segment_flash_attention(tq, tk, tv, torch.from_numpy(seg), window, softcap)
    w = torch.from_numpy((seg >= 0)[..., None, None].astype(np.float32))
    (out * torch.from_numpy(g) * w).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", [
    dict(B=2),
    dict(window=64, n_segs=2),
    dict(softcap=30.0),
], ids=["packed", "window", "softcap"])
def test_plain_forward_and_grads_match_splash(interpret, case):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.attention import segment_attention

    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, pos = _packed(7, B=case.get("B", 1), n_segs=case.get("n_segs", 3))
    valid = seg >= 0
    w = jnp.asarray(valid[..., None, None], jnp.float32)

    def loss(q_, k_, v_):
        o = segment_attention(q_, k_, v_, jnp.asarray(seg), jnp.asarray(pos),
                              sliding_window=window, logit_softcap=softcap, impl="splash")
        return (o * jnp.asarray(g) * w).sum(), o

    (_, ref), ref_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _port_out_grads(q, k, v, g, seg, window, softcap)
    assert np.abs(out - np.asarray(ref))[valid].max() < OUT_ATOL
    assert not out[~valid].any()  # pad rows: output 0
    for name, a, b in zip("qkv", grads, ref_grads):
        b = np.asarray(b)
        mask = valid[..., None, None]
        assert _rel(a * mask, b * mask) < GRAD_RTOL, name


@pytest.mark.parametrize("window,softcap", [(None, None), (48, None), (None, 20.0)])
def test_plain_backward_matches_naive_autograd(window, softcap):
    """flash_bwd_dq_plain / flash_bwd_dkv_plain against autograd through
    `naive_attention` (which scales the f32 scores instead of q: the two
    orders agree to rounding in f32)."""
    q, k, v, g, seg, pos = _packed(3, B=2, T=256, Hq=4, Hkv=2, hd=128)
    g = g * (seg >= 0)[..., None, None]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    mask = port_attn.make_attention_mask(torch.from_numpy(seg), torch.from_numpy(pos), window)
    out = port_attn.naive_attention(tq, tk, tv, mask, softcap)
    (out * torch.from_numpy(g)).sum().backward()

    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = torch.from_numpy(q) * scale
    kk, vv, sg, dout = (torch.from_numpy(x) for x in (k, v, seg, g))
    o, lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(o, dout)
    dqs = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    valid = (seg >= 0)[..., None, None]
    assert _rel((dqs * scale).numpy() * valid, tq.grad.numpy() * valid) < GRAD_RTOL
    assert _rel(dk.numpy(), tk.grad.numpy()) < GRAD_RTOL
    assert _rel(dv.numpy(), tv.grad.numpy()) < GRAD_RTOL


def test_valid_grads_ignore_pad_row_content():
    """Pad rows neither send nor receive gradient: rewriting q/k/v and the
    cotangent at pad positions leaves every valid position's output and
    gradient bit-identical."""
    q, k, v, g, seg, _ = _packed(5, B=2)
    pad = (seg < 0)[..., None, None]
    rng = np.random.default_rng(9)
    out0, grads0 = _port_out_grads(q, k, v, g, seg)

    def scramble(x):
        return np.where(pad, 5.0 * rng.standard_normal(x.shape).astype(np.float32), x)

    out1, grads1 = _port_out_grads(scramble(q), scramble(k), scramble(v), scramble(g), seg)
    valid = ~pad
    np.testing.assert_array_equal(out0 * valid, out1 * valid)
    for a, b in zip(grads0, grads1):
        np.testing.assert_array_equal(a * valid, b * valid)


def test_segment_attention_dispatch():
    """The flash path inside the gate (T >= 256, T % 128 == 0, hd 128),
    `naive_attention` outside it; both agree on valid rows.  The branch
    shows at the pad rows: flash gives them 0, naive a uniform average.
    The model's layer loop takes the same `make_segment_attention`."""
    assert fa.flash_supported(256, 12, 2, 128) and fa.flash_supported(1024, 12, 2, 128)
    assert not fa.flash_supported(128, 12, 2, 128)
    assert not fa.flash_supported(320, 12, 2, 128)
    assert not fa.flash_supported(256, 12, 2, 64)
    for T, flash in ((256, True), (128, False)):
        q, k, v, _, seg, pos = (torch.from_numpy(x) for x in _packed(11, T=T))
        before = fa.flash_fwd.launches
        got = port_attn.segment_attention(q, k, v, seg, pos)
        assert fa.flash_fwd.launches == before  # CPU tensors run the plain version
        mask = port_attn.make_attention_mask(seg, pos)
        ref = port_attn.naive_attention(q, k, v, mask)
        valid = (seg >= 0).numpy()
        assert np.abs((got - ref).numpy())[valid].max() < OUT_ATOL
        assert bool((got[~seg.ge(0)] == 0).all()) == flash, T


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, _, seg, _ = (torch.from_numpy(x) for x in _packed(1, T=256, hd=128))
    with pytest.raises(ValueError):
        fa._check(q, k, v, seg)  # CPU tensors never reach a kernel
    with pytest.raises(ValueError):
        fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), seg.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(dtype=torch.float32),
    dict(dtype=torch.bfloat16),
    dict(dtype=torch.bfloat16, window=96),
    dict(dtype=torch.bfloat16, softcap=30.0),
    dict(dtype=torch.bfloat16, T=1024, Hq=12, Hkv=2, n_segs=4),
])
def test_cuda_kernels_match_plain(cuda_device, case):
    """Each kernel against its plain version on the card: f32 within 1e-5
    (out) and 1e-4 relative (grads); bf16 within 2e-2 (both round the f32
    results once to bf16, after f32 sums in another order)."""
    dtype = case["dtype"]
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(13, B=2, T=case.get("T", 256), Hq=case.get("Hq", 4),
                                 Hkv=case.get("Hkv", 2), n_segs=case.get("n_segs", 3))
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)  # no atomics: bit-equal reruns
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, p_lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, p_lse, di, window, softcap)
    valid = torch.from_numpy(seg >= 0).to(cuda_device)
    f32 = dtype == torch.float32
    err = (out.float() - p_out.float()).abs()[valid].max().item()
    assert err < (1e-5 if f32 else 2e-2), err
    assert torch.allclose(lse[valid.unsqueeze(1).expand_as(lse)],
                          p_lse[valid.unsqueeze(1).expand_as(p_lse)], atol=1e-4)
    for a, b in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert rel < (1e-4 if f32 else 2e-2), rel
