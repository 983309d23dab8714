"""The torch port's segment flash attention against the JAX package.

The port's plain versions (`areal_tpu_torch/ops/flash_attention.py`, what
the wrappers run for CPU tensors) and their autograd function are held
against `areal_tpu`'s splash path (`segment_attention(impl="splash")`),
run in interpret mode on the CPU as tests/test_attention.py runs it, on
packed multi-segment rows with tail padding, a sliding window and a logit
softcap; the plain dq and dk/dv functions against autograd of the port's
`naive_attention`.  The rounding that the bf16 tensor-core backward adds
(P and dS to bf16 before their products) is emulated on the CPU and held
to the tolerance the card's checks use.  The CUDA kernels are held against
the plain versions on the card (`gpu` marker; skips without one).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None), (None, 30.0),
                                            (64, 30.0)])
def test_cpu_tensors_run_the_plain_versions(dtype, window, softcap):
    """For CPU tensors each wrapper returns its plain version's result, bit
    for bit, in the input dtype, and launches nothing (the launch counters
    stay put); pad rows get exactly 0 from all of them."""
    q, k, v, g, seg, _ = _packed(29, B=2)
    qs, kk, vv, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [(w.launches, w.launches_tc) for w in wrappers]
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    assert [(w.launches, w.launches_tc) for w in wrappers] == before
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    for a, b in ((out, p_out), (lse, p_lse), (dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert torch.equal(a, b)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    pad = torch.from_numpy(seg < 0)
    assert not out[pad].any() and not dq[pad].any() and not dk[pad].any() and not dv[pad].any()


def _bf16_kernel_grads(qs, k, v, seg, dout, lse, di, window, softcap):
    """The tensor-core backward's arithmetic, emulated in f32 on the CPU:
    P and dS rounded to bf16 before dv = P^T dO, dk = dS^T Q and dq = dS K,
    f32 sums, each result rounded once to bf16."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    p, ds = fa._probs_ds(qs, k, v, seg, dout, lse, di, window, softcap)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    q5 = qs.reshape(B, T, Hkv, Hq // Hkv, hd)
    do5 = dout.reshape(B, T, Hkv, Hq // Hkv, hd)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k).reshape(B, T, Hq, hd)
    dk = torch.einsum("bkgts,btkgh->bskh", ds, q5)
    dv = torch.einsum("bkgts,btkgh->bskh", p, do5)
    return [x.bfloat16().float() for x in (dq, dk, dv)]


@pytest.mark.parametrize("case", [
    dict(),
    dict(window=256),
    dict(softcap=30.0),
], ids=["packed", "window", "softcap"])
def test_tensor_core_backward_rounding_within_budget(case):
    """The rounding the bf16 backward kernels add (P and dS to bf16 before
    their products) stays within the 2e-2 of the largest element that the
    card's checks allow against the f32 plain versions, on a packed
    bf16-valued row at Qwen2.5's heads (T=1024, 4 segments, tail padding).
    The inputs are what the kernels get: q_s, k, v and dout in bf16, lse
    from the forward and di from the bf16 output, both f32."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(23, B=1, T=1024, Hq=12, Hkv=2, n_segs=4)
    qs = fa.scale_query(torch.from_numpy(q).bfloat16()).float()
    kk, vv, dout = (torch.from_numpy(x).bfloat16().float() for x in (k, v, g))
    sg = torch.from_numpy(seg)
    out, lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out.bfloat16(), dout)
    want = [fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap),
            *fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)]
    got = _bf16_kernel_grads(qs, kk, vv, sg, dout, lse, di, window, softcap)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = _rel(a.numpy(), b.numpy())
        assert 0 < rel < 2e-2, (name, rel)  # > 0: the rounding is really emulated


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
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    counts = [w.launches for w in wrappers]
    tc0 = [w.launches_tc for w in wrappers]
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    runs = (1, 1, 2)
    assert [w.launches for w in wrappers] == [c + n for c, n in zip(counts, runs)]
    # bf16 runs every kernel on the tensor cores, f32 on the CUDA cores
    bf16 = dtype == torch.bfloat16
    assert [w.launches_tc for w in wrappers] == [c + n * bf16 for c, n in zip(tc0, runs)]
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=1024, n_segs=4),
    dict(T=2048, n_segs=3, window=256),
    dict(T=1024, n_segs=2, softcap=30.0),
], ids=["packed", "window", "softcap"])
def test_cuda_tensor_core_forward(cuda_device, case):
    """The bf16 forward on the tensor cores at Qwen2.5's heads (Hq=12,
    Hkv=2, hd=128) against `flash_fwd_plain`: within 2e-2 on valid rows (it
    rounds P to bf16 before PV, the plain version keeps P in f32; both round
    out once to bf16), lse within 1e-4 (both sum the f32 P), pad rows out 0
    and lse -inf; two forwards bit-equal (no atomics)."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, _, seg, _ = _packed(17, B=2, T=case["T"], Hq=12, Hkv=2, n_segs=case["n_segs"])
    qs, kk, vv = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    tc0, all0 = fa.flash_fwd.launches_tc, fa.flash_fwd.launches
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    out2, lse2 = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches_tc, fa.flash_fwd.launches) == (tc0 + 2, all0 + 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    valid = torch.from_numpy(seg >= 0).to(cuda_device)
    err = (out.float() - p_out.float()).abs()[valid].max().item()
    assert err < 2e-2, err
    vl = valid.unsqueeze(1).expand_as(lse)
    assert torch.allclose(lse[vl], p_lse[vl], atol=1e-4)
    assert not out[~valid].any() and bool((lse[~vl] == -torch.inf).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=1024, n_segs=4),
    dict(T=2048, n_segs=3, window=256),
    dict(T=1024, n_segs=2, softcap=30.0),
], ids=["packed", "window", "softcap"])
def test_cuda_tensor_core_backward(cuda_device, case):
    """The bf16 dq and dk/dv kernels on the tensor cores at Qwen2.5's heads
    (Hq=12, Hkv=2, hd=128) against the f32 plain versions: within 2e-2
    of the largest element (they round P and dS to bf16 before their
    products, the plain versions keep both in f32; both round the results
    once to bf16).  Pad rows get exactly 0; two runs are bit-equal (no
    atomics); every launch is counted on the tensor-core variant."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(19, B=2, T=case["T"], Hq=12, Hkv=2, n_segs=case["n_segs"])
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    wrappers = (fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [(w.launches, w.launches_tc) for w in wrappers]
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dq2 = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_tc) for w in wrappers] == [
        (n + 2, tc + 2) for n, tc in before]
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    pad = torch.from_numpy(seg < 0).to(cuda_device)
    assert not dq[pad].any() and not dk[pad].any() and not dv[pad].any()
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    for name, a, b in (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert rel < 2e-2, (name, rel)
