"""The torch port's segment flash attention against the JAX package.

The port's plain versions (`areal_tpu_torch/ops/flash_attention.py`, what
the wrappers run for CPU tensors) and their autograd function are held
against `areal_tpu`'s splash path (`segment_attention(impl="splash")`),
run in interpret mode on the CPU as tests/test_attention.py runs it, on
packed multi-segment rows with tail padding, a sliding window and a logit
softcap, at head dim 128 and at 256 (Gemma-2B's 8 q heads on one kv head,
and an MHA group); the plain dq and dk/dv functions against autograd of
the port's `naive_attention`.  The rounding that the bf16 tensor-core backward adds
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    dict(hd=256, Hq=8, Hkv=1),
    dict(hd=256, Hq=2, Hkv=2, softcap=30.0),
], ids=["packed", "window", "softcap", "hd256-mqa", "hd256-mha-softcap"])
def test_plain_forward_and_grads_match_splash(interpret, case):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.attention import segment_attention

    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, pos = _packed(7, B=case.get("B", 1), n_segs=case.get("n_segs", 3),
                                   hd=case.get("hd", 128), Hq=case.get("Hq", 4),
                                   Hkv=case.get("Hkv", 2))
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
    """The flash path inside the gate (T >= 256, T % 128 == 0, hd 128 or
    256), `naive_attention` outside it; both agree on valid rows.  The branch
    shows at the pad rows: flash gives them 0, naive a uniform average.
    The model's layer loop takes the same `make_segment_attention`."""
    assert fa.flash_supported(256, 12, 2, 128) and fa.flash_supported(1024, 12, 2, 128)
    assert not fa.flash_supported(128, 12, 2, 128)
    assert not fa.flash_supported(320, 12, 2, 128)
    assert not fa.flash_supported(256, 12, 2, 64)
    assert fa.flash_supported(1024, 8, 1, 256) and fa.flash_supported(256, 16, 16, 256)
    assert not fa.flash_supported(256, 8, 1, 192) and not fa.flash_supported(256, 8, 1, 384)
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


def test_dkv_plan():
    """The dk/dv launch plan: the cluster size by group and grid (a power of
    two up to 8 dividing the group, at most 4 heads a block, about 256
    blocks) on the hd-256 bf16 kernel, 1 on every other dk/dv kernel."""
    # Gemma-2B's MQA: 8 q heads on one kv head, rows of 1024 (16 key tiles)
    assert [fa.dkv_plan(8, 1, 256, True, B, 1024) for B in (1, 2, 4, 8, 16, 24)] == [
        8, 8, 4, 2, 2, 2]
    assert fa.dkv_plan(8, 1, 256, True, 1, 2048) == 8
    assert fa.dkv_plan(16, 16, 256, True, 8, 1024) == 1  # Gemma-7B's MHA
    assert fa.dkv_plan(16, 16, 256, True, 1, 256) == 1
    assert fa.dkv_plan(8, 4, 256, True, 8, 1024) == 1  # Gemma-2: 2 heads, 512 blocks
    assert fa.dkv_plan(8, 4, 256, True, 1, 1024) == 2
    assert fa.dkv_plan(16, 1, 256, True, 8, 1024) == 4  # at most 4 heads a block
    assert fa.dkv_plan(12, 1, 256, True, 1, 1024) == 4  # powers of two dividing 12
    assert fa.dkv_plan(6, 1, 256, True, 1, 1024) == 2
    assert fa.dkv_plan(8, 1, 128, True, 1, 1024) == 1  # the hd-128 kernel: one block
    assert fa.dkv_plan(12, 2, 128, False, 8, 1024) == 1  # f32
    assert fa.dkv_plan(8, 1, 256, False, 1, 1024) == 1


def _flash_source():
    import os

    return open(os.path.join(os.path.dirname(fa.__file__), "..", "csrc",
                             "flash_attention.cu")).read()


def _c_launchers(src):
    """{launcher: variant} read from `csrc/flash_attention.cu`: the
    `Variant` each launcher reports, named by the wrappers' `_VARIANTS`,
    whose order must be the enum's."""
    import re

    enum = re.search(r"enum Variant : int \{([^}]*)\}", src).group(1)
    codes = {name: int(value) for name, value in re.findall(r"(k\w+) = (\d+)", enum)}
    assert sorted(codes.values()) == list(range(len(fa._VARIANTS)))
    launchers = {}
    for m in re.finditer(r"\ncudaError_t (\w+)\(", src):
        body = src[m.start():src.index("\n}\n", m.start())]
        report = re.search(r"return report\(.*?, (k\w+), launched\);", body, re.S)
        if report:
            launchers[m.group(1)] = fa._VARIANTS[codes[report.group(1)]]
    return launchers


def _c_rule():
    """{(kernel, bf16, hd): variant} read from the C entry points of
    `csrc/flash_attention.cu`: each entry's float32 return, then its
    bfloat16 return, each a choice by `hd == 128` between two launchers,
    and the variant each launcher reports it launched."""
    import re

    src = _flash_source()
    launchers = _c_launchers(src)
    assert set(launchers) == {"fwd", "bwd_dq", "bwd_dkv", "attn_wg", "bwd_dkv_wg",
                              "bwd_dkv_tc256"}, launchers
    rule = {}
    for kernel, entry in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        f32_part, bf16_part = body.split("if (!bf16)", 1)[1].split(";", 1)
        for bf16, text in ((False, f32_part), (True, bf16_part)):
            m = re.search(r"hd == 128\s*\?\s*(\w+)(<[^>]*>)?\(.*?:\s*(\w+)(<[^>]*>)?\(", text,
                          re.S)
            for hd, name, targs in ((128, m.group(1), m.group(2)), (256, m.group(3),
                                                                    m.group(4))):
                if targs:  # a template's head dim is the launch's
                    assert targs.rstrip(">").split(",")[-1].strip() == str(hd), (entry, targs)
                rule[(kernel, bf16, hd)] = launchers[name]
    return rule


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_variant_rule_matches_the_cuda_entry_point(kernel):
    """`variant` mirrors the C entry points' choice by dtype and head dim:
    float32 on the CUDA cores; bfloat16 on the wgmma kernels, the forward
    and dq at hd 128 and 256 and dk/dv at hd 128, and dk/dv at hd 256 on
    the mma.sync cluster kernel."""
    rule = _c_rule()
    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            assert fa.variant(kernel, dtype, hd) == rule[(kernel, dtype == torch.bfloat16, hd)]
    assert fa.variant(kernel, torch.bfloat16, 128) == "wg"
    assert fa.variant(kernel, torch.float32, 128) == "cores"
    want_256 = "tc" if kernel == "dkv" else "wg"
    assert fa.variant(kernel, torch.bfloat16, 256) == want_256


@pytest.mark.parametrize("kernel,wrapper", [("fwd", fa.flash_fwd), ("dq", fa.flash_bwd_dq),
                                            ("dkv", fa.flash_bwd_dkv)])
def test_launches_wg_counts_the_wgmma_variant(kernel, wrapper, monkeypatch):
    """Each wrapper's `launches_wg` advances with a launch that its C
    entry reports on the wgmma kernels and with no other, and starts at 0
    beside `launches` and `launches_tc`; a launch the entry reports no
    kernel for raises and counts nothing."""
    assert isinstance(wrapper.launches_wg, int)
    for attr in ("launches", "launches_tc", "launches_wg"):
        monkeypatch.setattr(wrapper, attr, 0)
    monkeypatch.setattr(wrapper, "launches_hd", dict.fromkeys(fa.HEAD_DIMS, 0))
    rule = _c_rule()
    calls = [(bf16, hd) for bf16 in (False, True) for hd in fa.HEAD_DIMS]
    for bf16, hd in calls:
        fa._count(wrapper, fa._VARIANTS.index(rule[(kernel, bf16, hd)]), hd)
    n_wg = sum(rule[(kernel, bf16, hd)] == "wg" for bf16, hd in calls)
    assert (wrapper.launches, wrapper.launches_tc, wrapper.launches_wg) == (4, 2, n_wg)
    assert n_wg == (1 if kernel == "dkv" else 2)
    assert wrapper.launches_hd == {128: 2, 256: 2}
    with pytest.raises(RuntimeError, match="reported no kernel"):
        fa._count(wrapper, -1, 128)
    assert (wrapper.launches, wrapper.launches_tc, wrapper.launches_wg) == (4, 2, n_wg)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """CPU tensors never reach a kernel, and no kernel takes a head dim
    other than 128 and 256 (a device other than cuda is refused either
    way; the head dim is checked first)."""
    q, k, v, _, seg, _ = (torch.from_numpy(x) for x in _packed(1, T=256, hd=128))
    with pytest.raises(ValueError, match="cuda"):
        fa._check(q, k, v, seg)
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), seg.to("meta"))
    for hd in (64, 192):
        q, k, v, g, seg, _ = (torch.from_numpy(x).to("meta")
                              for x in _packed(1, T=256, hd=hd, Hq=8, Hkv=1))
        lse = torch.empty(1, 8, 256, device="meta")
        with pytest.raises(ValueError, match=f"hd={hd}"):
            fa.flash_fwd(q, k, v, seg)
        with pytest.raises(ValueError, match=f"hd={hd}"):
            fa.flash_bwd_dq(q, k, v, seg, g, lse, lse)
        with pytest.raises(ValueError, match=f"hd={hd}"):
            fa.flash_bwd_dkv(q, k, v, seg, g, lse, lse)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None), (None, 30.0),
                                            (64, 30.0)])
def test_cpu_tensors_run_the_plain_versions(dtype, window, softcap, hd):
    """For CPU tensors each wrapper returns its plain version's result, bit
    for bit, in the input dtype, and launches nothing (the launch counters
    stay put); pad rows get exactly 0 from all of them."""
    q, k, v, g, seg, _ = _packed(29, B=2, hd=hd, **(dict(Hq=8, Hkv=1) if hd == 256 else {}))
    qs, kk, vv, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [(w.launches, w.launches_tc, dict(w.launches_hd)) for w in wrappers]
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    assert [(w.launches, w.launches_tc, dict(w.launches_hd)) for w in wrappers] == before
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
    dict(hd=256, Hq=8, Hkv=1),
], ids=["packed", "window", "softcap", "gemma-2b"])
def test_tensor_core_backward_rounding_within_budget(case):
    """The rounding the bf16 backward kernels add (P and dS to bf16 before
    their products) stays within the 2e-2 of the largest element that the
    card's checks allow against the f32 plain versions, on a packed
    bf16-valued row at Qwen2.5's heads (T=1024, 4 segments, tail padding),
    and at Gemma-2B's (8 q heads on one kv head of 256), where dk and dv
    sum eight heads' products.  The inputs are what the kernels get: q_s,
    k, v and dout in bf16, lse from the forward and di from the bf16
    output, both f32."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(23, B=1, T=1024, Hq=case.get("Hq", 12), Hkv=case.get("Hkv", 2),
                                 hd=case.get("hd", 128), n_segs=4)
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
    dict(dtype=torch.float32, hd=256, Hq=8, Hkv=1),
    dict(dtype=torch.bfloat16, hd=256, Hq=8, Hkv=1),
    dict(dtype=torch.bfloat16, hd=256, Hq=4, Hkv=4, window=96, softcap=30.0),
    dict(dtype=torch.bfloat16, hd=256, T=1024, Hq=8, Hkv=1, n_segs=4),
])
def test_cuda_kernels_match_plain(cuda_device, case):
    """Each kernel against its plain version on the card, at head dim 128
    and 256: f32 within 1e-5 (out) and 1e-4 relative (grads); bf16 within
    2e-2 (both round the f32 results once to bf16, after f32 sums in
    another order).  Each launch is counted at its head dim."""
    dtype = case["dtype"]
    hd = case.get("hd", 128)
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(13, B=2, T=case.get("T", 256), Hq=case.get("Hq", 4),
                                 Hkv=case.get("Hkv", 2), n_segs=case.get("n_segs", 3), hd=hd)
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    counts = [w.launches for w in wrappers]
    tc0 = [w.launches_tc for w in wrappers]
    hd0 = [w.launches_hd[hd] for w in wrappers]
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    runs = (1, 1, 2)
    assert [w.launches for w in wrappers] == [c + n for c, n in zip(counts, runs)]
    assert [w.launches_hd[hd] for w in wrappers] == [c + n for c, n in zip(hd0, runs)]
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


GEMMA_2B_HEADS = dict(hd=256, Hq=8, Hkv=1)
GEMMA_7B_HEADS = dict(hd=256, Hq=16, Hkv=16)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=1024, n_segs=4),
    dict(T=2048, n_segs=3, window=256),
    dict(T=1024, n_segs=2, softcap=30.0),
    dict(T=2048, n_segs=3, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, B=8, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, window=256, softcap=30.0, **GEMMA_7B_HEADS),
], ids=["packed", "window", "softcap", "gemma-2b", "gemma-2b-8-rows",
        "gemma-7b-window-softcap"])
def test_cuda_tensor_core_forward(cuda_device, case):
    """The bf16 forward on the tensor cores at Qwen2.5's heads (Hq=12,
    Hkv=2, hd=128) and Gemma's (hd 256: 8 q heads on 1 kv head; 16 on 16)
    against `flash_fwd_plain`: within 2e-2 on valid rows (it
    rounds P to bf16 before PV, the plain version keeps P in f32; both round
    out once to bf16), lse within 1e-4 (both sum the f32 P), pad rows out 0
    and lse -inf; two forwards bit-equal (no atomics)."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, _, seg, _ = _packed(17, B=2, T=case["T"], Hq=case.get("Hq", 12),
                                 Hkv=case.get("Hkv", 2), hd=case.get("hd", 128),
                                 n_segs=case["n_segs"])
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
    dict(T=2048, n_segs=3, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, B=8, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, window=256, softcap=30.0, **GEMMA_7B_HEADS),
], ids=["packed", "window", "softcap", "gemma-2b", "gemma-2b-8-rows",
        "gemma-7b-window-softcap"])
def test_cuda_tensor_core_backward(cuda_device, case):
    """The bf16 dq and dk/dv kernels on the tensor cores at Qwen2.5's heads
    (Hq=12, Hkv=2, hd=128) and Gemma's (hd 256) against the f32 plain versions: within 2e-2
    of the largest element (they round P and dS to bf16 before their
    products, the plain versions keep both in f32; both round the results
    once to bf16).  Pad rows get exactly 0; two runs are bit-equal (no
    atomics); every launch is counted on the tensor-core variant."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(19, B=case.get("B", 2), T=case["T"], Hq=case.get("Hq", 12),
                                 Hkv=case.get("Hkv", 2), hd=case.get("hd", 128),
                                 n_segs=case["n_segs"])
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


GEMMA_2_2B_HEADS = dict(hd=256, Hq=8, Hkv=4)
# the limits chip_smoke.py holds the offset kernels to: the forward's max
# |out - plain| (one bf16 step at |out| in [2, 4)), dq's max |diff| over
# the largest element (the worst of every earlier run)
K1A_ATOL, K1B_RTOL = 2.0 ** -6, 7.6e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=2048, n_segs=3, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, B=8, **GEMMA_2B_HEADS),
    dict(T=1024, n_segs=2, **GEMMA_7B_HEADS),
    dict(T=1000, n_segs=2, **GEMMA_7B_HEADS),
    dict(T=6144, n_segs=2, window=4096, softcap=50.0, **GEMMA_2_2B_HEADS),
], ids=["gemma-2b-T2048", "gemma-2b-8-rows", "gemma-7b", "gemma-7b-partial-tile",
        "gemma-2-2b-window-softcap"])
def test_cuda_hd256_wgmma_forward_and_dq(cuda_device, case):
    """The bf16 forward and dq at head dim 256 (`wg::flash_wg_kernel`:
    wgmma on TMA-fed K/V tiles that two q heads of a group, or two q tiles
    at group 1, share) against the plain versions at Gemma-2B's heads (8 q
    on 1 kv), Gemma-7B's (16 on 16; also at T = 1000, whose last q tile
    ends 24 rows short, rows the TMA store must clip) and Gemma-2-2B's (8
    on 4, window 4096, softcap 50, a row past the window): out within 2^-6
    on valid rows, lse within 1e-4, dq within 2e-2 of the largest element
    (the other bf16 gradient checks' budget); pad rows get out 0, lse -inf
    and dq 0; reruns are bit-equal; each launch is counted at hd 256 on the
    tensor cores."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, g, seg, _ = _packed(31, B=case.get("B", 2), T=case["T"], Hq=case["Hq"],
                                 Hkv=case["Hkv"], hd=256, n_segs=case["n_segs"])
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq)
    before = [(w.launches, w.launches_tc, w.launches_hd[256]) for w in wrappers]
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    out2, lse2 = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dq2 = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_tc, w.launches_hd[256]) for w in wrappers] == [
        (n + 2, tc + 2, h + 2) for n, tc, h in before]
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    valid = torch.from_numpy(seg >= 0).to(cuda_device)
    err = (out.float() - p_out.float()).abs()[valid].max().item()
    assert err <= K1A_ATOL, err
    vl = valid.unsqueeze(1).expand_as(lse)
    assert torch.allclose(lse[vl], p_lse[vl], atol=1e-4)
    rel = ((dq.float() - p_dq.float()).abs().max() / p_dq.float().abs().max()).item()
    assert rel < 2e-2, rel
    assert not out[~valid].any() and not dq[~valid].any()
    assert bool((lse[~vl] == -torch.inf).all())


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("heads", [GEMMA_2B_HEADS, GEMMA_7B_HEADS], ids=["gemma-2b", "gemma-7b"])
def test_cuda_hd256_offset_shards_equal_unsharded_rows(cuda_device, heads, sp):
    """Each sp shard of a row of 2048 (3 segments, tail padding) at its
    query offset: its out, lse and dq bit-equal to the unsharded kernels'
    rows (a shard starts on a multiple of 128 rows, so every row's key
    tiles are the same), and against the plain offset versions within the
    K1a and K1b limits."""
    q, k, v, g, seg, _ = _packed(37, B=1, T=2048, Hq=heads["Hq"], Hkv=heads["Hkv"], hd=256,
                                 n_segs=3)
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    full_out, full_lse = fa.flash_fwd(qs, kk, vv, sg)
    full_di = fa.attention_di(full_out, dout)
    full_dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, full_lse, full_di)
    n = 2048 // sp
    for s in range(sp):
        a = s * n
        q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
        kw = dict(q_start=a, kv_segment_ids=sg)
        out, lse = fa.flash_fwd(q_s, kk, vv, sg_s, **kw)
        di = full_di[:, :, a:a + n].contiguous()
        dq = fa.flash_bwd_dq(q_s, kk, vv, sg_s, do_s, lse, di, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, full_out[:, a:a + n]), s
        assert torch.equal(lse, full_lse[:, :, a:a + n]), s
        assert torch.equal(dq, full_dq[:, a:a + n]), s
        p_out, p_lse = fa.flash_fwd_plain(q_s, kk, vv, sg_s, **kw)
        p_dq = fa.flash_bwd_dq_plain(q_s, kk, vv, sg_s, do_s, p_lse, di, **kw)
        valid = sg_s >= 0
        assert (out.float() - p_out.float()).abs()[valid].max().item() <= K1A_ATOL
        rel = (dq.float() - p_dq.float()).abs().max() / p_dq.float().abs().max()
        assert rel.item() <= K1B_RTOL, (s, rel.item())


QWEN25_HEADS, QWEN3_HEADS = dict(Hq=12, Hkv=2), dict(Hq=16, Hkv=8)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=2048, n_segs=3, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, B=8, **QWEN3_HEADS),
    dict(T=1024, n_segs=2, Hq=4, Hkv=4),
    dict(T=1000, n_segs=2, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, window=256, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, softcap=30.0, **QWEN3_HEADS),
], ids=["qwen2.5-T2048", "qwen3-8-rows", "mha", "partial-tile", "window", "softcap"])
def test_cuda_hd128_wgmma_forward(cuda_device, case):
    """The bf16 forward at head dim 128 (`wg::flash_wg_kernel<false, CAP,
    128>`: wgmma on TMA-fed K/V tiles that two q heads of a group, or two
    q tiles at group 1, share) against the plain version at Qwen2.5-1.5B's
    heads (12 q on 2 kv; also at T = 1000, a partial last q tile),
    Qwen3-1.7B's (16 on 8), group 1, a window and a softcap: out within
    2^-6 on valid rows, lse within 1e-4; pad rows get out 0 and lse -inf;
    reruns are bit-equal; each launch is counted at hd 128 on the tensor
    cores."""
    window, softcap = case.get("window"), case.get("softcap")
    q, k, v, _, seg, _ = _packed(43, B=case.get("B", 2), T=case["T"], Hq=case["Hq"],
                                 Hkv=case["Hkv"], hd=128, n_segs=case["n_segs"])
    qs, kk, vv = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    w = fa.flash_fwd
    before = (w.launches, w.launches_tc, w.launches_hd[128])
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    out2, lse2 = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    torch.cuda.synchronize()
    assert (w.launches, w.launches_tc, w.launches_hd[128]) == tuple(n + 2 for n in before)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg, window, softcap)
    valid = torch.from_numpy(seg >= 0).to(cuda_device)
    err = (out.float() - p_out.float()).abs()[valid].max().item()
    assert err <= K1A_ATOL, err
    vl = valid.unsqueeze(1).expand_as(lse)
    assert torch.allclose(lse[vl], p_lse[vl], atol=1e-4)
    assert not out[~valid].any()
    assert bool((lse[~vl] == -torch.inf).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(T=2048, n_segs=3, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, B=8, **QWEN3_HEADS),
    dict(T=1024, n_segs=2, Hq=4, Hkv=4),
    dict(T=1000, n_segs=2, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, window=256, **QWEN25_HEADS),
    dict(T=1024, n_segs=2, softcap=30.0, **QWEN25_HEADS),
    dict(rw=(40, 120, 0, 77), **QWEN25_HEADS),
], ids=["qwen2.5-T2048", "qwen3-8-rows", "mha", "partial-tile", "window", "softcap",
        "reward-model-rows"])
def test_cuda_hd128_wgmma_backward(cuda_device, case):
    """The bf16 dq and dk/dv at head dim 128 on wgmma
    (`wg::flash_wg_kernel<true, CAP, 128>` and `wg::flash_dkv_wg_kernel`)
    against the f32 plain versions: Qwen2.5-1.5B's heads (12 q on 2 kv) on
    rows of 2048 with 3 segments and tail padding, Qwen3-1.7B's (16 on 8),
    group 1, T = 1000 (a partial last key tile, and a block whose second
    64 keys lie past the row), a window, a softcap, and the reward model's
    rows (one short sequence a row of 1024, one row filler end to end):
    dq, dk and dv within 2e-2 of the largest element (P and dS rounded to
    bf16 before their products); pad rows' gradients exactly 0; reruns
    bit-equal; every launch counted on the wgmma variant."""
    window, softcap = case.get("window"), case.get("softcap")
    if "rw" in case:
        q, k, v, g, seg = _rw_rows(53, lens=case["rw"])
    else:
        q, k, v, g, seg, _ = _packed(53, B=case.get("B", 2), T=case["T"], Hq=case["Hq"],
                                     Hkv=case["Hkv"], hd=128, n_segs=case["n_segs"])
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    out, lse = fa.flash_fwd(qs, kk, vv, sg, window, softcap)
    di = fa.attention_di(out, dout)
    wrappers = (fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [(w.launches, w.launches_tc, w.launches_wg, w.launches_hd[128]) for w in wrappers]
    dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dq2 = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di, window, softcap)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_tc, w.launches_wg, w.launches_hd[128])
            for w in wrappers] == [tuple(n + 2 for n in b) for b in before]
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    pad = torch.from_numpy(seg < 0).to(cuda_device)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all())
        assert not t[pad].any()
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di, window, softcap)
    for name, a, b in (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert rel < 2e-2, (name, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("heads", [QWEN25_HEADS, QWEN3_HEADS], ids=["qwen2.5", "qwen3"])
def test_cuda_hd128_offset_shards_equal_unsharded_rows(cuda_device, heads, sp):
    """Each sp shard of a row of 2048 (3 segments, tail padding) at its
    query offset, through the hd-128 wgmma kernels: its out and lse
    bit-equal to the unsharded kernel's rows (a shard starts on a multiple
    of 128 rows, so every row's key tiles are the same), and against the
    plain offset version within the K1a limit; the shards' dq against the
    unsharded dq kernel fed the same lse, bit for bit; each shard's dk/dv
    partial zero, exactly, at the keys past its last query, and the
    partials summed within 2e-2 of the unsharded dk/dv kernel's largest
    element (each partial is rounded to bf16 once)."""
    q, k, v, g, seg, _ = _packed(47, B=1, T=2048, Hq=heads["Hq"], Hkv=heads["Hkv"], hd=128,
                                 n_segs=3)
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    full_out, full_lse = fa.flash_fwd(qs, kk, vv, sg)
    full_di = fa.attention_di(full_out, dout)
    full_dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, full_lse, full_di)
    full_dk, full_dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, full_lse, full_di)
    sums = [torch.zeros_like(kk, dtype=torch.float32) for _ in range(2)]
    wg0 = [w.launches_wg for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    n = 2048 // sp
    for s in range(sp):
        a = s * n
        q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
        kw = dict(q_start=a, kv_segment_ids=sg)
        out, lse = fa.flash_fwd(q_s, kk, vv, sg_s, **kw)
        di = full_di[:, :, a:a + n].contiguous()
        dq = fa.flash_bwd_dq(q_s, kk, vv, sg_s, do_s, lse, di, **kw)
        dk, dv = fa.flash_bwd_dkv(q_s, kk, vv, sg_s, do_s, lse, di, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, full_out[:, a:a + n]), s
        assert torch.equal(lse, full_lse[:, :, a:a + n]), s
        assert torch.equal(dq, full_dq[:, a:a + n]), s
        assert not dk[:, a + n:].any() and not dv[:, a + n:].any(), s
        sums[0] += dk.float()
        sums[1] += dv.float()
        p_out, _ = fa.flash_fwd_plain(q_s, kk, vv, sg_s, **kw)
        valid = sg_s >= 0
        assert (out.float() - p_out.float()).abs()[valid].max().item() <= K1A_ATOL
    assert [w.launches_wg for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv)] == [
        n0 + sp for n0 in wg0]
    for name, x, y in (("dk", sums[0], full_dk), ("dv", sums[1], full_dv)):
        rel = ((x - y.float()).abs().max() / y.float().abs().max()).item()
        assert rel < 2e-2, (name, rel)


def _rw_rows(seed, lens=(1024, 300, 700, 0), T=1024, Hq=12, Hkv=2, hd=128):
    """The reward model's layout: one sequence a row from position 0, tail
    padding after it, and (length 0) a row that is filler end to end."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q, g = (rng.standard_normal((B, T, Hq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, Hkv, hd)).astype(np.float32) for _ in range(2))
    seg = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lens):
        seg[b, :n] = 0
    return q, k, v, g, seg


@pytest.mark.gpu
def test_cuda_kernels_on_filler_and_one_sequence_rows(cuda_device):
    """K1a, K1b and K1c (bf16, Qwen2.5's heads) on rows of 1024 that each
    hold one sequence, short ones mostly padding, and one row that is
    filler from end to end: every output finite, the filler's out 0 and
    lse -inf as the plain version's, its dq, dk and dv exactly 0 (and every
    pad row's), reruns bit-equal, and the valid rows against the plain
    versions within the K1 limits."""
    q, k, v, g, seg = _rw_rows(41)
    qs, kk, vv, dout = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v, g))
    qs = fa.scale_query(qs)
    sg = torch.from_numpy(seg).to(cuda_device)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    tc0 = [w.launches_tc for w in wrappers]
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(qs, kk, vv, sg)
        di = fa.attention_di(out, dout)
        dq = fa.flash_bwd_dq(qs, kk, vv, sg, dout, lse, di)
        dk, dv = fa.flash_bwd_dkv(qs, kk, vv, sg, dout, lse, di)
        runs.append((out, lse, dq, dk, dv))
    torch.cuda.synchronize()
    assert [w.launches_tc for w in wrappers] == [c + 2 for c in tc0]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse, dq, dk, dv = runs[0]
    pad = sg < 0
    for t in (out, dq, dk, dv):
        assert bool(torch.isfinite(t).all())
        assert not t[pad].any()
    assert not out[3].any() and bool((lse[3] == -torch.inf).all())
    p_out, p_lse = fa.flash_fwd_plain(qs, kk, vv, sg)
    assert bool((p_lse[3] == -torch.inf).all()) and not p_out[3].any()
    p_dq = fa.flash_bwd_dq_plain(qs, kk, vv, sg, dout, lse, di)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, kk, vv, sg, dout, lse, di)
    for p in (p_dq, p_dk, p_dv):
        assert not p[pad].any() and bool(torch.isfinite(p).all())
    assert (out.float() - p_out.float()).abs()[~pad].max().item() <= K1A_ATOL
    for name, a, b in (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert rel < 2e-2, (name, rel)
