"""The torch port's ragged paged-decode attention against the JAX package.

The port's plain version (`areal_tpu_torch/ops/ragged_decode.py`, what the
wrapper runs for CPU tensors) is held against `areal_tpu`'s Pallas kernel,
run in interpret mode on the CPU as its own tests run it, on the six cases
of tests/test_ragged_decode.py plus a mask that admits never-copied
columns.  The CUDA kernel is held against the plain version on the card
(`gpu` marker; skips without one).
"""

import functools

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import ragged_decode as port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# out: f32 sums of <= 48 products in another order than XLA's -> 1e-5.
# bf16: both frameworks round scores/probabilities/out to bf16 after f32
# sums in their own order, so an element may sit one bf16 step (2^-8
# relative) apart; 2e-2 covers that at these magnitudes (|out| < 2).
# The appended cache is a copy of the inputs: compared exactly.
F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _case(seed, *, B=4, T=1, K=32, page=16, M=64, Hq=4, Hkv=2, hd=8,
          qdtype="float32", kvdtype="float32", softcap=None, wide_mask=False, window=None):
    """Inputs as in tests/test_ragged_decode.py `_case`: f32 numpy arrays
    and the dtype each is cast to (round to nearest even on both sides, so
    both frameworks see the same bf16 values; numpy has no bf16 here)."""
    rng = np.random.default_rng(seed)
    S = B + 1
    lengths = rng.integers(0, K - T, B).astype(np.int32)
    rows = rng.permutation(S)[:B].astype(np.int32)
    ck = rng.standard_normal((S, M, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((S, M, Hkv, hd)).astype(np.float32)
    q = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    # k_new/v_new round through the compute dtype, then the cache dtype
    k_new = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    widx = lengths[:, None] + np.arange(T, dtype=np.int32)[None, :]
    if T > 1:
        widx[0, -1] = M
    key_pos = np.arange(K, dtype=np.int32)
    mask = key_pos[None, None, :] <= widx.clip(max=K - 1)[:, :, None]
    if T > 1:
        mask[0, -1] = key_pos <= lengths[0] + T - 1
    if window:
        # a sliding layer's mask (gemma2): keys inside the window only
        mask &= key_pos[None, None, :] > widx.clip(max=K - 1)[:, :, None] - window
    if wide_mask:
        # slot 0 attends every column, including the never-copied ones
        # past its pages: they must score 0, not MASK_VALUE
        lengths[0] = 3
        widx[0] = 3 + np.arange(T)
        mask[0] = True
    arrays = dict(q=q, k_new=k_new, v_new=v_new, ck=ck, cv=cv, rows=rows,
                  lengths=lengths, widx=widx, mask=mask)
    dtypes = dict(q=(qdtype,), k_new=(qdtype, kvdtype), v_new=(qdtype, kvdtype),
                  ck=(kvdtype,), cv=(kvdtype,))
    return arrays, dtypes, dict(key_window=K, page_size=page, logit_softcap=softcap)


def _jax(arrays, dtypes, kw):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.ragged_decode import ragged_paged_attention

    args = []
    for k in ("q", "k_new", "v_new", "ck", "cv", "rows", "lengths", "widx", "mask"):
        a = jnp.asarray(arrays[k])
        for dt in dtypes.get(k, ()):
            a = a.astype(dt)
        args.append(a)
    out = jax.jit(functools.partial(ragged_paged_attention, **kw))(*args)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _to_torch(arrays, dtypes, device="cpu"):
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.array(a))
        for dt in dtypes.get(k, ()):
            t = t.to(getattr(torch, dt))
        out[k] = t.to(device)
    return out


def _port(arrays, dtypes, kw, fn=port.ragged_paged_attention, device="cpu"):
    out = fn(**_to_torch(arrays, dtypes, device), **kw)
    return [o.float().cpu().numpy() for o in out]


@pytest.mark.parametrize("case", [
    dict(),                                      # f32, page-aligned K
    dict(softcap=30.0),                          # softcapped logits
    dict(K=40, page=16),                         # static tail page
    dict(qdtype="bfloat16", kvdtype="bfloat16"),  # low precision
    dict(qdtype="float32", kvdtype="bfloat16"),  # mixed compute/cache
    dict(T=4, K=48),                             # verify tile + dropped pos
    dict(wide_mask=True),                        # mask past the copied pages
    dict(T=4, K=48, wide_mask=True),
    dict(hd=256, softcap=50.0, window=8),         # gemma2's head dim, cap, window
])
def test_plain_matches_jax_kernel(case):
    arrays, dtypes, kw = _case(7, **case)
    want = _jax(arrays, dtypes, kw)
    got = _port(arrays, dtypes, kw)
    atol = BF16_ATOL if case.get("qdtype") == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0, err_msg="out")
    np.testing.assert_array_equal(got[1], want[1], err_msg="ck append")
    np.testing.assert_array_equal(got[2], want[2], err_msg="cv append")


def _verify_case(seed, *, B=6, T=8, K=64, M=96, **kw):
    """A verify dispatch's inputs at T = D + 1 = 8: per slot a draft length
    n_write - 1 in 0..7 (positions at or past n_write drop their writes,
    index M), two inactive slots (every write dropped), and the causal
    mask among the T rows that `forward_verify` builds."""
    arrays, dtypes, kwargs = _case(seed, B=B, T=T, K=K, M=M, **kw)
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(0, K - T, B).astype(np.int32)
    n_write = np.array([8, 1, 5, 3, 8, 2][:B], np.int32)
    active = np.ones(B, bool)
    active[[1, 4]] = False
    pos = lengths[:, None] + np.arange(T, dtype=np.int32)[None, :]
    keep = (np.arange(T)[None, :] < n_write[:, None]) & active[:, None]
    arrays.update(lengths=lengths, widx=np.where(keep, pos, M).astype(np.int32),
                  mask=np.arange(K)[None, None, :] <= pos[:, :, None])
    return arrays, dtypes, kwargs


@pytest.mark.parametrize("case", [dict(), dict(qdtype="bfloat16", kvdtype="bfloat16")])
def test_plain_matches_jax_kernel_at_verify_shapes(case):
    """The verify half at T = 8 with mixed n_write and inactive slots: the
    plain version against the JAX kernel (interpret mode), the append bit
    for bit, and no dropped position written."""
    arrays, dtypes, kw = _verify_case(31, **case)
    want = _jax(arrays, dtypes, kw)
    got = _port(arrays, dtypes, kw)
    atol = BF16_ATOL if case.get("qdtype") == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0, err_msg="out")
    np.testing.assert_array_equal(got[1], want[1], err_msg="ck append")
    np.testing.assert_array_equal(got[2], want[2], err_msg="cv append")
    t = _to_torch(arrays, dtypes)
    untouched = np.ones(got[1].shape[:2], bool)
    for b in range(len(arrays["rows"])):
        for j in range(arrays["widx"].shape[1]):
            if arrays["widx"][b, j] < got[1].shape[1]:
                untouched[arrays["rows"][b], arrays["widx"][b, j]] = False
    np.testing.assert_array_equal(got[1][untouched], t["ck"].float().numpy()[untouched])


def test_append_is_in_place_and_drops_index_m():
    arrays, dtypes, kw = _case(3, T=4, K=48)
    t = _to_torch(arrays, dtypes)
    ck0 = t["ck"].clone()
    out, ck, cv = port.ragged_paged_attention(**t, **kw)
    assert ck is t["ck"] and cv is t["cv"]
    changed = (ck != ck0).any(dim=(2, 3)).nonzero().tolist()
    expect = sorted(
        [int(arrays["rows"][b]), int(w)]
        for b in range(4) for w in arrays["widx"][b] if w < 64
    )
    assert sorted(changed) == expect  # slot 0's dropped position wrote nothing


def test_plain_equals_dense_naive_attention():
    """Page-windowed read == append + full-window naive_attention when
    every attended column lies in the copied pages."""
    from areal_tpu_torch.ops.attention import naive_attention

    arrays, dtypes, kw = _case(5, K=32, page=16)
    t = _to_torch(arrays, dtypes)
    ck, cv = t["ck"].clone(), t["cv"].clone()
    out, _, _ = port.ragged_paged_attention(**t, **kw)
    rows = t["rows"].long()
    ck[rows, t["widx"][:, 0].long()] = t["k_new"][:, 0]
    cv[rows, t["widx"][:, 0].long()] = t["v_new"][:, 0]
    want = naive_attention(t["q"], ck[rows, :32], cv[rows, :32], t["mask"][:, None])
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)


def test_ragged_supported_gate():
    # Qwen2.5-1.5B decode: 12 q heads over 2 kv heads, hd 128.  The kernel's
    # shared memory is one key chunk plus the query and score rows, so the
    # key window does not bound it.
    assert port.ragged_supported(2048, 12, 2, 128)
    assert port.ragged_supported(16384, 12, 2, 128)
    assert port.smem_bytes(1, 6, 128, 2) == 64 * (128 * 2 + 16) + 4 * 6 * (128 + 64)
    assert port.smem_bytes(1, 6, 128) == 64 * (128 * 4 + 16) + 4 * 6 * (128 + 64)
    assert not port.ragged_supported(2048, 12, 5, 128)  # heads must group
    assert not port.ragged_supported(128, 4, 2, 100)  # hd not a multiple of 8
    assert not port.ragged_supported(128, 64, 1, 256, T=8)  # 512 rows overflow
    assert not port.ragged_supported(0, 12, 2, 128)
    # bf16 at hd <= 256: up to 16 query rows (T * group) a kv head run the
    # decode kernel ("dec"), a verify (T > 1) of 17 to 64 the verify kernel
    # ("tc"), each bounded by those caps; f32 or mixed calls and longer
    # verifies keep the CUDA-core passes, whose scores block grows with the
    # rows
    bf16, f32 = torch.bfloat16, torch.float32
    assert port.variant(bf16, bf16, 1, 6, 128) == "dec"  # Qwen2.5-1.5B's decode
    assert port.variant(bf16, bf16, 4, 6, 128) == "tc"
    assert port.variant(f32, bf16, 8, 6, 128) == "passes"
    assert port.variant(bf16, f32, 8, 6, 128) == "passes"
    assert port.variant(bf16, bf16, 8, 8, 256) == "tc"  # Gemma-2B's verify: 64 rows
    assert port.variant(bf16, bf16, 9, 8, 256) == "passes"  # 72 rows
    assert port.variant(bf16, bf16, 16, 6, 128) == "passes"  # Qwen2.5 drafting 15: 96
    assert port.variant(bf16, bf16, 2, 8, 512) == "passes"  # hd above 256
    assert port.variant(bf16, bf16, 1, 2, 16) == "passes"  # hd of no whole 64-column panel
    assert port.variant(bf16, bf16, 8, 2, 256) == "dec"  # Gemma-2-2B's: 16 rows
    assert port.variant(bf16, bf16, 4, 2, 128) == "dec"  # Qwen3-1.7B's at T = 4: 8
    assert port.variant(bf16, bf16, 3, 6, 128) == "tc"  # 18 rows
    assert port.variant(f32, f32, 1, 6, 128) == "passes"
    for T in (1, 4, 8):
        for group, hd in ((6, 128), (8, 256), (2, 256), (2, 128)):
            assert port.smem_bytes(T, group, hd, 2) == (64 * (hd * 2 + 16)
                                                        + 4 * T * group * (hd + 64))
    # the gate takes each call's path at every T from 1 to the verify's:
    # past the tensor cores' 64 rows the passes take up to 280 rows at hd
    # 128 (bf16 cache) and 155 at hd 256
    kw = dict(q_dtype=bf16, kv_dtype=bf16)
    assert port.ragged_supported(2048, 12, 2, 128, T=8, **kw)
    assert port.ragged_supported(2048, 8, 1, 256, T=8, **kw)  # 64 rows
    assert port.ragged_supported(2048, 12, 2, 128, T=16, **kw)  # 96 rows: the passes
    assert port.ragged_supported(2048, 8, 1, 256, T=9, **kw)  # 72 rows: the passes
    assert port.ragged_supported(2048, 16, 1, 128, T=8, **kw)  # 128 rows
    assert port.ragged_supported(2048, 1, 1, 128, T=280, **kw)
    assert not port.ragged_supported(2048, 1, 1, 128, T=281, **kw)
    assert port.ragged_supported(2048, 1, 1, 256, T=155, **kw)
    assert not port.ragged_supported(2048, 1, 1, 256, T=156, **kw)
    assert port.ragged_supported(2048, 16, 1, 128, T=8)  # f32: the passes' block
    assert port.ragged_supported(2048, 8, 1, 512, T=2, **kw)  # hd above 256: the passes


def test_chunk_plan_and_scratch():
    """Fixed chunks of CHUNK key positions; the wrapper's f32 scratch holds
    scores [B, Hkv, R, K], two chunk statistics [B, Hkv, R, chunks] and
    partial outputs [B, Hkv, chunks, R, hd] (R = T * Hq / Hkv)."""
    assert port.CHUNK == 64
    assert [port.n_chunks(k) for k in (1, 64, 65, 1024, 2048)] == [1, 1, 2, 16, 32]
    B, T, Hq, Hkv, hd, K = 16, 1, 12, 2, 128, 1024
    rows = B * Hkv * (T * Hq // Hkv)
    nc = port.n_chunks(K)
    assert port.scratch_floats(B, T, Hq, Hkv, hd, K) == rows * (K + 2 * nc + nc * hd)
    assert port.scratch_floats(1, 4, 4, 2, 8, 40) == 16 * (40 + 2 * 1 + 1 * 8)
    for T in (1, 4, 8):
        for Hq, Hkv, hd in ((12, 2, 128), (8, 1, 256)):
            rows = 8 * T * Hq
            assert port.scratch_floats(8, T, Hq, Hkv, hd, 1024) == rows * (
                1024 + 2 * 16 + 16 * hd)
            # the tensor-core kernel keeps everything on chip
            assert port.scratch_floats(8, T, Hq, Hkv, hd, 1024, tensor_cores=True) == 0


def test_wrapper_refuses_other_devices():
    arrays, dtypes, kw = _case(1)
    t = _to_torch(arrays, dtypes, "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.ragged_paged_attention(**t, **kw)


@pytest.mark.parametrize("bad", ["rows_int64", "mask_shape", "kv_dtype", "window",
                                 "passes_rows"])
def test_wrapper_checks(bad):
    arrays, dtypes, kw = _case(2)
    if bad == "passes_rows":  # a bf16 verify of 64 q heads on one kv head: 512 rows
        arrays, dtypes, kw = _case(2, T=8, Hq=64, Hkv=1, hd=256, qdtype="bfloat16",
                                   kvdtype="bfloat16")
    t = _to_torch(arrays, dtypes)
    K = kw["key_window"]
    if bad == "rows_int64":
        t["rows"] = t["rows"].long()
    elif bad == "mask_shape":
        t["mask"] = t["mask"][:, :, :-1].contiguous()
    elif bad == "kv_dtype":
        t["k_new"] = t["k_new"].double()
    elif bad == "window":  # an empty key window (any positive one fits: the kernel splits K)
        K = 0
        t["mask"] = torch.zeros(4, 1, K, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        port._check(t["q"], t["k_new"], t["v_new"], t["ck"], t["cv"], t["rows"],
                    t["lengths"], t["widx"], t["mask"], K)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(),
    dict(softcap=30.0),
    dict(K=40, page=16),
    dict(qdtype="bfloat16", kvdtype="bfloat16"),
    dict(qdtype="float32", kvdtype="bfloat16"),
    dict(T=4, K=48),
    dict(T=4, K=48, wide_mask=True),
    dict(B=16, Hq=12, Hkv=2, hd=128, K=2048, M=2048, page=128,
         qdtype="bfloat16", kvdtype="bfloat16"),
    # Gemma-2-2B decode (hd 256, group 2, softcap 50) on a sliding layer's
    # mask: a window that drops keys at K = 4096, its own 4096 at K = 8192
    dict(B=8, Hq=8, Hkv=4, hd=256, K=4096, M=4096, page=128, softcap=50.0, window=1000,
         qdtype="bfloat16", kvdtype="bfloat16"),
    dict(B=8, Hq=8, Hkv=4, hd=256, K=8192, M=8192, page=128, softcap=50.0, window=4096,
         qdtype="bfloat16", kvdtype="bfloat16"),
    # Qwen3-1.7B decode heads (group 2, hd 128)
    dict(B=8, Hq=16, Hkv=8, hd=128, K=2048, M=2048, page=128,
         qdtype="bfloat16", kvdtype="bfloat16"),
])
def test_cuda_kernel_matches_plain(cuda_device, case):
    arrays, dtypes, kw = _case(9, **case)
    before = port.ragged_paged_attention.launches
    before_verify = port.ragged_paged_attention.launches_verify
    got = _port(arrays, dtypes, kw, device=cuda_device)
    assert port.ragged_paged_attention.launches == before + 1
    # a launch at T > 1 is a verify's, counted apart as well
    assert (port.ragged_paged_attention.launches_verify
            == before_verify + int(case.get("T", 1) > 1))
    want = _port(arrays, dtypes, kw, fn=port.ragged_paged_attention_plain,
                 device=cuda_device)
    atol = BF16_ATOL if case.get("qdtype") == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _edge_case(kind):
    """Qwen2.5's decode heads in bf16, T=4 verify tiles at K=256 over a
    512-position cache, with one edge each: write positions straddling the
    chunk boundary at 64, a write into [K, M) (stored, never read), or a
    query row whose every column is masked (a uniform average over K)."""
    arrays, dtypes, kw = _case(21, B=4, T=4, K=256, M=512, page=128, Hq=12, Hkv=2,
                               hd=128, qdtype="bfloat16", kvdtype="bfloat16")
    lengths, widx, mask = arrays["lengths"], arrays["widx"], arrays["mask"]
    key_pos = np.arange(256)
    if kind == "chunk_boundary":
        lengths[0] = 62
        widx[0] = 62 + np.arange(4)
        mask[0] = key_pos[None, :] <= widx[0][:, None]
    elif kind == "tail_write":
        widx[1, -1] = 300
    else:
        mask[2, 0] = False
    return arrays, dtypes, kw


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["chunk_boundary", "tail_write", "all_masked"])
def test_cuda_kernel_edge_cases(cuda_device, kind):
    arrays, dtypes, kw = _edge_case(kind)
    got = _port(arrays, dtypes, kw, device=cuda_device)
    want = _port(arrays, dtypes, kw, fn=port.ragged_paged_attention_plain,
                 device=cuda_device)
    np.testing.assert_allclose(got[0], want[0], atol=BF16_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert np.isfinite(got[0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(qdtype="bfloat16", kvdtype="bfloat16"),
    dict(),
    # Qwen2.5-1.5B's heads at a serving window, bf16
    dict(Hq=12, Hkv=2, hd=128, K=1024, M=1024, page=128, qdtype="bfloat16",
         kvdtype="bfloat16"),
    # the tensor-core kernel at hd 64 (half its warps idle in P V), and at a
    # key window of one short chunk whose mask rows are not 16-byte aligned
    dict(Hq=8, Hkv=2, hd=64, K=256, M=256, page=64, qdtype="bfloat16",
         kvdtype="bfloat16"),
    dict(K=40, page=16, Hq=6, qdtype="bfloat16", kvdtype="bfloat16"),
])
def test_cuda_kernel_matches_plain_at_verify_shapes(cuda_device, case):
    """The CUDA kernel at T = 8 with mixed n_write and inactive slots
    against its plain version; the appended cache bit for bit."""
    arrays, dtypes, kw = _verify_case(33, **case)
    before_verify = port.ragged_paged_attention.launches_verify
    got = _port(arrays, dtypes, kw, device=cuda_device)
    assert port.ragged_paged_attention.launches_verify == before_verify + 1
    want = _port(arrays, dtypes, kw, fn=port.ragged_paged_attention_plain,
                 device=cuda_device)
    atol = BF16_ATOL if case.get("qdtype") == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _variant_counts():
    w = port.ragged_paged_attention
    return np.array([w.launches_dec, w.launches_tc, w.launches])


def _ran(before, n=1):
    """The variant of the last `n` calls since `before` (`_variant_counts`)."""
    dec, tc, total = _variant_counts() - before
    assert total == n
    return "dec" if dec == n else "tc" if tc == n else "passes" if dec == tc == 0 else "mixed"


@pytest.mark.gpu
@pytest.mark.parametrize("T,dtype,Hq,Hkv,expect", [
    (8, "bfloat16", 12, 2, "tc"), (1, "bfloat16", 12, 2, "dec"), (8, "float32", 12, 2, "passes"),
    (16, "bfloat16", 12, 2, "passes"), (8, "bfloat16", 16, 8, "dec")])
def test_cuda_kernel_variant(cuda_device, T, dtype, Hq, Hkv, expect):
    """A bf16 call of at most 16 rows a kv head (decode, Qwen3-1.7B's heads
    at T = 8) launches the decode kernel, a bf16 verify of 17 to 64 rows
    the verify kernel; f32 and a verify of 96 rows (a draft of 15 at
    Qwen2.5's heads) the CUDA-core passes; each counted once, as `variant`
    says, and against the plain version."""
    arrays, dtypes, kw = _case(35, B=8, T=T, Hq=Hq, Hkv=Hkv, hd=128, K=1024, M=1024,
                               page=128, qdtype=dtype, kvdtype=dtype)
    dt = getattr(torch, dtype)
    assert port.variant(dt, dt, T, Hq // Hkv, 128) == expect
    before = _variant_counts()
    got = _port(arrays, dtypes, kw, device=cuda_device)
    assert _ran(before) == expect
    want = _port(arrays, dtypes, kw, fn=port.ragged_paged_attention_plain,
                 device=cuda_device)
    np.testing.assert_allclose(got[0], want[0], atol=BF16_ATOL if dtype == "bfloat16"
                               else F32_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_kernel_batch_invariant_and_deterministic(cuda_device):
    """Chunk boundaries are fixed key positions and nothing is combined by
    atomics, on every variant: a slot's output is bit-equal alone (B=1) and
    inside the grid, and two runs are bit-equal; bf16 decode (B=16) and a
    bf16 verify at Qwen3-1.7B's heads (T = 8, 16 rows) on the decode
    kernel, a bf16 verify at Qwen2.5's (48 rows) on the verify kernel, f32
    decode on the CUDA-core passes (the verifies with mixed n_write and
    inactive slots)."""
    bf16 = dict(qdtype="bfloat16", kvdtype="bfloat16")
    for (arrays, dtypes, kw), slots, want in (
            (_case(23, B=16, Hq=12, Hkv=2, hd=128, K=2048, M=2048, page=128, **bf16),
             (0, 5), "dec"),
            (_verify_case(25, Hq=16, Hkv=8, hd=128, K=1024, M=1024, page=128, **bf16),
             (0, 1, 2), "dec"),
            (_verify_case(24, Hq=12, Hkv=2, hd=128, K=1024, M=1024, page=128, **bf16),
             (0, 1, 2), "tc"),
            (_case(26, B=16, Hq=12, Hkv=2, hd=128, K=2048, M=2048, page=128), (0, 5),
             "passes")):
        before = _variant_counts()
        full = _port(arrays, dtypes, kw, device=cuda_device)
        again = _port(arrays, dtypes, kw, device=cuda_device)
        assert _ran(before, 2) == want
        for a, b in zip(full, again):
            np.testing.assert_array_equal(a, b)
        for slot in slots:
            alone = {k: (v if k in ("ck", "cv") else v[slot:slot + 1])
                     for k, v in arrays.items()}
            one = _port(alone, dtypes, kw, device=cuda_device)
            np.testing.assert_array_equal(one[0][0], full[0][slot])


def _c_rule():
    """`ragged_decode_launch`'s choice of variant, read from the CUDA source:
    its row caps, the decode kernel's head dims, and the two conditions in
    the order the entry point tests them."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(port.__file__), "..", "csrc",
                            "ragged_decode.cu")).read()

    def const(ns, name):
        body = src[src.index(f"namespace {ns} {{"):]
        return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))

    dec_max, tc_min, tc_max = const("dec", "kMaxRows"), const("tc", "kMinRows"), const(
        "tc", "kMaxRows")
    dec_hds = tuple(int(x) for x in re.findall(
        r"hd == (\d+)", re.search(r"bool takes_hd\(int hd\) \{([^}]*)\}", src).group(1)))
    entry = src[src.index('extern "C" int ragged_decode_launch'):]
    dec_at = entry.index("q_bf16 && kv_bf16 && dec::takes_hd(hd) && R <= dec::kMaxRows)")
    tc_at = entry.index("q_bf16 && kv_bf16 && hd <= 256 && T > 1 && R >= tc::kMinRows && "
                        "R <= tc::kMaxRows)")
    assert dec_at < tc_at

    def rule(bf16, T, group, hd):
        R = T * group
        if bf16 and hd in dec_hds and R <= dec_max:
            return "dec"
        if bf16 and hd <= 256 and T > 1 and tc_min <= R <= tc_max:
            return "tc"
        return "passes"

    return rule, (dec_max, tc_min, tc_max, dec_hds)


def test_variant_rule_matches_the_cuda_entry_point():
    """`variant` mirrors `ragged_decode_launch`: the same caps (16 rows at
    hd 64, 128 or 256 for the decode kernel, 17 to 64 at T > 1 and hd <=
    256 for the verify kernel), and the same variant for every dtype pair,
    T, group and head dim, including each family's decode and verify
    shapes."""
    rule, caps = _c_rule()
    assert caps == (port.DEC_MAX_ROWS, port.TC_MIN_ROWS, port.TC_MAX_ROWS,
                    port.DEC_HEAD_DIMS) == (16, 17, 64, (64, 128, 256))
    assert port.TC_MAX_HEAD_DIM == 256
    bf16, f32 = torch.bfloat16, torch.float32
    for q_dt, kv_dt in ((bf16, bf16), (f32, f32), (bf16, f32), (f32, bf16)):
        for T in (1, 2, 3, 4, 8, 9, 16):
            for group in (1, 2, 6, 8, 16, 32):
                for hd in (16, 32, 64, 96, 128, 192, 256, 512):
                    both = q_dt == kv_dt == bf16
                    assert port.variant(q_dt, kv_dt, T, group, hd) == rule(both, T, group, hd)
    # every family's decode takes the decode kernel in bf16
    for group, hd in ((6, 128), (2, 128), (2, 256), (8, 256), (4, 128), (1, 64)):
        assert port.variant(bf16, bf16, 1, group, hd) == "dec"
        assert port.variant(f32, f32, 1, group, hd) == "passes"
    # a head dim that is not whole 64-column panels keeps the passes (tiny
    # test models' hd 16), or the verify kernel at 17 to 64 rows
    assert port.variant(bf16, bf16, 1, 2, 16) == "passes"
    assert port.variant(bf16, bf16, 4, 6, 16) == "tc"


def _family_case(kind, seed):
    """bf16 inputs at one family's decode (T = 1) or <= 16-row verify shape:
    (arrays, dtypes, kwargs)."""
    bf16 = dict(qdtype="bfloat16", kvdtype="bfloat16", page=128)
    heads = {
        "qwen2.5": dict(Hq=12, Hkv=2, hd=128, K=1024, M=1024),
        "qwen3": dict(Hq=16, Hkv=8, hd=128, K=1024, M=1024),
        "gemma2": dict(Hq=8, Hkv=4, hd=256, K=8192, M=8192, softcap=50.0, window=4096),
        "gemma1": dict(Hq=8, Hkv=1, hd=256, K=2048, M=2048),
    }
    family, T = kind
    if T == 1:
        return _case(seed, B=8, **heads[family], **bf16)
    return _verify_case(seed, T=T, **heads[family], **bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [("qwen2.5", 1), ("qwen3", 1), ("gemma2", 1), ("gemma1", 1),
                                  ("qwen3", 4), ("qwen3", 8), ("gemma2", 4), ("gemma2", 8)],
                         ids=lambda k: f"{k[0]}-T{k[1]}" if isinstance(k, tuple) else str(k))
def test_cuda_decode_kernel_at_family_shapes(cuda_device, kind):
    """The decode kernel at each family's decode and <= 16-row verify: out
    within the bf16 tolerance of the plain version, the caches bit-equal,
    two runs bit-equal, and slots run alone bit-equal to the grid."""
    arrays, dtypes, kw = _family_case(kind, 41)
    before = _variant_counts()
    got = _port(arrays, dtypes, kw, device=cuda_device)
    again = _port(arrays, dtypes, kw, device=cuda_device)
    assert _ran(before, 2) == "dec"
    want = _port(arrays, dtypes, kw, fn=port.ragged_paged_attention_plain,
                 device=cuda_device)
    np.testing.assert_allclose(got[0], want[0], atol=BF16_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    for slot in (0, 2, 5):
        alone = {k: (v if k in ("ck", "cv") else v[slot:slot + 1]) for k, v in arrays.items()}
        one = _port(alone, dtypes, kw, device=cuda_device)
        np.testing.assert_array_equal(one[0][0], got[0][slot])
