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

# out: f32 sums of <= 48 products in another order than XLA's -> 1e-5.
# bf16: both frameworks round scores/probabilities/out to bf16 after f32
# sums in their own order, so an element may sit one bf16 step (2^-8
# relative) apart; 2e-2 covers that at these magnitudes (|out| < 2).
# The appended cache is a copy of the inputs: compared exactly.
F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _case(seed, *, B=4, T=1, K=32, page=16, M=64, Hq=4, Hkv=2, hd=8,
          qdtype="float32", kvdtype="float32", softcap=None, wide_mask=False):
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
])
def test_plain_matches_jax_kernel(case):
    arrays, dtypes, kw = _case(7, **case)
    want = _jax(arrays, dtypes, kw)
    got = _port(arrays, dtypes, kw)
    atol = BF16_ATOL if case.get("qdtype") == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=0, err_msg="out")
    np.testing.assert_array_equal(got[1], want[1], err_msg="ck append")
    np.testing.assert_array_equal(got[2], want[2], err_msg="cv append")


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


def test_wrapper_refuses_other_devices():
    arrays, dtypes, kw = _case(1)
    t = _to_torch(arrays, dtypes, "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.ragged_paged_attention(**t, **kw)


@pytest.mark.parametrize("bad", ["rows_int64", "mask_shape", "kv_dtype", "window"])
def test_wrapper_checks(bad):
    arrays, dtypes, kw = _case(2)
    t = _to_torch(arrays, dtypes)
    K = kw["key_window"]
    if bad == "rows_int64":
        t["rows"] = t["rows"].long()
    elif bad == "mask_shape":
        t["mask"] = t["mask"][:, :, :-1].contiguous()
    elif bad == "kv_dtype":
        t["k_new"] = t["k_new"].double()
    else:  # an empty key window (any positive one fits: the kernel splits K)
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
])
def test_cuda_kernel_matches_plain(cuda_device, case):
    arrays, dtypes, kw = _case(9, **case)
    before = port.ragged_paged_attention.launches
    got = _port(arrays, dtypes, kw, device=cuda_device)
    assert port.ragged_paged_attention.launches == before + 1
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
def test_cuda_kernel_batch_invariant_and_deterministic(cuda_device):
    """Chunk boundaries are fixed key positions and nothing is combined by
    atomics: a slot's output is bit-equal alone (B=1) and inside the B=16
    grid, and two runs are bit-equal."""
    arrays, dtypes, kw = _case(23, B=16, Hq=12, Hkv=2, hd=128, K=2048, M=2048, page=128,
                               qdtype="bfloat16", kvdtype="bfloat16")
    full = _port(arrays, dtypes, kw, device=cuda_device)
    again = _port(arrays, dtypes, kw, device=cuda_device)
    for a, b in zip(full, again):
        np.testing.assert_array_equal(a, b)
    for slot in (0, 5):
        alone = {k: (v if k in ("ck", "cv") else v[slot:slot + 1]) for k, v in arrays.items()}
        one = _port(alone, dtypes, kw, device=cuda_device)
        np.testing.assert_array_equal(one[0][0], full[0][slot])
