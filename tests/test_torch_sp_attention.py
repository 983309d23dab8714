"""The port's flash attention at a query offset (one sequence-parallel
shard's rows against the whole row's K/V, `_sharded_splash`'s function)
against the JAX package.

- The plain offset functions, run shard by shard at sp = 2 (outputs
  concatenated, dq concatenated, dK/dV partials summed), against
  `areal_tpu`'s `segment_attention(impl="splash", mesh=build_mesh(sp=2))`
  in interpret mode on the virtual CPU devices `tests/conftest.py` sets
  up: packed segments with tail padding, B = 2, T = 256, hd 128, one
  splash call (forward and gradients together).  The tolerances are
  `test_torch_flash_attention.py`'s for the unsharded plain forward.
- The shards' dq and summed dK/dV against the port's unsharded plain
  backward and against JAX's naive gradient.
- Offset 0 with the keys' ids given is bit-equal to the call without
  them, for the plain functions and the autograd op.
- Window and softcap at sp = 2 and 4 against the unsharded plain
  functions, with a window that does not divide the shard.
- The sp gate of `flash_supported`, and `attn_impl="ring"` under an sp
  mesh raising (ring attention is not ported).
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import attention as port_attn
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OUT_ATOL = 1e-4  # as test_torch_flash_attention.py: f32, another summation order
GRAD_RTOL = 1e-3
# the port's shards against its own unsharded plain functions: the same f32
# products, the dK/dV partials summed in another order
PORT_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    from areal_tpu.ops import attention as jax_attn

    monkeypatch.setattr(jax_attn, "INTERPRET", True)


def _packed(seed, B=2, T=256, Hq=4, Hkv=2, hd=128, n_segs=3):
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
    g = g * (seg >= 0)[..., None, None]  # pad rows reach no loss
    return q, k, v, g, seg, pos


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-9)


def _sharded(q, k, v, g, seg, sp, window=None, softcap=None):
    """The autograd op shard by shard: (out, dq) concatenated over the
    shards, dK and dV the shards' partials summed."""
    T = q.shape[1]
    n = T // sp
    kk = torch.tensor(k, requires_grad=True)
    vv = torch.tensor(v, requires_grad=True)
    kv_seg = torch.from_numpy(seg)
    outs, dqs = [], []
    for s in range(sp):
        a = s * n
        qs = torch.tensor(q[:, a:a + n], requires_grad=True)
        out = fa.segment_flash_attention(qs, kk, vv, kv_seg[:, a:a + n], window, softcap,
                                         q_start=a, kv_segment_ids=kv_seg)
        (out * torch.from_numpy(g[:, a:a + n])).sum().backward()
        outs.append(out.detach().numpy())
        dqs.append(qs.grad.numpy())
    return (np.concatenate(outs, 1), np.concatenate(dqs, 1), kk.grad.numpy(),
            vv.grad.numpy())


def _unsharded(q, k, v, g, seg, window=None, softcap=None):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.segment_flash_attention(tq, tk, tv, torch.from_numpy(seg), window, softcap)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


def test_offset_shards_match_sharded_splash(interpret):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.attention import segment_attention
    from areal_tpu.parallel.mesh import build_mesh

    q, k, v, g, seg, pos = _packed(3)
    mesh = build_mesh(dp=1, fsdp=1, sp=2, tp=1)

    @jax.jit
    def out_and_grads(q_, k_, v_):
        def loss(a, b, c):
            o = segment_attention(a, b, c, jnp.asarray(seg), jnp.asarray(pos), impl="splash",
                                  mesh=mesh)
            return (o * jnp.asarray(g)).sum(), o

        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q_, k_, v_)

    with mesh:
        (_, ref), ref_grads = out_and_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, dq, dk, dv = _sharded(q, k, v, g, seg, sp=2)
    valid = seg >= 0
    assert np.abs(out - np.asarray(ref))[valid].max() < OUT_ATOL
    assert not out[~valid].any()
    mask = valid[..., None, None]
    for name, a, b in zip("qkv", (dq, dk, dv), ref_grads):
        assert _rel(a * mask, np.asarray(b) * mask) < GRAD_RTOL, name


def test_offset_grads_match_unsharded_and_naive():
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.attention import segment_attention

    q, k, v, g, seg, pos = _packed(5)
    out, dq, dk, dv = _sharded(q, k, v, g, seg, sp=2)
    u_out, u_dq, u_dk, u_dv = _unsharded(q, k, v, g, seg)
    np.testing.assert_array_equal(out, u_out)  # each row's arithmetic is the unsharded row's
    for a, b in ((dq, u_dq), (dk, u_dk), (dv, u_dv)):
        assert _rel(a, b) < PORT_RTOL

    def loss(a, b, c):
        o = segment_attention(a, b, c, jnp.asarray(seg), jnp.asarray(pos), impl="naive")
        return (o * jnp.asarray(g)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    mask = (seg >= 0)[..., None, None]
    for name, a, b in zip("qkv", (dq, dk, dv), ref):
        assert _rel(a * mask, np.asarray(b) * mask) < GRAD_RTOL, name


@pytest.mark.parametrize("window,softcap", [(None, None), (48, None), (None, 30.0)])
def test_offset_zero_is_todays_call(window, softcap):
    q, k, v, g, seg, _ = (torch.from_numpy(x) for x in _packed(7, B=1))
    qs = fa.scale_query(q)
    out, lse = fa.flash_fwd_plain(qs, k, v, seg, window, softcap)
    out0, lse0 = fa.flash_fwd_plain(qs, k, v, seg, window, softcap, 0, seg)
    assert torch.equal(out, out0) and torch.equal(lse, lse0)
    di = fa.attention_di(out, g)
    dq = fa.flash_bwd_dq_plain(qs, k, v, seg, g, lse, di, window, softcap)
    dq0 = fa.flash_bwd_dq_plain(qs, k, v, seg, g, lse, di, window, softcap, 0, seg)
    dk, dv = fa.flash_bwd_dkv_plain(qs, k, v, seg, g, lse, di, window, softcap)
    dk0, dv0 = fa.flash_bwd_dkv_plain(qs, k, v, seg, g, lse, di, window, softcap, 0, seg)
    assert torch.equal(dq, dq0) and torch.equal(dk, dk0) and torch.equal(dv, dv0)
    a = _unsharded(*(x.numpy() for x in (q, k, v, g, seg)), window, softcap)
    b = _sharded(*(x.numpy() for x in (q, k, v, g, seg)), 1, window, softcap)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sp,window,softcap", [(2, 48, None), (2, None, 30.0), (4, 48, 30.0),
                                               (4, None, None)])
def test_offset_window_and_softcap(sp, window, softcap):
    """Shards at sp 2 and 4 (q_start 64, 128, 192: a window of 48 crosses
    every shard's start) against the unsharded plain functions; each
    shard's dk/dv partial is exactly 0 on keys past its last query."""
    q, k, v, g, seg, _ = _packed(11, n_segs=2)
    out, dq, dk, dv = _sharded(q, k, v, g, seg, sp, window, softcap)
    u_out, u_dq, u_dk, u_dv = _unsharded(q, k, v, g, seg, window, softcap)
    np.testing.assert_array_equal(out, u_out)
    for a, b in ((dq, u_dq), (dk, u_dk), (dv, u_dv)):
        assert _rel(a, b) < PORT_RTOL
    n = q.shape[1] // sp
    qs = fa.scale_query(torch.from_numpy(q[:, :n]))
    kv_seg = torch.from_numpy(seg)
    o, lse = fa.flash_fwd_plain(qs, torch.from_numpy(k), torch.from_numpy(v), kv_seg[:, :n],
                                window, softcap, 0, kv_seg)
    gg = torch.from_numpy(g[:, :n])
    pk, pv = fa.flash_bwd_dkv_plain(qs, torch.from_numpy(k), torch.from_numpy(v),
                                    kv_seg[:, :n], gg, lse, fa.attention_di(o, gg), window,
                                    softcap, 0, kv_seg)
    assert not pk[:, n:].any() and not pv[:, n:].any()


def test_sp_gate_and_ring_under_a_mesh():
    assert fa.flash_supported(256, 12, 2, 128, sp=2)
    assert not fa.flash_supported(384, 12, 2, 128, sp=2)  # 192-row shards
    assert fa.flash_supported(512, 12, 2, 128, sp=4) and not fa.flash_supported(256, 12, 2, 128,
                                                                                  sp=4)
    mesh = Mesh(shape=dict(dp=1, fsdp=1, ep=1, sp=2, tp=1),
                coords=dict(dp=0, fsdp=0, ep=0, sp=1, tp=0), groups={"sp": None}, group=None)
    seg = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ring"):
        port_attn.make_segment_attention(seg, seg, 4, 2, 128, attn_impl="ring", mesh=mesh)
    with pytest.warns(UserWarning, match="ring"):  # without an sp axis it warns, as JAX does
        port_attn.make_segment_attention(seg, seg, 4, 2, 128, attn_impl="ring")
