"""The torch port's fused LM head (`areal_tpu_torch/ops/fused_xent.py`)
against `areal_tpu/ops/fused_xent.py`: logprobs, entropy, argmax-correct
and the gradients of a weighted sum of logprobs and entropy with respect
to the hidden states and the head, in f32 on the CPU, for chunk widths
that divide the vocab and that do not, with the entropy gradient on and
off."""

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops.fused_xent import fused_logprobs_entropy, vocab_chunk

# f32 on both sides; the chunk products and exp sums run in another order
# (XLA against torch) over D = 32 and V = 300 -> 1e-5 on values, 1e-5
# relative to the largest element on gradients.
ATOL = 1e-5
GRAD_RTOL = 1e-5


def _inputs(seed, N=24, D=32, V=300):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    a = rng.standard_normal(N).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return h, head, labels, a, b


def test_vocab_chunk_is_a_multiple_of_128():
    assert vocab_chunk(151936, 8192) == 8192
    assert vocab_chunk(300, 8192) == 384
    assert vocab_chunk(300, 100) == 128


@pytest.mark.parametrize("chunk,entropy_grad,temperature", [
    (128, False, 1.0),  # 300 = 2 x 128 + a masked tail of 84
    (256, True, 0.7),
    (8192, True, 1.0),  # one chunk wider than the vocab
])
def test_fused_head_matches_jax(chunk, entropy_grad, temperature):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.fused_xent import fused_logprobs_entropy as jax_fused

    h, head, labels, a, b = _inputs(chunk)

    def jloss(h_, w_):
        lp, ent, corr = jax_fused(h_, w_, jnp.asarray(labels), temperature=temperature,
                                  vocab_chunk=chunk, entropy_grad=entropy_grad)
        return (lp * a).sum() + (ent * b).sum(), (lp, ent, corr)

    (_, (jlp, jent, jcorr)), (jdh, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(head))

    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    lp, ent, corr = fused_logprobs_entropy(th, tw, torch.from_numpy(labels),
                                           temperature=temperature, vocab_chunk_width=chunk,
                                           entropy_grad=entropy_grad)
    ((lp * torch.from_numpy(a)).sum() + (ent * torch.from_numpy(b)).sum()).backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jcorr))
    for got, want in ((th.grad, jdh), (tw.grad, jdw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < GRAD_RTOL


def test_fused_head_matches_materialised_logits():
    """Torch against torch: the chunked head equals log-softmax over the
    full f32 logits, and with entropy_grad its gradient equals autograd's
    (tolerances as against JAX)."""
    h, head, labels, a, b = _inputs(4)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    lp, ent, _ = fused_logprobs_entropy(th, tw, torch.from_numpy(labels),
                                        vocab_chunk_width=128, entropy_grad=True)
    ((lp * torch.from_numpy(a)).sum() + (ent * torch.from_numpy(b)).sum()).backward()
    rh = torch.tensor(h, requires_grad=True)
    rw = torch.tensor(head, requires_grad=True)
    logp_all = torch.log_softmax(rh @ rw, dim=-1)
    rlp = logp_all.gather(-1, torch.from_numpy(labels).long()[:, None])[:, 0]
    rent = -(logp_all.exp() * logp_all).sum(-1)
    ((rlp * torch.from_numpy(a)).sum() + (rent * torch.from_numpy(b)).sum()).backward()
    torch.testing.assert_close(lp, rlp, atol=ATOL, rtol=0)
    torch.testing.assert_close(ent, rent, atol=ATOL, rtol=0)
    for got, want in ((th.grad, rh.grad), (tw.grad, rw.grad)):
        assert (got - want).abs().max() / want.abs().max() < GRAD_RTOL
