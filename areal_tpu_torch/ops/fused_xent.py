"""Fused LM-head logprobs / entropy with a hand-written backward (the port
of `areal_tpu/ops/fused_xent.py`, a custom VJP that JAX leaves to XLA; here
a `torch.autograd.Function` over `torch.matmul` chunk products).

The [tokens, vocab] f32 logits never exist whole:

- forward: one pass over vocab chunks keeps running (max, sumexp,
  sum(exp * logit), picked logit, argmax) carries of size [N]; a chunk's
  logits exist only as one [N, cv] block;
- backward: recomputes each chunk's logits once, forms
  g_lp * (onehot - p) (plus g_ent * p * (mu - logit) only when
  `entropy_grad` is set), accumulates dx in an f32 [N, D] buffer and
  writes each dW vocab slice once;
- the argmax "correct" output is gradient-free.

The last chunk is narrower when the chunk width does not divide the vocab:
that is the JAX version's padded tail with its -1e30 logits dropped, which
contribute exactly nothing to any carry.  Chunk products run in the input
dtype (f32 accumulation inside the matmul, rounded once to the input
dtype, as XLA's bf16 dot does); dx sums them in f32.
"""

from typing import Tuple

import torch

NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def vocab_chunk(v: int, target: int) -> int:
    """Chunk width: a multiple of 128, capped at the vocab rounded up to 128
    (the JAX package's `_vocab_chunk`)."""
    return min(_round_up(v, 128), _round_up(target, 128))


def _chunk_logits(h, head, s, e, inv_t):
    return (h @ head[:, s:e]).float() * inv_t


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, head, labels, inv_t, cv, with_entropy, entropy_grad):
        N = h.shape[0]
        V = head.shape[1]
        dev = h.device
        m = torch.full((N,), NEG, dtype=torch.float32, device=dev)
        s_sum = torch.zeros(N, dtype=torch.float32, device=dev)
        mu_un = torch.zeros(N, dtype=torch.float32, device=dev)
        picked = torch.zeros(N, dtype=torch.float32, device=dev)
        amax_v = torch.full((N,), NEG, dtype=torch.float32, device=dev)
        amax_i = torch.zeros(N, dtype=torch.long, device=dev)
        rows = torch.arange(N, device=dev)
        for s in range(0, V, cv):
            e = min(s + cv, V)
            logits = _chunk_logits(h, head, s, e, inv_t)
            cm = logits.amax(dim=-1)
            m_new = torch.maximum(m, cm)
            alpha = torch.exp(m - m_new)
            ex = torch.exp(logits - m_new[:, None])
            s_sum = s_sum * alpha + ex.sum(dim=-1)
            rel = labels - s
            inrange = (rel >= 0) & (rel < e - s)
            got = logits[rows, rel.clamp(0, e - s - 1)]
            picked = torch.where(inrange, got, picked)
            if with_entropy:
                mu_un = mu_un * alpha + (ex * logits).sum(dim=-1)
                ci = logits.argmax(dim=-1) + s
                better = cm > amax_v
                amax_v = torch.where(better, cm, amax_v)
                amax_i = torch.where(better, ci, amax_i)
            m = m_new
        logz = m + torch.log(s_sum)
        logp = picked - logz
        if with_entropy:
            mu = mu_un / s_sum
            ent = logz - mu
            corr = (amax_i == labels).float()
        else:
            mu = torch.zeros_like(logz)
            ent = torch.zeros_like(logz)
            corr = torch.zeros_like(logz)
        ctx.save_for_backward(h, head, labels, logz, mu)
        ctx.inv_t, ctx.cv, ctx.entropy_grad = inv_t, cv, entropy_grad
        ctx.mark_non_differentiable(corr)
        return logp, ent, corr

    @staticmethod
    def backward(ctx, g_lp, g_ent, _g_corr):
        h, head, labels, logz, mu = ctx.saved_tensors
        inv_t, cv = ctx.inv_t, ctx.cv
        N, D = h.shape
        V = head.shape[1]
        g_lp = g_lp.float()
        g_ent = g_ent.float()
        dx = torch.zeros((N, D), dtype=torch.float32, device=h.device)
        dhead = torch.empty((V, D), dtype=head.dtype, device=h.device)  # [V, D]; returned as [D, V]
        for s in range(0, V, cv):
            e = min(s + cv, V)
            wc = head[:, s:e]
            logits = _chunk_logits(h, head, s, e, inv_t)
            p = torch.exp(logits - logz[:, None])
            onehot = (torch.arange(e - s, device=h.device)[None, :]
                      == (labels - s)[:, None]).float()
            d = g_lp[:, None] * (onehot - p)
            if ctx.entropy_grad:
                # d ent / d logit_v = p_v * (mu - logit_v)
                d = d + g_ent[:, None] * p * (mu[:, None] - logits)
            draw = (d * inv_t).to(h.dtype)  # back through the scale and cast
            dx += (draw @ wc.t()).float()
            dhead[s:e] = draw.t() @ h
        return dx.to(h.dtype), dhead.t(), None, None, None, None, None


def fused_logprobs_entropy(
    hidden: torch.Tensor,  # [N, D]
    head: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # int [N]
    temperature: float = 1.0,
    vocab_chunk_width: int = 8192,
    with_entropy: bool = True,
    entropy_grad: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logprobs, entropy, argmax-correct) of `labels`, f32 [N] each.
    `entropy_grad=False` drops the entropy term from the backward; the
    entropy values are exact either way."""
    cv = vocab_chunk(head.shape[1], vocab_chunk_width)
    return _FusedXent.apply(hidden, head, labels.long(), float(1.0 / temperature), cv,
                            bool(with_entropy), bool(entropy_grad))
