"""The torch port's training forward against the JAX package.

`forward` / `forward_lm` / `forward_hidden` of `areal_tpu_torch.models.
transformer` run on packed multi-segment rows (built by the port's copy of
`pack_into_rows`) from the JAX tree moved over by the weight bridge as f32
masters, against `areal_tpu.models.forward`, in f32 on the CPU; a
head-dim-128 config at T = 256 takes the port's flash path (its plain
version here) where JAX takes the naive one.  Torch against torch, the
`full` remat rung gives bit-identical losses and gradients.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import transformer as pt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops.functional import lm_logprobs_entropy
from areal_tpu_torch.utils.data import pack_into_rows

# logits: f32 on both sides, products in another order over two layers of
# widths <= 256 -> 1e-4 (as tests/test_torch_model.py).
ATOL = 1e-4
QWEN_KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
               eos_token_id=None)


def _models(kw, seed=0):
    import jax

    from areal_tpu.models import init_params
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**kw)
    tree = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for k in ("bq", "bk", "bv"):
        shape = tree["layers"]["attn"][k].shape
        tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    cfg = tiny_config(**kw)
    model = params_from_jax(tree, cfg, device="cpu", param_dtype="float32", trainable=True)
    return jcfg, tree, cfg, model


def _rows(seed, lens, row_len, V):
    rng = np.random.default_rng(seed)
    L = max(lens)
    mask = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    ids = rng.integers(0, V, (len(lens), L)).astype(np.int32) * mask
    rp = pack_into_rows({"input_ids": ids, "attention_mask": mask}, row_len)
    return rp.data["input_ids"], rp.data["positions"], rp.data["segment_ids"]


@pytest.mark.parametrize("kw,lens,row_len", [
    (dict(QWEN_KW), [9, 17, 5, 30, 12], 32),
    (dict(QWEN_KW, tie_word_embeddings=True), [9, 17, 5, 30, 12], 32),
    (dict(QWEN_KW, hidden_size=256, num_heads=2, num_kv_heads=1, num_layers=1),
     [100, 60, 70, 200], 256),
], ids=["untied", "tied", "flash-path"])
def test_forward_matches_jax_on_packed_rows(kw, lens, row_len):
    from areal_tpu.models import forward as jax_forward

    jcfg, tree, cfg, model = _models(kw)
    ids, pos, seg = _rows(1, lens, row_len, cfg.vocab_size)
    assert (seg.max(axis=-1) >= 1).any()  # at least one multi-segment row
    ref = np.asarray(jax_forward(tree, jcfg, ids, pos, seg))
    t = [torch.from_numpy(x) for x in (ids, pos, seg)]
    before = fa.flash_fwd.launches
    with torch.no_grad():
        logits = pt.forward(model, *t).numpy()
        out = pt.forward_lm(model, *t)
    assert fa.flash_fwd.launches == before  # CPU: plain versions only
    valid = seg >= 0
    np.testing.assert_allclose(logits[valid], ref[valid], atol=ATOL, rtol=0)
    lm = (out.hidden @ out.head).detach().numpy()
    np.testing.assert_allclose(lm[valid], ref[valid], atol=ATOL, rtol=0)
    assert out.head.shape == (cfg.hidden_size, cfg.vocab_size)
    assert pt.forward_hidden(model, *t).shape == (*ids.shape, cfg.hidden_size)


def _loss_and_grads(model, t):
    model.zero_grad(set_to_none=True)
    out = pt.forward_lm(model, *t)
    labels = torch.roll(t[0], -1, dims=-1)
    lp, ent, _ = lm_logprobs_entropy(out, labels, vocab_chunk=128)
    w = (t[2] >= 0).float()
    loss = -(lp * w).sum() + 0.1 * (ent * w).sum()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("hd128", [False, True], ids=["naive", "flash"])
def test_full_remat_is_bit_identical(hd128):
    kw = dict(QWEN_KW)
    if hd128:
        kw.update(hidden_size=256, num_heads=2, num_kv_heads=1)
    _, _, cfg, model = _models(kw)
    t = [torch.from_numpy(x) for x in _rows(2, [100, 60, 70, 200], 256, cfg.vocab_size)]
    model.cfg = cfg.replace(remat=False)
    loss0, g0 = _loss_and_grads(model, t)
    model.cfg = cfg.replace(remat=True, remat_policy="full")
    loss1, g1 = _loss_and_grads(model, t)
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_unported_remat_rungs_raise():
    _, _, cfg, model = _models(dict(QWEN_KW))
    t = [torch.from_numpy(x) for x in _rows(3, [9, 17], 32, cfg.vocab_size)]
    for bad in (dict(remat=True, remat_policy="dots"), dict(layer_group_size=2)):
        model.cfg = cfg.replace(**bad)
        with pytest.raises(NotImplementedError):
            pt.forward_lm(model, *t)
