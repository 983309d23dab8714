"""The torch port's training forward against the JAX package.

`forward` / `forward_lm` / `forward_hidden` of `areal_tpu_torch.models.
transformer` run on packed multi-segment rows (built by the port's copy of
`pack_into_rows`) from the JAX tree moved over by the weight bridge as f32
masters, against `areal_tpu.models.forward`, in f32 on the CPU; a
head-dim-128 config at T = 256 takes the port's flash path (its plain
version here) where JAX takes the naive one.  `forward_packed` against
JAX's on a flat packed dict.  Torch against torch: the `full` remat rung
gives the losses and gradients of no remat bit for bit, and every rung
with every layer grouping those of `full` with one layer a group, on the
naive and the flash path, with the attention forwards each rung runs;
`attn_impl` "naive" against "auto", "ring" warning as JAX warns, and the
engine refusing an unknown value as JAX's does.
"""

import warnings

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import transformer as pt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops.functional import lm_logprobs_entropy
from areal_tpu_torch.utils.data import pack_into_rows
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    """What JAX's `_backbone` refuses, the port refuses with the same
    ValueError: a rung that does not exist (with remat on) and a
    `layer_group_size` that does not divide the depth (2 layers here)."""
    _, _, cfg, model = _models(dict(QWEN_KW))
    t = [torch.from_numpy(x) for x in _rows(3, [9, 17], 32, cfg.vocab_size)]
    for bad, match in ((dict(remat=True, remat_policy="selective"), "remat_policy"),
                       (dict(layer_group_size=3), "layer_group_size"),
                       (dict(remat=False, layer_group_size=4), "layer_group_size")):
        model.cfg = cfg.replace(**bad)
        with pytest.raises(ValueError, match=match):
            pt.forward_lm(model, *t)
    model.cfg = cfg.replace(remat=False, remat_policy="selective")  # unread without remat
    pt.forward_lm(model, *t)


RUNGS = ("full", "dots", "save_attn", "save_mlp", "carry_offload")
# attention forwards per layer in one forward + backward: the rungs that
# keep the attention output launch none in the recompute
ATTN_FORWARDS = {"full": 2, "dots": 2, "save_attn": 1, "save_mlp": 2, "carry_offload": 1}


@pytest.fixture(scope="module")
def four_layers():
    """A 4-layer model per path (head dim 16: naive; 128: flash) and its
    `full`, one-layer-a-group loss and gradients on 256-token rows."""
    out = {}
    for path, kw in (("naive", {}), ("flash", dict(hidden_size=256, num_heads=2,
                                                    num_kv_heads=1))):
        _, _, cfg, model = _models(dict(QWEN_KW, num_layers=4, **kw))
        t = [torch.from_numpy(x) for x in _rows(2, [100, 60, 70, 200], 256, cfg.vocab_size)]
        model.cfg = cfg.replace(remat=True, remat_policy="full", layer_group_size=1)
        out[path] = (cfg, model, t, _loss_and_grads(model, t))
    return out


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("path", ["naive", "flash"])
def test_remat_rungs_and_grouping_are_bit_identical(four_layers, path, rung, group):
    """Each rung with G layers a checkpoint gives the loss and gradients of
    `full` with G = 1 bit for bit; on the flash path the attention forward
    runs as often as the rung says (once a layer where the attention output
    is kept, twice where the backward recomputes it)."""
    cfg, model, t, (loss0, g0) = four_layers[path]
    model.cfg = cfg.replace(remat=True, remat_policy=rung, layer_group_size=group)
    calls = []
    real = fa.flash_fwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    fa.flash_fwd = counted
    try:
        loss1, g1 = _loss_and_grads(model, t)
    finally:
        fa.flash_fwd = real
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert len(calls) == (ATTN_FORWARDS[rung] * cfg.num_layers if path == "flash" else 0)


def test_forward_packed_matches_jax():
    """`forward_packed` over a flat packed dict against JAX's."""
    import jax.numpy as jnp

    from areal_tpu.models.transformer import forward_packed as jax_forward_packed

    jcfg, tree, cfg, model = _models(dict(QWEN_KW))
    ids, pos, seg = _rows(4, [9, 17, 5], 32, cfg.vocab_size)
    flat = {"input_ids": ids[0], "positions": pos[0], "segment_ids": seg[0]}
    ref = np.asarray(jax_forward_packed(tree, jcfg, {k: jnp.asarray(v) for k, v in flat.items()}))
    with torch.no_grad():
        got = pt.forward_packed(model, {k: torch.from_numpy(v) for k, v in flat.items()})
    assert got.shape == (ids.shape[1], cfg.vocab_size)
    valid = seg[0] >= 0
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], atol=ATOL, rtol=0)


def test_attn_impl_naive_matches_auto():
    """On rows the flash gate admits, "naive" runs `naive_attention` (no
    flash forward) and agrees with "auto" (the flash path) on valid
    tokens; "splash" is "auto"."""
    _, _, cfg, model = _models(dict(QWEN_KW, hidden_size=256, num_heads=2, num_kv_heads=1))
    t = [torch.from_numpy(x) for x in _rows(5, [100, 60, 70, 200], 256, cfg.vocab_size)]
    logits = {}
    for impl in ("auto", "splash", "naive"):
        model.cfg = cfg.replace(attn_impl=impl)
        calls = []
        real = fa.flash_fwd
        fa.flash_fwd = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        try:
            with torch.no_grad():
                logits[impl] = pt.forward(model, *t)
        finally:
            fa.flash_fwd = real
        assert len(calls) == (0 if impl == "naive" else cfg.num_layers), impl
    valid = t[2] >= 0
    assert torch.equal(logits["auto"], logits["splash"])
    np.testing.assert_allclose(logits["naive"][valid].numpy(), logits["auto"][valid].numpy(),
                               atol=ATOL, rtol=0)


def _ring_warnings(run):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        run()
    return sorted({str(w.message) for w in seen if "attn_impl='ring'" in str(w.message)})


@pytest.mark.parametrize("windows", [False, True], ids=["uniform", "per-layer"])
def test_attn_impl_ring_warns_as_jax_does(windows):
    """"ring" without a sequence-parallel mesh (one card has none) warns
    with JAX's message and computes what "auto" computes; with gemma2's
    per-layer windows the reason names them."""
    from areal_tpu.models import forward as jax_forward

    kw = dict(QWEN_KW)
    if windows:
        kw.update(sliding_window=8, layer_is_sliding=(True, False))
    jcfg, tree, cfg, model = _models(kw)
    ids, pos, seg = _rows(6, [9, 17, 5, 30], 32, cfg.vocab_size)
    t = [torch.from_numpy(x) for x in (ids, pos, seg)]
    want = _ring_warnings(lambda: jax_forward(tree, jcfg.replace(attn_impl="ring"), ids, pos,
                                              seg))
    model.cfg = cfg.replace(attn_impl="ring")
    with torch.no_grad():
        got = _ring_warnings(lambda: pt.forward(model, *t))
        ring = pt.forward(model, *t)
        model.cfg = cfg
        auto = pt.forward(model, *t)
    assert got == want and len(got) == 1
    assert ("per-layer" in got[0]) == windows
    assert torch.equal(ring, auto)


def test_engine_refuses_unknown_attn_impl():
    """`initialize` refuses what JAX's engine refuses; a model config's own
    `attn_impl` wins over the engine config's."""
    from areal_tpu_torch.api.config import TrainEngineConfig
    from areal_tpu_torch.engine.torch_train import TorchTrainEngine

    cfg = tiny_config(**QWEN_KW)
    with pytest.raises(ValueError, match="attn_impl"):
        TorchTrainEngine(TrainEngineConfig(init_from_scratch=True, attn_impl="flash"), cfg,
                         device="cpu").initialize()
    for model_impl, engine_impl, want in (("auto", "naive", "naive"), ("splash", "naive", "splash")):
        eng = TorchTrainEngine(TrainEngineConfig(init_from_scratch=True, attn_impl=engine_impl,
                                                 optimizer=None),
                               cfg.replace(attn_impl=model_impl), device="cpu")
        eng.initialize()
        assert eng.model_config.attn_impl == want
