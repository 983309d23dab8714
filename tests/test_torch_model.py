"""The torch port's serving forward against the JAX package.

Same weights (the JAX tree, moved over by the port's weight bridge
`params_from_jax`) and the same numpy inputs go through `areal_tpu`'s
`forward_prefill` / `forward_decode(ragged=True)` (the Pallas kernel in
interpret mode) and the port's counterparts, in f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import transformer as pt
from areal_tpu_torch.models.convert import jax_tree_to_hf, params_from_jax
from areal_tpu_torch.models.model_config import VisionConfig, tiny_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# logits and K/V: f32 on both sides, products and sums in another order
# (XLA's einsum against torch's linear) over widths <= 128 -> 1e-4 covers
# two layers of accumulated rounding; rows/norm/rope building blocks 1e-5.
ATOL = 1e-4
QWEN_KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
               eos_token_id=None)


def _jax_tree(cfg_kw, seed=0):
    """JAX init params as numpy, with nonzero q/k/v biases so the bias path
    is exercised."""
    import jax

    from areal_tpu.models import init_params
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**cfg_kw)
    tree = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for k in ("bq", "bk", "bv"):
        if k in tree["layers"]["attn"]:
            shape = tree["layers"]["attn"][k].shape
            tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return jcfg, tree


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def models(request):
    kw = dict(QWEN_KW, tie_word_embeddings=request.param)
    jcfg, tree = _jax_tree(kw)
    cfg = tiny_config(**kw)
    return jcfg, tree, cfg, params_from_jax(tree, cfg, device="cpu")


def test_prefill_then_ragged_decode_match_jax(models):
    import jax
    import jax.numpy as jnp

    from areal_tpu.models.transformer import forward_decode, forward_prefill, init_kv_cache

    jcfg, tree, cfg, model = models
    rng = np.random.default_rng(3)
    S_total, M, P, page = 4, 64, 16, 16
    plens = np.array([5, 16, 9], np.int32)
    ids = rng.integers(0, 97, (3, P)).astype(np.int32)
    slot_ids = np.array([2, 0, 3], np.int32)  # a permuted page table
    jcache = init_kv_cache(jcfg, S_total, M, "float32")
    jlogits, jcache = jax.jit(forward_prefill, static_argnums=(1,))(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(plens), jcache, jnp.asarray(slot_ids))
    cache = pt.init_kv_cache(cfg, S_total, M, "float32", "cpu")
    logits, cache = pt.forward_prefill(
        model, torch.from_numpy(ids).long(), torch.from_numpy(plens).long(), cache,
        torch.from_numpy(slot_ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   atol=ATOL, rtol=0, err_msg=f"prefill {name}-cache")

    jdecode = jax.jit(forward_decode, static_argnums=(1,),
                      static_argnames=("key_window", "ragged", "page_size"))
    tokens = np.asarray(jlogits).argmax(-1).astype(np.int32)
    lengths = plens.copy()
    active = np.array([True, False, True])  # slot 1 idle: its write drops
    for step in range(3):
        K = int(min(M, page * -(-(lengths.max() + 1) // page)))
        jl, jcache = jdecode(
            tree, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jcache,
            key_window=K, active=jnp.asarray(active), rows=jnp.asarray(slot_ids),
            ragged=True, page_size=page)
        tl, cache = pt.forward_decode(
            model, torch.from_numpy(tokens).long(), torch.from_numpy(lengths), cache,
            torch.from_numpy(slot_ids), page_size=page, key_window=K,
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
        tokens = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   atol=ATOL, rtol=0, err_msg=f"decode {name}-cache")


def test_weight_bridge_matches_jax_hf_state(models):
    from areal_tpu.models.hf import params_to_hf_state

    jcfg, tree, cfg, model = models
    want = dict(params_to_hf_state(tree, jcfg))
    got = dict(jax_tree_to_hf(tree, cfg))
    state = model.state_dict()
    assert set(got) == set(want) == set(state)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr, np.float32), name)
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(arr, np.float32), name)


def test_building_blocks_match_jax():
    import jax.numpy as jnp

    from areal_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        pt.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jt.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), atol=1e-5)
    cos, sin = pt.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jt.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(
        pt.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jt.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5)


def test_naive_attention_and_mask_match_jax():
    import jax.numpy as jnp

    from areal_tpu.ops import attention as ja
    from areal_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(1)
    seg = np.array([[0, 0, 0, 1, 1, -1], [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([[0, 1, 2, 0, 1, 0], [0, 1, 2, 3, 4, 5]], np.int32)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    jm = ja.make_attention_mask(jnp.asarray(seg), jnp.asarray(pos))
    tm = ta.make_attention_mask(torch.from_numpy(seg), torch.from_numpy(pos))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for cap in (None, 5.0):
        want = ja.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), jm, cap)
        got = ta.naive_attention(*(torch.from_numpy(a) for a in (q, k, v)), tm, cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("family", [
    dict(num_experts=4),
    dict(vision=VisionConfig(num_layers=1, hidden_size=32, num_heads=2, out_hidden_size=64)),
    dict(lora_rank=8),
])
def test_unserved_families_raise(family):
    with pytest.raises(NotImplementedError):
        pt.build_model(tiny_config(**family), device="cpu")


def test_init_params_is_seeded_and_needs_a_device(monkeypatch):
    cfg = tiny_config(**QWEN_KW)
    a, b = pt.init_params(cfg, 3, "cpu"), pt.init_params(cfg, 3, "cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    assert torch.all(a.state_dict()["model.layers.0.self_attn.q_proj.bias"] == 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.init_params(cfg, 3)
