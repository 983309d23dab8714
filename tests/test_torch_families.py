"""The dense model families in the torch port against the JAX package and HF.

For each of qwen2, llama, qwen3, mistral (window 8), gemma, gemma2 (window
8 on alternate layers, softcaps 50/30, `query_pre_attn_scalar` 16) and gpt2,
the config comes from one HF `config.json` dict through both packages'
`from_hf` (equal fields), and at 2 layers of width 64 in f32:

- the port's packed forward, on the JAX tree moved over by
  `params_from_jax` (every norm and bias perturbed off its init), against
  `areal_tpu.models.forward` on multi-segment rows longer than the window;
- an HF checkpoint written by `transformers` (weights perturbed) loaded by
  the port's `load_hf_params`, against HF's logits; the port's writer then
  emits the names HF wrote (gpt2's dialect included), the JAX loader reads
  that checkpoint back to the same weights, and save -> reload is
  bit-equal.

Then, for gemma2, gpt2 and qwen3, greedy streams from the port's
`GenEngine` against `areal_tpu.gen.engine.GenEngine` (the ragged Pallas
kernel in interpret mode) past the window, with a declared group whose
siblings take the suffix prefill over a fanned-out prefix; for gemma2 and
gpt2, a trainer's weights through each publish path (export, disk,
chunked transfer over HTTP) to a served engine; the chunked LM head with
a final softcap and its gradients against the JAX head; one PPO
update of gemma2 against the JAX actor's; the weight-decay mask against
the JAX engine's over every leaf of gemma2 and gpt2; gemma's embedding
scale rounded in the compute dtype at a width whose root is not exact;
and the refusals that remain (MoE, VLM, LoRA, a gpt2 engine past its
position table).
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from areal_tpu_torch.engine.torch_train import decays
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models import transformer as pt
from areal_tpu_torch.models.convert import jax_tree_to_hf, params_from_jax
from areal_tpu_torch.models.hf import layer_name_map, load_hf_params, save_hf_checkpoint
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.ops.functional import lm_logprobs_entropy
from areal_tpu_torch.utils.data import pack_into_rows
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Tolerances.  Logits: f32 on both sides, products in another op order over
# two layers of widths <= 128 -> 1e-4 against JAX; HF's own modules differ
# more in op order (its rope, eager attention, gelu) -> 2e-4, the bound of
# tests/test_models.py::test_hf_parity.  Serving logprobs: 1e-4 as the
# other engine comparisons.  The chunked head: one f32 matmul and softmax
# per chunk on either side -> 1e-5.  PPO update: the bound of
# test_torch_train_engine.py (Adam moves elements with tiny gradients by
# up to ~lr on tiny differences).
JAX_ATOL = 1e-4
HF_ATOL = 2e-4
LOGP_ATOL = 1e-4
HEAD_ATOL = 1e-5
PARAM_ATOL = 1e-5
STAT_RTOL = 1e-4

COMMON = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
HF_CONFIGS = {
    "qwen2": dict(COMMON, model_type="qwen2", architectures=["Qwen2ForCausalLM"]),
    "llama": dict(COMMON, model_type="llama", architectures=["LlamaForCausalLM"]),
    "qwen3": dict(COMMON, model_type="qwen3", architectures=["Qwen3ForCausalLM"],
                  head_dim=16),
    "mistral": dict(COMMON, model_type="mistral", architectures=["MistralForCausalLM"],
                    sliding_window=8),
    "gemma": dict(COMMON, model_type="gemma", architectures=["GemmaForCausalLM"],
                  head_dim=16, hidden_act="gelu_pytorch_tanh"),
    "gemma2": dict(COMMON, model_type="gemma2", architectures=["Gemma2ForCausalLM"],
                   head_dim=16, query_pre_attn_scalar=16.0, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, sliding_window=8,
                   hidden_activation="gelu_pytorch_tanh"),
    "gpt2": dict(model_type="gpt2", architectures=["GPT2LMHeadModel"], vocab_size=256,
                 n_embd=64, n_layer=2, n_head=4, n_positions=256),
}
FAMILIES = list(HF_CONFIGS)


def _configs(family, **kw):
    """(JAX config, port config) of one family from the same HF dict, f32."""
    from areal_tpu.models.model_config import TransformerConfig as JaxConfig

    d = HF_CONFIGS[family]
    kw = dict(dtype="float32", remat=False, **kw)
    return JaxConfig.from_hf(d).replace(**kw), TransformerConfig.from_hf(d).replace(**kw)


def _jax_tree(jcfg, seed=0):
    """JAX init params as numpy, every 1-D leaf of a layer (norms, biases)
    and the final norm moved off its init, so unit offsets and biases
    count."""
    import jax

    from areal_tpu.models import init_params

    tree = jax.tree_util.tree_map(np.asarray, init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        per_layer = path[0].key == "layers"
        if a.ndim == (2 if per_layer else 1):
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _rows(seed, lens, row_len, V):
    rng = np.random.default_rng(seed)
    L = max(lens)
    mask = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    ids = rng.integers(0, V, (len(lens), L)).astype(np.int32) * mask
    rp = pack_into_rows({"input_ids": ids, "attention_mask": mask}, row_len)
    return rp.data["input_ids"], rp.data["positions"], rp.data["segment_ids"]


@pytest.mark.parametrize("family", FAMILIES)
def test_from_hf_matches_jax(family):
    from areal_tpu.models.model_config import TransformerConfig as JaxConfig

    d = HF_CONFIGS[family]
    jcfg, cfg = JaxConfig.from_hf(d), TransformerConfig.from_hf(d)
    jfields = dataclasses.asdict(jcfg)
    for f in dataclasses.fields(cfg):
        if f.name in jfields:
            assert getattr(cfg, f.name) == jfields[f.name], f.name
    assert cfg.to_hf_dict() == jcfg.to_hf_dict()
    pt.check_supported(cfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_packed_forward_matches_jax(family):
    from areal_tpu.models import forward as jax_forward

    jcfg, cfg = _configs(family)
    tree = _jax_tree(jcfg)
    model = params_from_jax(tree, cfg, device="cpu", param_dtype="float32")
    ids, pos, seg = _rows(1, [9, 17, 5, 12, 20], 32, cfg.vocab_size)
    assert (seg.max(axis=-1) >= 1).any() and pos.max() >= 8  # packed, past the window
    want = np.asarray(jax_forward(tree, jcfg, ids, pos, seg))
    with torch.no_grad():
        got = pt.forward(model, *(torch.from_numpy(x) for x in (ids, pos, seg))).numpy()
    valid = seg >= 0
    np.testing.assert_allclose(got[valid], want[valid], atol=JAX_ATOL, rtol=0)


def _hf_checkpoint(family, out_dir):
    """A random `transformers` model of the family's config, weights moved
    off their init from a seeded generator, saved with `save_pretrained`."""
    import transformers

    d = {k: v for k, v in HF_CONFIGS[family].items() if k not in ("model_type", "architectures")}
    hf_cfg = transformers.AutoConfig.for_model(HF_CONFIGS[family]["model_type"], **d)
    torch.manual_seed(0)
    # eager attention: torch's sdpa path drops gemma2's logit softcap
    model = transformers.AutoModelForCausalLM.from_config(
        hf_cfg, attn_implementation="eager").eval().float()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model.save_pretrained(out_dir, safe_serialization=True)
    return model


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_checkpoint_parity_and_round_trip(family, tmp_path):
    from areal_tpu.models.hf import load_hf_params as jax_load

    hf_dir, ours, again = (str(tmp_path / n) for n in ("hf", "ours", "again"))
    hf_model = _hf_checkpoint(family, hf_dir)
    cfg = TransformerConfig.from_hf(hf_dir).replace(dtype="float32", remat=False)
    model, _ = load_hf_params(hf_dir, cfg, device="cpu")
    rng = np.random.default_rng(0)
    B, L = 2, 17
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int64)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(ids)).logits.numpy()
        pos = torch.arange(L).expand(B, L)
        seg = torch.arange(B)[:, None].expand(B, L)
        got = pt.forward(model, torch.from_numpy(ids), pos, seg).numpy()
    np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=0)

    save_hf_checkpoint(model, ours, save_dtype="float32")
    hf_names = {n for n, _ in safetensors_io.iter_safetensors(hf_dir)
                if not n.endswith((".attn.bias", ".attn.masked_bias"))}
    if cfg.tie_word_embeddings:
        hf_names.discard("lm_head.weight")
    assert {n for n, _ in safetensors_io.iter_safetensors(ours)} == hf_names
    assert json.load(open(f"{ours}/config.json"))["model_type"] == HF_CONFIGS[family][
        "model_type"]
    state = model.state_dict()
    reloaded, _ = load_hf_params(ours, cfg, device="cpu")
    for name, t in reloaded.state_dict().items():
        assert torch.equal(t, state[name]), name
    save_hf_checkpoint(reloaded, again, save_dtype="float32")
    assert open(f"{ours}/model.safetensors", "rb").read() == open(
        f"{again}/model.safetensors", "rb").read()
    tree, _ = jax_load(ours)
    bridged = dict(jax_tree_to_hf(tree, cfg))
    assert bridged.keys() == state.keys()
    for name, t in bridged.items():
        assert torch.equal(t, state[name]), name


# ---------------------------------------------------------------------------
# serving against the JAX engine
# ---------------------------------------------------------------------------

ENGINE = dict(n_slots=4, max_seq_len=64, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)


@pytest.mark.parametrize("family", ["gemma2", "gpt2", "qwen3"])
def test_greedy_streams_match_jax_engine(family):
    """Fresh prompts of 5..13 tokens with budgets of 14..20 (past the
    window of 8, so the sliding layers drop keys), then a declared group of
    two over a 21-token prompt: the second sibling rides the first's
    fanned-out K/V through the suffix prefill."""
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    jcfg, cfg = _configs(family, eos_token_id=None)
    tree = _jax_tree(jcfg)
    port = GenEngine(cfg, params=params_from_jax(tree, cfg, "cpu"), device="cpu", **ENGINE)
    jax_eng = JaxEngine(jcfg, params=tree, ragged_attn=True, **ENGINE)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 13, 9, 21)]
    budgets = (20, 14, 17, 12)

    def run(engine, request):
        fresh = [request(rid=str(i), input_ids=p, max_new_tokens=m, temperature=0.0)
                 for i, (p, m) in enumerate(zip(prompts[:3], budgets))]
        engine.generate_blocking(fresh)
        group = [request(rid=f"g{i}", input_ids=prompts[3], max_new_tokens=budgets[3],
                         temperature=0.0, group_id="g", group_n=2) for i in range(2)]
        engine.generate_blocking(group)
        return fresh + group

    want, got = run(jax_eng, JaxRequest), run(port, GenRequest)
    for w, g in zip(want, got):
        assert g.output_tokens == w.output_tokens, g.rid
        assert len(g.output_tokens) == w.max_new_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=LOGP_ATOL,
                                   rtol=0, err_msg=g.rid)
    assert port.stats["shared_tokens"] == jax_eng.stats["shared_tokens"] > 0
    assert port.stats["suffix_calls"] == jax_eng.stats["suffix_calls"] > 0


@pytest.mark.parametrize("family", ["gemma2", "gpt2"])
def test_publish_paths_carry_the_family(family, tmp_path, monkeypatch):
    """A trainer's weights reach a served engine by each publish path: the
    colocated export (`swap_weights_live`), the disk snapshot
    (`load_weights`) and the chunked transfer over HTTP (pieces in gpt2's
    dialect for gpt2, `prepare`, a live commit), served equal to the
    trainer's masters (their bf16 cast for the disk and transfer paths)."""
    from areal_tpu_torch.api.config import TrainEngineConfig
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.engine.torch_train import TorchTrainEngine
    from areal_tpu_torch.gen import server

    _, cfg = _configs(family, eos_token_id=None)
    trainer = TorchTrainEngine(TrainEngineConfig(init_from_scratch=True, dtype="float32",
                                                 optimizer=None), model_config=cfg, device="cpu")
    trainer.initialize()
    gen = torch.Generator().manual_seed(3)

    def move():
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    def served_equal(want, cast):
        got = dict(engine.model.named_parameters())
        assert got.keys() == want.keys()
        for n, w in want.items():
            assert torch.equal(got[n], w.to(cast).float() if cast else w), n

    engine = GenEngine(cfg, params=pt.init_params(cfg, 1, "cpu"), device="cpu", **ENGINE)
    masters = move()
    engine.swap_weights_live(trainer.export_device_params(), version=1)
    served_equal(masters, None)

    root = str(tmp_path / "weights")
    masters = move()
    trainer.set_version(2)
    trainer.update_weights(WeightUpdateMeta(type="disk", path=root))
    assert engine.load_weights(path=root) == 2
    served_equal(masters, torch.bfloat16)

    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    try:
        monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", f"127.0.0.1:{box['httpd'].port}")
        masters = move()
        trainer.set_version(3)
        trainer.update_weights(WeightUpdateMeta.from_transfer(chunk_mb=1))
        assert engine.version == 3
        served_equal(masters, torch.bfloat16)
    finally:
        box["httpd"].shutdown()
        t.join(30)
    assert not t.is_alive()


def test_gpt2_engine_past_its_position_table_raises():
    _, cfg = _configs("gpt2")
    model = pt.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="position table"):
        GenEngine(cfg, params=model, device="cpu", n_slots=2,
                  max_seq_len=cfg.max_position_embeddings + 1)
    GenEngine(cfg, params=model, device="cpu", n_slots=2,
              max_seq_len=cfg.max_position_embeddings)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_chunked_head_with_softcap_matches_jax():
    """The token-chunked head (48 tokens in chunks of 16) with the final
    softcap and a temperature, values and gradients of a weighted sum of
    logprobs and entropy with respect to the hidden states and the head.
    Logits of a few units (unit hidden states, as a final norm gives, and
    a head of std 3 / sqrt(D)) under a cap of 5 that bends them."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models.transformer import LMOutput as JaxLMOutput
    from areal_tpu.ops.functional import lm_logprobs_entropy as jax_head

    rng = np.random.default_rng(2)
    N, D, V = 48, 32, 200
    hidden = rng.standard_normal((2, N // 2, D)).astype(np.float32)
    head = (3.0 / np.sqrt(D) * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (2, N // 2)).astype(np.int32)
    w1, w2 = (rng.standard_normal((2, N // 2)).astype(np.float32) for _ in range(2))

    def jloss(h, w):
        lp, ent, corr = jax_head(JaxLMOutput(h, w, logit_softcap=5.0), jnp.asarray(labels),
                                 temperature=0.7, chunk=16)
        return jnp.sum(lp * w1) + jnp.sum(ent * w2), (lp, ent, corr)

    (_, (jlp, jent, jcorr)), (jdh, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    lp, ent, corr = lm_logprobs_entropy(pt.LMOutput(h, w, logit_softcap=5.0),
                                        torch.from_numpy(labels), temperature=0.7, chunk=16)
    ((lp * torch.from_numpy(w1)).sum() + (ent * torch.from_numpy(w2)).sum()).backward()
    for a, b in ((lp, jlp), (ent, jent), (corr, jcorr), (h.grad, jdh), (w.grad, jdw)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=HEAD_ATOL, rtol=0)

    # entropy_grad=False (GRPO's stats-only entropy): the entropy leaves
    # the graph, the logprobs' gradients stay JAX's
    jdh, jdw = jax.grad(lambda h_, w_: jnp.sum(jloss(h_, w_)[1][0] * w1), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h.grad = w.grad = None
    lp, ent, _ = lm_logprobs_entropy(pt.LMOutput(h, w, logit_softcap=5.0),
                                     torch.from_numpy(labels), temperature=0.7, chunk=16,
                                     entropy_grad=False)
    assert not ent.requires_grad
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), atol=HEAD_ATOL, rtol=0)
    (lp * torch.from_numpy(w1)).sum().backward()
    for a, b in ((h.grad, jdh), (w.grad, jdw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=HEAD_ATOL, rtol=0)


def _actor_kw(m):
    return dict(
        init_from_scratch=True, dtype="float32", gradient_checkpointing=True,
        mb_spec=m.MicroBatchSpec(n_mbs=2),
        optimizer=m.OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        pack_length_quantum=16, group_size=4, ppo_n_minibatches=2,
        adv_norm=m.NormConfig(mean_level="group", std_level="group", group_size=4),
    )


def _ppo_batch(V):
    rng = np.random.default_rng(0)
    B, L, P = 8, 16, 4
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < np.asarray([16, 9, 12, 16, 5, 14, 16, 11])[:, None]
    loss_mask = np.pad(np.ones((B, L - P), np.float32), ((0, 0), (P, 0))) * mask
    return {
        "input_ids": ids * mask, "attention_mask": mask, "loss_mask": loss_mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": (ids[:, P] % 2 == 0).astype(np.float32),
    }


def test_gemma2_ppo_update_matches_jax_actor():
    """The `__graft_entry__._dryrun_one` recipe (full remat, two
    micro-batches, two PPO minibatches, packed rows) on gemma2: proximal
    logprobs, the update's stats and the params after it."""
    import jax

    from areal_tpu.api import config as jc
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.engine.ppo import JaxPPOActor
    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    jcfg, cfg = _configs("gemma2")
    ja = JaxPPOActor(jc.PPOActorConfig(**_actor_kw(jc), experiment_name="fam",
                                       trial_name="fam"), model_config=jcfg)
    ja.initialize(ft_spec=JaxSpec(1, 64, 8))
    ta = TorchPPOActor(tc.PPOActorConfig(**_actor_kw(tc)), model_config=cfg, device="cpu")
    ta.initialize(ft_spec=FinetuneSpec(1, 64, 8))

    def bridged():
        tree = jax.tree_util.tree_map(np.asarray, ja.params)
        return dict(params_from_jax(tree, cfg, "cpu", "float32").named_parameters())

    src = bridged()
    with torch.no_grad():
        for n, p in ta.model.named_parameters():
            p.copy_(src[n])
    bj, bt = _ppo_batch(cfg.vocab_size), _ppo_batch(cfg.vocab_size)
    bj["prox_logp"], bt["prox_logp"] = ja.compute_logp(bj), ta.compute_logp(bt)
    np.testing.assert_allclose(bt["prox_logp"], bj["prox_logp"], atol=LOGP_ATOL, rtol=0)
    ja.compute_advantages(bj)
    ta.compute_advantages(bt)
    sj, st = ja.ppo_update(bj), ta.ppo_update(bt)
    assert len(sj) == len(st) == 2
    for a, b in zip(sj, st):
        for k in ("loss", "grad_norm", "entropy", "importance_weight", "new_logp"):
            assert abs(b[k] - a[k]) <= STAT_RTOL * max(abs(a[k]), 1e-3), (k, a[k], b[k])
    ref = bridged()
    for n, p in ta.model.named_parameters():
        assert (p - ref[n]).abs().max().item() < PARAM_ATOL, n


_TOP_LEAVES = {"model.embed_tokens.weight": ("embedding",),
               "model.embed_positions.weight": ("pos_embedding",),
               "model.norm.weight": ("final_norm",), "model.norm.bias": ("final_norm_b",),
               "lm_head.weight": ("lm_head",)}


@pytest.mark.parametrize("family", ["gemma2", "gpt2"])
def test_decay_mask_matches_jax(family):
    """`decays` on every parameter of the port's model equals the JAX
    engine's `ndim >= 2` on the scan-stacked leaf it maps to, and the
    port's names cover every JAX leaf once."""
    import jax

    jcfg, cfg = _configs(family)
    tree = _jax_tree(jcfg)
    model = params_from_jax(tree, cfg, "cpu", "float32")
    lmap = layer_name_map(cfg)
    covered = set()
    for name, p in model.named_parameters():
        if name.startswith("model.layers."):
            path = ("layers", *lmap[name.split(".", 3)[3]][0])
        else:
            path = _TOP_LEAVES[name]
        leaf = tree
        for key in path:
            leaf = leaf[key]
        assert decays(name, p) == (np.ndim(leaf) >= 2), name
        covered.add(path)
    leaves = {tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert covered == leaves


def test_gemma_embedding_scale_rounds_in_compute_dtype():
    """At width 3072 (gemma-7b; sqrt is not exact) the bf16 embedding equals
    JAX's `_embed` bit for bit: the scale is rounded to bf16 before the
    multiply.  An f32 scale would move it."""
    import jax.numpy as jnp

    from areal_tpu.models import transformer as jt
    from areal_tpu.models.model_config import TransformerConfig as JaxConfig

    d = dict(HF_CONFIGS["gemma"], hidden_size=3072, vocab_size=64, num_hidden_layers=1,
             intermediate_size=32)
    jcfg, cfg = JaxConfig.from_hf(d), TransformerConfig.from_hf(d)
    assert cfg.scale_embeddings and cfg.dtype == "bfloat16"
    rng = np.random.default_rng(4)
    table = rng.standard_normal((64, 3072)).astype(np.float32)
    ids = rng.integers(0, 64, (2, 5)).astype(np.int32)
    want = np.asarray(jt._embed({"embedding": jnp.asarray(table)}, jcfg, jnp.asarray(ids),
                                jnp.bfloat16)).astype(np.float32)
    model = pt.build_model(cfg, "cpu")
    with torch.no_grad():
        model.model.embed_tokens.weight.copy_(torch.from_numpy(table))
        got = model.embed(torch.from_numpy(ids).long(), None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = (model.model.embed_tokens.weight[torch.from_numpy(ids).long()].float()
                 * 3072 ** 0.5).bfloat16()
    assert not torch.equal(unrounded, got)


@pytest.mark.parametrize("unserved", [
    dict(num_experts=4, num_experts_per_tok=2, norm_topk_prob=True),
    dict(lora_rank=8),
    dict(vision_config=dict(depth=1, hidden_size=32, num_heads=2, out_hidden_size=64)),
], ids=["moe", "lora", "vlm"])
def test_moe_vlm_lora_still_raise(unserved):
    d, unserved = dict(HF_CONFIGS["qwen3"]), dict(unserved)
    lora = unserved.pop("lora_rank", None)
    d.update(unserved)
    cfg = TransformerConfig.from_hf(d)
    if lora:
        cfg = cfg.replace(lora_rank=lora)
    with pytest.raises(NotImplementedError):
        pt.build_model(cfg, "cpu")
