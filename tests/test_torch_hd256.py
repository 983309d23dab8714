"""Gemma-1 at head dim 256 in the torch port against the JAX package.

At head dim 256 JAX trains and recomputes logprobs through splash (its
gate takes any multiple of 128), run here in interpret mode as
tests/test_attention.py runs it; the port takes its flash path, whose
wrappers run the kernels' plain versions for CPU tensors.  On a 2-layer
Gemma-1 model (8 q heads on one kv head of 256, gelu, tied head, embedding
scale) with 256-token packed rows, from the JAX tree moved over by
`params_from_jax`, in f32: the packed forward, and the PPO actor's
logprob recompute and one `ppo_update` (two micro-batches, two
minibatches, full remat).  Then `google/gemma-2b`'s published config.json
through both packages' `from_hf`: the same config, one the port's flash
gate admits.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import transformer as pt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.utils.data import pack_into_rows

# Tolerances: as tests/test_torch_families.py (f32 on both sides, the
# blockwise softmax against splash's own blocks).
JAX_ATOL = 1e-4
LOGP_ATOL = 1e-4
PARAM_ATOL = 1e-5
STAT_RTOL = 1e-4

ROW = 256  # packed row length: the smallest both flash gates admit
GEMMA_1 = dict(model_type="gemma", architectures=["GemmaForCausalLM"], vocab_size=256,
               hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=1, head_dim=256,
               max_position_embeddings=512, hidden_act="gelu", tie_word_embeddings=True)
# google/gemma-2b's config.json (the fields `from_hf` reads)
GEMMA_2B = dict(model_type="gemma", architectures=["GemmaForCausalLM"], vocab_size=256000,
                hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
                num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
                hidden_act="gelu", tie_word_embeddings=True, bos_token_id=2, eos_token_id=1,
                pad_token_id=0, torch_dtype="bfloat16")


@pytest.fixture
def interpret(monkeypatch):
    """Splash in interpret mode; yields the list of its calls (each traced
    or eager call of the JAX package's `_splash_call`)."""
    from areal_tpu.ops import attention as jax_attn

    monkeypatch.setattr(jax_attn, "INTERPRET", True)
    calls, real = [], jax_attn._splash_call

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(jax_attn, "_splash_call", counted)
    return calls


def _configs(**kw):
    from areal_tpu.models.model_config import TransformerConfig as JaxConfig

    kw = dict(dtype="float32", remat=False, **kw)
    return (JaxConfig.from_hf(GEMMA_1).replace(**kw),
            TransformerConfig.from_hf(GEMMA_1).replace(**kw))


def _jax_tree(jcfg, seed=0):
    """JAX init params as numpy, the norms moved off their init so the unit
    offset counts."""
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


def test_packed_forward_matches_jax_splash(interpret):
    """Logits on valid tokens of two 256-token rows of 3 and 2 segments with
    tail padding; the JAX side runs splash (interpret), the port its flash
    path (plain versions)."""
    from areal_tpu.models import forward as jax_forward
    from areal_tpu.ops.attention import splash_supported

    jcfg, cfg = _configs()
    assert splash_supported(ROW, 8, 1, 256)
    assert fa.flash_supported(ROW, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    tree = _jax_tree(jcfg)
    model = params_from_jax(tree, cfg, device="cpu", param_dtype="float32")
    rng = np.random.default_rng(1)
    lens = [100, 60, 70, 150, 90]
    L = max(lens)
    mask = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    ids = rng.integers(0, cfg.vocab_size, (len(lens), L)).astype(np.int32) * mask
    rp = pack_into_rows({"input_ids": ids, "attention_mask": mask}, ROW)
    ids, pos, seg = (rp.data[k] for k in ("input_ids", "positions", "segment_ids"))
    assert ids.shape[1] == ROW and (seg < 0).any() and (seg.max(axis=-1) >= 1).all()
    ref = np.asarray(jax_forward(tree, jcfg, ids, pos, seg))
    assert interpret  # JAX ran splash
    with torch.no_grad():
        got = pt.forward(model, *(torch.from_numpy(x) for x in (ids, pos, seg))).numpy()
    valid = seg >= 0
    np.testing.assert_allclose(got[valid], ref[valid], atol=JAX_ATOL, rtol=0)


def _actor_kw(m):
    return dict(
        init_from_scratch=True, dtype="float32", gradient_checkpointing=True,
        mb_spec=m.MicroBatchSpec(n_mbs=2),
        optimizer=m.OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        pack_length_quantum=ROW, max_pack_length=ROW, group_size=4, ppo_n_minibatches=2,
        adv_norm=m.NormConfig(mean_level="group", std_level="group", group_size=4),
    )


def _ppo_batch(V):
    """8 sequences of 60..120 tokens: each micro-batch packs into 256-token
    rows of several segments with tail padding."""
    rng = np.random.default_rng(0)
    lens = np.asarray([120, 70, 96, 110, 60, 104, 88, 75])
    B, L, P = len(lens), int(lens.max()), 16
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < lens[:, None]
    loss_mask = np.pad(np.ones((B, L - P), np.float32), ((0, 0), (P, 0))) * mask
    return {
        "input_ids": ids * mask, "attention_mask": mask, "loss_mask": loss_mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": (ids[:, P] % 2 == 0).astype(np.float32),
    }


def test_ppo_update_matches_jax_actor(interpret):
    """The `__graft_entry__._dryrun_one` recipe (full remat, two
    micro-batches, two PPO minibatches) on 256-token packed rows: proximal
    logprobs, the update's stats and the params after it."""
    import jax

    from areal_tpu.api import config as jc
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.engine.ppo import JaxPPOActor
    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    jcfg, cfg = _configs()
    ja = JaxPPOActor(jc.PPOActorConfig(**_actor_kw(jc), experiment_name="hd256",
                                       trial_name="hd256"), model_config=jcfg)
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
    calls = []
    real = fa.flash_fwd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    fa.flash_fwd = counted
    try:
        bt["prox_logp"] = ta.compute_logp(bt)
    finally:
        fa.flash_fwd = real
    assert calls and all(s[1] == ROW and s[-1] == 256 for s in calls)  # the flash path
    bj["prox_logp"] = ja.compute_logp(bj)
    assert interpret  # JAX ran splash
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


def test_gemma_2b_config_matches_jax():
    """`google/gemma-2b`'s config.json: both packages' `from_hf` give the
    same config (exact gelu, as HF's GemmaMLP reads `hidden_act`), and its
    packed training rows take the flash kernels at head dim 256."""
    from areal_tpu.models.model_config import TransformerConfig as JaxConfig

    jcfg, cfg = JaxConfig.from_hf(GEMMA_2B), TransformerConfig.from_hf(GEMMA_2B)
    shared = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if hasattr(jcfg, f)}
    assert {f: getattr(jcfg, f) for f in shared} == shared
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.vocab_size, cfg.hidden_act) == (18, 2048, 8, 1, 256, 256000, "gelu")
    assert cfg.tie_word_embeddings and cfg.scale_embeddings and cfg.norm_unit_offset
    assert fa.flash_supported(1024, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
