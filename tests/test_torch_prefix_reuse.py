"""KV prefix reuse, abort reservations and group fan-out in the port's
generation engine, against the JAX package's `GenEngine`.

Both engines run the setup of `tests/test_group_fanout.py` (tiny config,
vocab 97, f32 KV, 8 slots, max_seq_len 128, prompt bucket 16,
reuse_min_tokens 4), with the same weights (the JAX tree through the
port's converter), through the same submission sequences:

- a GRPO group burst (two declared groups and two singles);
- a multi-turn continuation (three turns over one transcript);
- an interruption resume (abort mid-decode, resubmit prompt + tokens);
- an abort storm after a live weight swap, resubmits behind fresh prompts;
- strict reload (`retain_kv_on_reload=False`) around a live swap;
- `share_prefix=False`.

In each case greedy streams must be equal, logprobs agree to 1e-4 (f32
forwards in another op order), and the prefill counters (`prefill_tokens`,
`suffix_tokens`, `reused_tokens`, `shared_tokens`, `copy_calls`,
`prefix_cache_hits`) be exactly equal.  Then `forward_prefill_cached` (the
suffix prefill with the fused fan-out copy) against the JAX function on the
same weights and cache (logits within 1e-4, caches within 1e-5), and
`copy_kv_prefix` bit-equal to the JAX function.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import forward_prefill_cached
from areal_tpu_torch.ops.kv_copy import copy_kv_prefix
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGP_ATOL = 1e-4
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
ENGINE = dict(n_slots=8, max_seq_len=128, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)
COUNTERS = ("prefill_tokens", "suffix_tokens", "reused_tokens", "shared_tokens",
            "copy_calls", "prefix_cache_hits")
_JAX_PROGRAMS: dict = {}


@pytest.fixture(scope="module")
def trees():
    """Two JAX parameter sets (random q/k/v biases), as numpy trees."""
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**KW)
    out = []
    for seed in (0, 1):
        tree = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed + 20)
        for k in ("bq", "bk", "bv"):
            tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(
                tree["layers"]["attn"][k].shape)).astype(np.float32)
        out.append(tree)
    return jcfg, out


class _Side:
    """One package's engine and request class behind one driving surface,
    so a sequence runs unchanged on both."""

    def __init__(self, engine, request, weights):
        self.eng, self.request, self.weights = engine, request, weights
        self.reqs = {}  # key -> the request objects submitted under it

    def req(self, key, ids, max_new, **kw):
        r = self.request(rid=key, input_ids=list(ids), max_new_tokens=max_new,
                         temperature=0.0, **kw)
        self.reqs.setdefault(key, []).append(r)
        return r

    def swap(self, which, version):
        self.eng.swap_weights_live(self.weights[which], version=version)


def _sides(trees, **kw):
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    jcfg, ts = trees
    cfg = tiny_config(**KW)
    port = GenEngine(cfg, params=params_from_jax(ts[0], cfg, "cpu"), device="cpu",
                     **dict(ENGINE, **kw))
    jax_eng = JaxEngine(jcfg, params=ts[0], ragged_attn=True, **dict(ENGINE, **kw))
    # the jitted programs are functions of the model config and the slot
    # grid alone, which every case shares: compile them once per module
    for name, fn in _JAX_PROGRAMS.setdefault("fns", {
            n: getattr(jax_eng, n)
            for n in ("_prefill_fn", "_suffix_prefill_fn", "_decode_fn")}).items():
        setattr(jax_eng, name, fn)
    return (_Side(jax_eng, JaxRequest, ts),
            _Side(port, GenRequest, [params_from_jax(t, cfg, "cpu") for t in ts]))


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, n).tolist() for n in lens]


def _group(side, key, prompt, n, max_new):
    return [side.req(f"{key}-{i}", prompt, max_new, group_id=key, group_n=n)
            for i in range(n)]


def _grpo_burst(side):
    a, b, s0, s1 = _prompts(1, 24, 19, 10, 30)
    reqs = _group(side, "A", a, 4, 6) + _group(side, "B", b, 3, 5)
    reqs += [side.req("s0", s0, 4), side.req("s1", s1, 7)]
    side.eng.generate_blocking(reqs)  # submits them in order, in one window


def _multi_turn(side):
    turn, fb = _prompts(2, 22, 6)
    for t in range(3):
        r = side.req(f"t{t}", turn, 5)
        side.eng.generate_blocking([r])
        turn = turn + r.output_tokens + fb


def _resume(side):
    prompts = _prompts(3, 16, 27, 9)
    first = [side.req(f"i{k}", p, 16) for k, p in enumerate(prompts)]
    for r in first:
        side.eng.submit(r)
    side.eng.step()  # admission and one decode chunk
    side.eng.abort_all("abort")
    resumed = [side.req(r.rid, r.input_ids + r.output_tokens, 16 - len(r.output_tokens))
               for r in first]
    side.eng.generate_blocking(resumed)


def _abort_storm(side):
    prompt, *fresh = _prompts(4, 24, 20, 12)
    group = _group(side, "W", prompt, 4, 30)
    solo = side.req("x", _prompts(5, 18)[0], 30)
    for r in group + [solo]:
        side.eng.submit(r)
    side.eng.step()
    side.swap(1, 1)  # live: nobody aborts, decoding goes on under v1
    side.eng.step()
    side.eng.abort_all("abort")
    # the resubmits arrive behind fresh prompts
    later = [side.req(f"f{k}", p, 4) for k, p in enumerate(fresh)]
    later += [side.req(r.rid, r.input_ids + r.output_tokens, 30 - len(r.output_tokens),
                       group_id=r.group_id, group_n=r.group_n) for r in group + [solo]]
    side.eng.generate_blocking(later)


def _strict_reload(side):
    prompt, fb = _prompts(6, 20, 5)
    first = _group(side, "Z", prompt, 4, 3)
    side.eng.generate_blocking(first)
    side.swap(1, 1)
    again = _group(side, "Z2", prompt, 2, 3)
    again.append(side.req("turn", prompt + first[0].output_tokens + fb, 4))
    side.eng.generate_blocking(again)


CASES = {
    "grpo_burst": (_grpo_burst, {}),
    "multi_turn": (_multi_turn, {}),
    "interruption_resume": (_resume, {}),
    "abort_storm_live_swap": (_abort_storm, {}),
    "strict_reload": (_strict_reload, {"retain_kv_on_reload": False}),
    "share_off": (_grpo_burst, {"share_prefix": False}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(trees, case):
    drive, kw = CASES[case]
    jax_side, port_side = _sides(trees, **kw)
    drive(jax_side)
    drive(port_side)
    assert port_side.reqs.keys() == jax_side.reqs.keys()
    for key, want in jax_side.reqs.items():
        for w, g in zip(want, port_side.reqs[key]):
            assert g.output_tokens == w.output_tokens, key
            np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                       atol=LOGP_ATOL, rtol=0, err_msg=key)
            assert g.output_versions == w.output_versions, key
            assert g.stop_reason == w.stop_reason, key
            assert g.cache_hit_tokens == w.cache_hit_tokens, key
    want = {k: jax_side.eng.stats[k] for k in COUNTERS}
    got = {k: port_side.eng.stats[k] for k in COUNTERS}
    assert got == want
    assert port_side.eng.prefix_cache_hit_rate() == jax_side.eng.prefix_cache_hit_rate()
    # what each case is there to exercise
    if case in ("grpo_burst", "abort_storm_live_swap"):
        assert got["shared_tokens"] > 0 and got["copy_calls"] > 0
    if case in ("multi_turn", "interruption_resume", "abort_storm_live_swap"):
        assert got["reused_tokens"] > 0
    if case == "share_off":
        assert got["shared_tokens"] == got["copy_calls"] == 0
    if case == "strict_reload":
        assert got["reused_tokens"] == 0 and (port_side.eng.kv_version == 1).all()
    np.testing.assert_array_equal(port_side.eng.kv_version, jax_side.eng.kv_version)
    np.testing.assert_array_equal(port_side.eng.retained_len, jax_side.eng.retained_len)


def _cache_case(seed, L, S, M, Hkv, hd):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((L, S, M, Hkv, hd)).astype(np.float32) for k in "kv"}


def test_forward_prefill_cached_matches_jax(trees):
    """Three suffix rows (a retained self-copy, a fan-out copy from another
    row, a row near the cache's end whose padding runs past it) and a pad
    row, with a copy block and a key window."""
    import jax.numpy as jnp

    from areal_tpu.models.transformer import forward_prefill_cached as jax_cached

    jcfg, ts = trees
    cfg = tiny_config(**KW)
    model = params_from_jax(ts[0], cfg, "cpu")
    M, S = 64, 5  # rows 0..3, scratch row 4
    cache = _cache_case(7, cfg.num_layers, S, M, cfg.num_kv_heads, cfg.head_dim_)
    rng = np.random.default_rng(8)
    P = 16
    ids = rng.integers(0, 97, (4, P)).astype(np.int32)
    starts = np.array([20, 17, 56, 0], np.int32)
    slens = np.array([9, 5, 3, 1], np.int32)
    slots = np.array([0, 1, 2, 4], np.int32)
    copy_src = np.array([0, 3, 2, 4], np.int32)
    want_logits, want_cache = jax_cached(
        ts[0], jcfg, jnp.asarray(ids), jnp.asarray(starts), jnp.asarray(slens),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(slots),
        copy_src=jnp.asarray(copy_src), copy_block=32, key_window=64)
    mine = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got_logits, got_cache = forward_prefill_cached(
        model, torch.from_numpy(ids).long(), torch.from_numpy(starts),
        torch.from_numpy(slens), mine, torch.from_numpy(slots),
        copy_src=torch.from_numpy(copy_src), copy_block=32, key_window=64)
    assert got_cache is mine  # written in place
    np.testing.assert_allclose(got_logits[:3].numpy(), np.asarray(want_logits)[:3],
                               atol=LOGIT_ATOL, rtol=0)
    for k in "kv":
        # the scratch row differs by design: the JAX scatter drops the
        # positions past the cache's end that the port writes there
        np.testing.assert_allclose(got_cache[k][:, :4].numpy(),
                                   np.asarray(want_cache[k])[:, :4], atol=CACHE_ATOL, rtol=0)
        # row 1 took row 3's prefix [0, 17) before its suffix
        np.testing.assert_array_equal(got_cache[k][:, 1, :17].numpy(), cache[k][:, 3, :17])


def test_copy_kv_prefix_bit_equal_to_jax():
    """Sources and destinations overlapping (a row that is its own source,
    a row that is another's source and a destination) and scratch-padded
    duplicates."""
    import jax.numpy as jnp

    from areal_tpu.ops.kv_copy import copy_kv_prefix as jax_copy

    cache = _cache_case(9, 2, 6, 32, 2, 8)
    src = np.array([1, 2, 0, 5, 5, 5], np.int32)
    dst = np.array([1, 0, 3, 5, 5, 5], np.int32)
    want = jax_copy({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(src),
                    jnp.asarray(dst), 16)
    got = copy_kv_prefix({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
                         torch.from_numpy(src), torch.from_numpy(dst), 16)
    for k in "kv":
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # row 3 holds row 0's ORIGINAL prefix (gathered before row 0 was written)
    np.testing.assert_array_equal(got["k"][:, 3, :16].numpy(), cache["k"][:, 0, :16])
