"""The host KV tier of the port's engine (`host_offload`: `_maybe_spill`,
`_swap_in_host_hits`, `ops/kv_copy.py` `gather_kv_prefix` and
`scatter_kv_prefix`).

- `gather_kv_prefix` and `scatter_kv_prefix` against the JAX functions on
  the same cache: equal bytes.
- Torch against torch (the behaviours of `tests/test_paged_cache.py`): a
  retained prefix pushed through host memory and swapped back continues
  as if it had never left the device; an interrupted generation resumes
  through the host tier to the uninterrupted stream; sampled streams do
  not depend on the tier; the prefix-cache counters; a migration keeps
  the page table a permutation.  The swapped-in bytes equal the spilled
  bytes exactly, in f32 and bf16 caches.  Tokens compare exactly,
  logprobs within 1e-3 (`tests/test_torch_tiers.py` says why).
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.ops.kv_copy import gather_kv_prefix, scatter_kv_prefix
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
ENGINE = dict(n_slots=2, max_seq_len=128, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)
HOST = dict(host_offload=True, host_cache_mb=8, host_min_tokens=8)
LOGP_ATOL = 1e-3


@pytest.fixture(scope="module")
def params():
    return init_params(tiny_config(**KW), 0, "cpu")


def _engine(params, **kw):
    return GenEngine(params.cfg, params=params, device="cpu", **dict(ENGINE, **kw))


def _run(eng, batches):
    """Submit batches of (rid, ids, new[, temperature]) one after another."""
    done = []
    for batch in batches:
        reqs = [GenRequest(rid=rid, input_ids=list(ids), max_new_tokens=n,
                           temperature=temp[0] if temp else 0.0, top_p=0.9 if temp else 1.0)
                for rid, ids, n, *temp in batch]
        eng.generate_blocking(reqs)
        done.extend(reqs)
    return done


def _fillers(seed, count=2, n=4, length=20):
    rng = np.random.default_rng(seed)
    return [(f"fill-{i}", rng.integers(0, 97, length).tolist(), n) for i in range(count)]


def _same(got, want):
    assert got.output_tokens == want.output_tokens, got.rid
    np.testing.assert_allclose(got.output_logprobs, want.output_logprobs, atol=LOGP_ATOL, rtol=0)


def test_gather_and_scatter_match_the_jax_functions():
    import jax.numpy as jnp

    from areal_tpu.ops import kv_copy as ref

    rng = np.random.default_rng(0)
    cache = {k: rng.standard_normal((2, 5, 64, 2, 8)).astype(np.float32) for k in ("k", "v")}
    port = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    want = ref.gather_kv_prefix({k: jnp.asarray(v) for k, v in cache.items()}, jnp.int32(3), 32)
    got = gather_kv_prefix(port, 3, 32)
    for k in cache:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()
    blk = {k: rng.standard_normal((2, 32, 2, 8)).astype(np.float32) for k in cache}
    want = ref.scatter_kv_prefix({k: jnp.asarray(v) for k, v in cache.items()},
                                 {k: jnp.asarray(v) for k, v in blk.items()}, jnp.int32(1))
    scatter_kv_prefix(port, {k: torch.from_numpy(v) for k, v in blk.items()}, 1)
    for k in cache:
        assert port[k].numpy().tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_spill_and_swap_in_are_bit_identical(params, kv_dtype):
    """A row gathered to host memory and scattered into another row lands
    byte for byte, in the cache's dtype."""
    eng = _engine(params, kv_dtype=kv_dtype, **HOST)
    _run(eng, [[("a", np.random.default_rng(1).integers(0, 97, 40).tolist(), 6)]])
    row = eng.pool.row(int(np.flatnonzero(eng.retained_len)[0]))
    kv = eng._host_gather(row, 64)
    assert all(v.dtype == eng.cache["k"].dtype and not v.is_cuda for v in kv.values())
    eng._host_scatter(kv, eng.n_slots)  # the scratch row
    for k, buf in eng.cache.items():
        assert torch.equal(buf[:, eng.n_slots, :64].view(torch.int16 if kv_dtype == "bfloat16"
                                                         else torch.int32),
                           buf[:, row, :64].view(torch.int16 if kv_dtype == "bfloat16"
                                                 else torch.int32))


def test_host_swap_round_trip_matches_a_device_resident_prefix(params):
    """Turn 1's prefix is evicted to host memory by two fillers and swapped
    back by turn 2's radix hit: turn 2 equals an engine with the slots to
    keep it on the device, and its bytes equal the spilled bytes."""
    rng = np.random.default_rng(21)
    turn1 = rng.integers(0, 97, 24).tolist()
    fills = _fillers(22)
    ref_eng = _engine(params, n_slots=4)
    r1 = _run(ref_eng, [[("t1", turn1, 6)]])[0]
    transcript = turn1 + r1.output_tokens + rng.integers(0, 97, 4).tolist()
    ref_t2 = _run(ref_eng, [fills, [("t2", transcript, 6)]])[-1]
    assert ref_eng.stats["prefix_cache_host_swaps"] == 0

    eng = _engine(params, **HOST)
    h1 = _run(eng, [[("t1", turn1, 6)]])[0]
    _same(h1, r1)
    _run(eng, [fills])
    (hid, ent), = eng.pool.host._store.items()  # turn 1's; a filler took the free slot
    spilled = {k: v.clone() for k, v in ent.kv.items()}
    assert ent.valid_len == len(turn1) + 5 and eng.stats["prefix_cache_host_swaps"] == 1
    t2 = _run(eng, [[("t2", transcript, 6)]])[0]
    # the swap-in's landing slot spills its filler's prefix first
    assert eng.stats["prefix_cache_host_swaps"] == 3
    assert eng.stats["suffix_calls"] >= 1 and t2.cache_hit_tokens == ent.valid_len
    _same(t2, ref_t2)
    s = next(s for s in range(eng.n_slots)
             if (toks := eng.pool.device_tokens(s)) is not None and len(toks) > len(transcript))
    for k, v in spilled.items():
        assert torch.equal(eng.cache[k][:, eng.pool.row(s), :ent.valid_len],
                           v[:, :ent.valid_len])
    eng.pool.check_page_table()


def test_interrupted_generation_resumes_through_the_host_tier(params):
    """An aborted generation's prefix survives a spill and a swap-in and
    resumes to the uninterrupted greedy stream.  No abort reservation, so
    that the second filler overwrites (and spills) the aborted slot."""
    prompt = np.random.default_rng(23).integers(0, 97, 16).tolist()
    want = _run(_engine(params), [[("w", prompt, 10)]])[0]
    eng = _engine(params, abort_reserve_s=0.0, **HOST)
    r1 = GenRequest(rid="i", input_ids=list(prompt), max_new_tokens=10, temperature=0.0)
    eng.submit(r1)
    while len(r1.output_tokens) < 3:
        eng.step(chunk=2)
    eng.abort_all("abort")
    got = len(r1.output_tokens)
    assert got >= 3 and r1.stop_reason == "abort"
    _run(eng, [_fillers(24)])
    assert eng.stats["prefix_cache_host_swaps"] == 1
    resumed = _run(eng, [[("i", prompt + r1.output_tokens, 10 - got)]])[0]
    assert eng.stats["prefix_cache_host_swaps"] == 3  # a filler's spill, the swap-in
    assert resumed.cache_hit_tokens == len(prompt) + got - 1
    assert r1.output_tokens + resumed.output_tokens == want.output_tokens


def test_sampled_streams_do_not_depend_on_the_host_tier(params):
    turn1 = np.random.default_rng(25).integers(0, 97, 24).tolist()
    fills = _fillers(26)
    outs = []
    for kw in (dict(n_slots=4), HOST):
        eng = _engine(params, **kw)
        r1 = _run(eng, [[("s1", turn1, 6, 1.0)]])[0]
        r2 = _run(eng, [fills, [("s2", turn1 + r1.output_tokens, 6, 1.0)]])[-1]
        outs.append((r1, r2, eng.stats["prefix_cache_host_swaps"]))
    (a1, a2, swaps_ref), (b1, b2, swaps_host) = outs
    assert swaps_ref == 0 and swaps_host >= 2
    _same(b1, a1)
    _same(b2, a2)


def test_prefix_cache_counters(params):
    eng = _engine(params, n_slots=4)
    prompt = np.random.default_rng(28).integers(0, 97, 20).tolist()
    _run(eng, [[("a", prompt, 4)]])
    assert (eng.stats["prefix_cache_misses"], eng.stats["prefix_cache_hits"]) == (1, 0)
    assert eng.prefix_cache_hit_rate() == 0.0
    a2 = _run(eng, [[("a2", prompt + [5, 6, 7, 8, 9], 4)]])[0]
    assert eng.stats["prefix_cache_hits"] == 1 and eng.prefix_cache_hit_rate() == 0.5
    assert a2.cache_hit_tokens >= len(prompt) - 1
    before = eng.stats["prefix_cache_evictions"]
    _run(eng, [_fillers(29, count=4)])
    assert eng.stats["prefix_cache_evictions"] >= before + 1
    # with the host tier, a filler's overwrite spills instead
    host = _engine(params, n_slots=4, **HOST)
    _run(host, [[("a", prompt, 4)], _fillers(29, count=4)])
    assert host.stats["prefix_cache_host_swaps"] == 1 and len(host.pool.host) == 1


def test_migration_keeps_the_page_table_a_permutation(params):
    eng = _engine(params, n_slots=4, decode_tiers=2)
    rng = np.random.default_rng(31)
    _run(eng, [[(f"m{i}", rng.integers(0, 97, 6).tolist(), 40) for i in range(4)]])
    eng.pool.check_page_table()
    assert any(eng.pool.device_tokens(s) is not None for s in range(eng.n_slots))
