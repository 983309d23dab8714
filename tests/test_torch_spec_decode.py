"""The port's speculative decoding (`gen/spec.py`, `forward_verify`, the
engine's verify step) against the JAX package's, and its own invariants.

- The drafter and the controller: the behaviours of the JAX package's
  `test_propose_draft_*` and `test_spec_controller_*`, on the port's copy.
- One JAX-against-port case: a greedy request over a periodic prompt with
  `spec_draft_len=3` through `areal_tpu.gen.engine.GenEngine` (its verify
  on the ragged kernel in interpret mode) and the port's engine, on the
  same converted weights: streams equal, logprobs within 1e-4 (f32 in
  another op order, as `test_torch_engine.py`).
- Torch against torch, f32 on the CPU: spec on equals spec off, token for
  token.  Logprobs agree to 1e-3, not bit for bit: a verify's projections
  are products of [B * (D + 1), d] rows where decode's are [B, d], and the
  CPU's matrix products need not round a row the same at every row count
  or thread count (the first prefill of a process has been seen a few 1e-6
  off a rerun's), and a last-bit difference compounds along a stream
  through the K/V it writes (to 4e-4 over 64 tokens of a 4-layer model).
  A row taken from the wrong position would be off by whole nats.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.gen.spec import SpecController, propose_draft
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
ENGINE = dict(n_slots=4, max_seq_len=256, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4, seed=3)
LOGP_ATOL = 1e-3  # torch against torch (module docstring)
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(**KW)
    return cfg, init_params(cfg, 0, "cpu")


def _engine(cfg, params, **kw):
    return GenEngine(cfg, params=params, device="cpu", **dict(ENGINE, **kw))


def _same(got, want):
    """Equal token streams and stop reasons, logprobs within LOGP_ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens, g.rid
        assert g.stop_reason == w.stop_reason, g.rid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=LOGP_ATOL, rtol=0)


def _rep_prompt(rng, seg_len, total):
    """A random segment tiled: prompt lookup finds drafts."""
    seg = rng.integers(0, 97, seg_len).tolist()
    return (seg * (total // seg_len + 1))[:total]


def _every_token_prompt(rng, tail):
    """Every token of the vocabulary once, then a repetitive tail: any
    pending token has an earlier occurrence, so every step drafts, and at
    temperature 1 most drafts are rejected."""
    return rng.permutation(97).tolist() + _rep_prompt(rng, 5, tail)


def _rep_reqs(seed, temperature):
    """Mixed lengths and budgets over repetitive prompts, plus one
    non-repetitive request (steps where nobody drafts stay plain decode)."""
    rng = np.random.default_rng(seed)
    specs = [(4, 12, 10, 1.0), (6, 24, 30, 0.9), (3, 9, 12, 1.0)]
    reqs = [GenRequest(rid=f"r{i}", input_ids=_rep_prompt(rng, s, n), max_new_tokens=m,
                       temperature=temperature, top_p=tp)
            for i, (s, n, m, tp) in enumerate(specs)]
    reqs.append(GenRequest(rid="r3", input_ids=rng.integers(0, 97, 40).tolist(),
                           max_new_tokens=9, temperature=temperature))
    return reqs


def _cyclic(cfg, params):
    """A copy whose attention output projections are zero: greedy next token
    is a function of the current token, so every stream settles into a
    short cycle the drafter locks onto (drafts and acceptances guaranteed)."""
    cyc = init_params(cfg, 0, "cpu")
    cyc.load_state_dict(params.state_dict())
    with torch.no_grad():
        for layer in cyc.model.layers:
            layer.self_attn.o_proj.weight.zero_()
    return cyc


# ---------------------------------------------------------------------------
# the drafter and the controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("history,max_draft,want", [
    # the longest suffix n-gram with an earlier occurrence is [1, 2, 3]; the
    # rightmost one starts at 4, so the draft continues from 7
    ([1, 2, 3, 9, 1, 2, 3, 5, 1, 2, 3], 4, [5, 1, 2, 3]),
    ([1, 2, 3, 9, 1, 2, 3, 5, 1, 2, 3], 2, [5, 1]),  # max_draft truncates
    # on a short cycle the overall-rightmost match cannot fill the draft;
    # the drafter steps back to the rightmost one that can
    ([1, 2, 3] * 4, 6, [1, 2, 3, 1, 2, 3]),
    # [4, 2, 5] and [2, 5] never recur; [5] does (index 1)
    ([9, 5, 7, 4, 2, 5], 3, [7, 4, 2]),
    ([], 4, []),
    ([7], 4, []),  # nothing precedes
    ([1, 2, 3, 4, 5], 4, []),  # no repeat
    ([7, 7, 7], 0, []),  # D = 0
    ([7, 7], 3, [7]),
])
def test_propose_draft(history, max_draft, want):
    got = propose_draft(np.array(history, np.int32), max_draft)
    assert got.tolist() == want
    assert propose_draft(np.array(history, np.int32), max_draft).tolist() == want  # deterministic


def test_spec_controller_ladder_selection():
    c = SpecController(ladder=(0, 3, 7), probe_every=4)
    assert c.draft_len(0) == 7  # optimistic start, no signal yet
    for _ in range(8):
        c.record(0, 7, 6)  # high acceptance
    assert c.draft_len(0) == 7
    assert c.acceptance_rate(0) == pytest.approx(6 / 7)

    mid = SpecController(ladder=(0, 3, 7), probe_every=4)
    for _ in range(8):
        mid.record(0, 7, 2)  # 0.2 <= rate < 0.5: the lowest nonzero rung
    assert mid.draft_len(0) == 3

    cold = SpecController(ladder=(0, 3, 7), probe_every=4)
    for _ in range(8):
        cold.record(0, 7, 0)
    picks = [cold.draft_len(0) for _ in range(8)]
    assert 0 in picks  # parked on plain decode...
    assert 3 in picks  # ...but probing at the cadence, so it can climb back
    assert cold.acceptance_rate(0) == 0.0
    assert cold.draft_len(1) == 7  # another tier has no history: optimistic


@pytest.mark.parametrize("ladder", [(0,), (-1, 3)])
def test_spec_controller_validates_ladder(ladder):
    with pytest.raises(ValueError):
        SpecController(ladder=ladder)


def test_engine_gates_the_kernel_at_the_top_rung():
    """The engine checks the ragged kernel's gate at T = max(ladder) + 1:
    heads whose query rows fit one block at T = 1 but not at T = 8 raise
    with spec decoding on and serve without it."""
    cfg = tiny_config(**dict(KW, num_heads=40, num_kv_heads=1, head_dim=128))
    params = init_params(cfg, 0, "cpu")
    GenEngine(cfg, params=params, device="cpu", n_slots=2, max_seq_len=64)
    with pytest.raises(ValueError, match="8 query rows"):
        GenEngine(cfg, params=params, device="cpu", n_slots=2, max_seq_len=64,
                  spec_decode=True)


@pytest.mark.parametrize("fields,flags", [
    (dict(), []),
    (dict(spec_decode=True), ["--spec-decode"]),
    (dict(spec_decode=True, spec_ladder=[0, 2, 5], spec_draft_len=4),
     ["--spec-decode", "--spec-ladder=0,2,5", "--spec-draft-len=4"]),
])
def test_launcher_passes_the_spec_fields(fields, flags):
    """GenServerConfig's spec fields reach the launched server's command
    line as the JAX launcher's flags (none when spec decoding is off)."""
    from areal_tpu_torch.api.config import GenServerConfig
    from areal_tpu_torch.launcher.local import build_server_cmd

    cmd = build_server_cmd(GenServerConfig(**fields), 8000)
    assert [c for c in cmd if c.startswith("--spec")] == flags


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------


def test_forward_verify_matches_jax():
    """`forward_verify` at T = 8 against the JAX function on its ragged
    path (the Pallas kernel in interpret mode): a permuted page table,
    short drafts (n_write < T), an idle slot whose writes drop, over one
    random cache.  Logits to 1e-4, the caches after the verify too."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny
    from areal_tpu.models.transformer import forward_verify as jax_verify

    from areal_tpu_torch.models import transformer as pt

    jcfg = jax_tiny(**KW)
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    cfg = tiny_config(**KW)
    model = params_from_jax(tree, cfg, "cpu")
    rng = np.random.default_rng(7)
    S, M, page, T = 4, 64, 16, 8
    plens = np.array([20, 9, 31], np.int32)
    rows = np.array([2, 0, 3], np.int32)
    shape = (cfg.num_layers, S, M, cfg.num_kv_heads, cfg.head_dim_)
    init = {name: rng.standard_normal(shape).astype(np.float32) for name in ("k", "v")}
    jcache = {name: jnp.asarray(a) for name, a in init.items()}
    cache = {name: torch.from_numpy(a.copy()) for name, a in init.items()}
    tokens = rng.integers(0, 97, (3, T)).astype(np.int32)
    n_write = np.array([8, 3, 1], np.int32)
    active = np.array([True, False, True])
    K = 48  # a bucket past the deepest row's span + T
    jl, jcache = jax.jit(jax_verify, static_argnums=(1,),
                         static_argnames=("key_window", "ragged", "page_size"))(
        tree, jcfg, jnp.asarray(tokens), jnp.asarray(plens), jcache, key_window=K,
        active=jnp.asarray(active), n_write=jnp.asarray(n_write), rows=jnp.asarray(rows),
        ragged=True, page_size=page)
    logits, cache = pt.forward_verify(
        model, torch.from_numpy(tokens).long(), torch.from_numpy(plens), cache,
        torch.from_numpy(rows), page_size=page, key_window=K,
        active=torch.from_numpy(active), n_write=torch.from_numpy(n_write))
    assert logits.shape == (3, T, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=JAX_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   atol=JAX_ATOL, rtol=0, err_msg=f"{name}-cache")


def test_greedy_spec_stream_matches_jax_engine():
    """A greedy request over a periodic prompt with spec_draft_len=3: the
    port's stream equals the JAX spec engine's, logprobs to 1e-4, and the
    port's engine drafted and verified on the way."""
    import jax

    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest
    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**KW)
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    cfg = tiny_config(**KW)
    prompt = [5, 6, 7, 8] * 3
    kw = dict(ENGINE, decode_chunk=2, spec_decode=True, spec_draft_len=3)

    def req(cls):
        return [cls(rid="p", input_ids=list(prompt), max_new_tokens=16, temperature=0.0)]

    want = JaxEngine(jcfg, params=tree, ragged_attn=True, **kw).generate_blocking(
        req(JaxRequest))[0]
    eng = GenEngine(cfg, params=params_from_jax(tree, cfg, "cpu"), device="cpu", **kw)
    got = eng.generate_blocking(req(GenRequest))[0]
    assert got.output_tokens == want.output_tokens
    np.testing.assert_allclose(got.output_logprobs, want.output_logprobs, atol=JAX_ATOL, rtol=0)
    assert eng.stats["verify_calls"] > 0 and eng.stats["spec_drafted"] > 0


# ---------------------------------------------------------------------------
# torch against torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("layout", ["fresh", "reused"])
def test_spec_on_matches_spec_off(setup, temperature, layout):
    """The same workload with spec on and off gives the same streams, greedy
    and sampled.  "reused": a second wave resubmits each first-wave request
    with its output appended, so its admission rides the retained prefix
    (suffix prefill) that the first wave's verifies left behind."""
    cfg, params = setup

    def run(**kw):
        eng = _engine(cfg, params, **kw)
        first = eng.generate_blocking(_rep_reqs(11, temperature))
        if layout == "fresh":
            return eng, first
        second = [GenRequest(rid=r.rid + "b", input_ids=r.input_ids + r.output_tokens,
                             max_new_tokens=10, temperature=temperature)
                  for r in first]
        return eng, eng.generate_blocking(second)

    plain_eng, plain = run()
    spec_eng, spec = run(spec_decode=True)
    _same(spec, plain)
    assert spec_eng.stats["verify_calls"] > 0 and spec_eng.stats["spec_drafted"] > 0
    assert plain_eng.stats["verify_calls"] == 0
    if layout == "reused":
        assert spec_eng.stats["reused_tokens"] > 0
        assert spec_eng.stats["reused_tokens"] == plain_eng.stats["reused_tokens"]


def test_spec_accepts_drafts_on_cyclic_stream(setup):
    """A cyclic greedy stream accepts most drafts, equals the spec-off
    stream, and takes fewer dispatches than tokens."""
    cfg, params = setup
    cyc = _cyclic(cfg, params)

    def reqs():
        return [GenRequest(rid="cyc", input_ids=[5, 9, 13], max_new_tokens=48,
                           temperature=0.0)]

    plain = _engine(cfg, cyc).generate_blocking(reqs())
    eng = _engine(cfg, cyc, spec_decode=True)
    _same(eng.generate_blocking(reqs()), plain)
    assert eng.stats["spec_accepted"] / eng.stats["spec_drafted"] > 0.5, eng.stats
    assert eng.stats["decode_calls"] + eng.stats["verify_calls"] < 48
    assert eng.spec_acceptance_rates()[0] > 0.5


def test_rejected_draft_kv_never_persists(setup):
    """At every step boundary the cache rows at or above a live slot's
    frontier are zero (a rejected draft's K/V never outlives its verify),
    and the slot's `seq_tokens` hold exactly the prompt and the delivered
    tokens; when the request finishes, the radix index records that same
    history.  The prompt fills its bucket (16), so prefill writes no pad
    rows and any nonzero row past the frontier came from a verify."""
    cfg, params = setup
    eng = _engine(cfg, params, spec_decode=True, decode_chunk=4)
    rng = np.random.default_rng(5)
    req = GenRequest(rid="kv", input_ids=_rep_prompt(rng, 5, 16), max_new_tokens=96,
                     temperature=1.0)
    eng.submit(req)
    slot = None
    while not req.stop_reason:
        eng.step(chunk=4)
        s = next((i for i in range(eng.n_slots) if eng.slot_req[i] is req), None)
        if s is None:
            continue
        slot = s
        frontier = int(eng.lengths[s])
        for name in ("k", "v"):
            assert not eng.cache[name][:, s, frontier:].any(), (name, frontier)
        history = req.input_ids + req.output_tokens
        assert eng.seq_tokens[s, :frontier + 1].tolist() == history
    assert eng.stats["spec_drafted"] > eng.stats["spec_accepted"]  # drafts were rejected
    history = req.input_ids + req.output_tokens
    n = int(eng.retained_len[slot])
    assert eng.pool.device_tokens(slot).tolist() == history[:n]


def test_spec_interrupt_resume_parity(setup):
    """abort_all mid-stream, then the client's resume (prompt + tokens so
    far): the spec engine's two halves equal the spec-off engine's under
    the same cut, and the resume reused the retained prefix."""
    cfg, params = setup
    prompt = _every_token_prompt(np.random.default_rng(8), 20)

    def run(spec, cut=None):
        eng = _engine(cfg, params, spec_decode=spec, decode_chunk=2 if spec else 1)
        r = GenRequest(rid="i", input_ids=list(prompt), max_new_tokens=12, temperature=1.0)
        eng.submit(r)
        while len(r.output_tokens) < (cut or 3):
            eng.step()
        eng.abort_all("abort")
        assert r.stop_reason == "abort"
        r2 = GenRequest(rid="i", input_ids=prompt + r.output_tokens,
                        max_new_tokens=12 - len(r.output_tokens), temperature=1.0)
        eng.generate_blocking([r2])
        assert eng.stats["suffix_calls"] >= 1
        return eng, r, r2

    spec_eng, s1, s2 = run(True)
    _, p1, p2 = run(False, cut=len(s1.output_tokens))
    assert len(p1.output_tokens) == len(s1.output_tokens)
    assert spec_eng.stats["verify_calls"] > 0
    assert s1.output_tokens + s2.output_tokens == p1.output_tokens + p2.output_tokens
    np.testing.assert_allclose(s1.output_logprobs + s2.output_logprobs,
                               p1.output_logprobs + p2.output_logprobs, atol=LOGP_ATOL)


def test_spec_live_publish_parity(setup):
    """swap_weights_live mid-stream with spec on: nothing aborts, and
    tokens, logprobs and versions equal the spec-off engine's publishing at
    the same token."""
    cfg, params = setup
    new_params = init_params(cfg, 123, "cpu")
    prompt = _every_token_prompt(np.random.default_rng(17), 24)

    def run(spec, cut=None):
        eng = _engine(cfg, params, spec_decode=spec, decode_chunk=4 if spec else 1)
        r = GenRequest(rid="lp", input_ids=list(prompt), max_new_tokens=16, temperature=1.0)
        eng.submit(r)
        while len(r.output_tokens) < (cut or 4):
            eng.step()
        eng.swap_weights_live(new_params)
        assert not r.stop_reason
        while not r.stop_reason:
            eng.step()
        return eng, r

    spec_eng, rs = run(True)
    cut = rs.output_versions.index(1)
    _, rp = run(False, cut=cut)
    assert rp.output_versions.index(1) == cut
    assert rs.output_tokens == rp.output_tokens
    assert rs.output_versions == rp.output_versions
    np.testing.assert_allclose(rs.output_logprobs, rp.output_logprobs, atol=LOGP_ATOL)
    assert set(rs.output_versions) == {0, 1} and spec_eng.stats["verify_calls"] > 0


def test_spec_group_fanout_parity(setup):
    """A GRPO group with spec on: one prefill and one fan-out copy, then
    every sibling drafts from its own history and emits the solo stream."""
    cfg, params = setup
    cyc = _cyclic(cfg, params)
    prompt = _rep_prompt(np.random.default_rng(4), 6, 24)
    ref = GenRequest(rid="ref", input_ids=list(prompt), max_new_tokens=12, temperature=0.0)
    _engine(cfg, cyc, decode_chunk=2).generate_blocking([ref])
    eng = _engine(cfg, cyc, decode_chunk=2, spec_decode=True)
    reqs = [GenRequest(rid=f"G-{i}", input_ids=list(prompt), max_new_tokens=12,
                       temperature=0.0, group_id="G", group_n=4) for i in range(4)]
    eng.generate_blocking(reqs)
    _same(reqs, [ref] * 4)
    assert eng.stats["prefill_calls"] == 1 and eng.stats["copy_calls"] == 1
    assert eng.stats["spec_drafted"] > 0
