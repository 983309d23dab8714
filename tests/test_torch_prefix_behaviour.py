"""Behaviours of the port engine's prefix reuse, abort reservations and
group fan-out, torch against torch (the behaviours of
`tests/test_group_fanout.py` and the reuse cases of `tests/test_gen_engine.py`
that are not a comparison with the JAX engine).

Setup as in `tests/test_group_fanout.py`: tiny config, vocab 97, f32 KV,
8 slots, max_seq_len 128, prompt bucket 16, reuse_min_tokens 4, on the
CPU.  Time-dependent behaviours (the group-hold TTL, a reservation's
lapse) run on a clock the test advances by hand (the engine module's
`time`), not on a wall-clock deadline.  One `gpu` test runs share on
against share off on the card: the accounting identity, the ragged kernel's
launches and greedy streams.
"""

import sys
import threading
import time as _time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import engine as engine_mod
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
ENGINE = dict(n_slots=8, max_seq_len=128, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)


@pytest.fixture(scope="module")
def model():
    return init_params(tiny_config(**KW), 0, "cpu")


@pytest.fixture
def clock(monkeypatch):
    """The engine module's `time`, with a monotonic clock the test moves."""
    now = {"t": 1000.0}
    fake = SimpleNamespace(monotonic=lambda: now["t"], perf_counter=_time.perf_counter,
                           sleep=lambda s: None)
    monkeypatch.setattr(engine_mod, "time", fake)

    def advance(dt):
        now["t"] += dt
    return advance


def _engine(model, **kw):
    return GenEngine(model.cfg, params=model, device="cpu", **dict(ENGINE, **kw))


def _prompt(rng, n):
    return rng.integers(0, 97, n).tolist()


def _group(prompt, n, gid, max_new=6, temperature=0.0, counts=None):
    reqs = []
    for i in range(n):
        r = GenRequest(rid=f"{gid}-{i}", input_ids=list(prompt), max_new_tokens=max_new,
                       temperature=temperature, group_id=gid, group_n=n)
        if counts is not None:
            counts[r.rid] = 0
            r.on_done = lambda rr: counts.__setitem__(rr.rid, counts[rr.rid] + 1)
        reqs.append(r)
    return reqs


def _accounted(eng):
    st = eng.stats
    return (st["prefill_tokens"] + st["suffix_tokens"] + st["reused_tokens"]
            + st["shared_tokens"])


def _sampled_siblings_stay_independent(model, clock):
    """Siblings share prefix K/V, not randomness: a sampled group still
    diversifies, and each sibling's stream equals the same stream id
    decoded alone with no sharing."""
    rng = np.random.default_rng(1)
    prompt = _prompt(rng, 20)
    eng = _engine(model)
    reqs = _group(prompt, 6, "S", max_new=10, temperature=1.0)
    eng.generate_blocking(reqs)
    assert len({tuple(r.output_tokens) for r in reqs}) > 1
    assert eng.stats["shared_tokens"] == 5 * (len(prompt) - 1)
    assert _accounted(eng) == 6 * len(prompt)
    assert eng.prefix_cache_hit_rate() == 5 / 6  # the 5 siblings of 6 admissions
    alone = GenRequest(rid="a", input_ids=list(prompt), max_new_tokens=10, temperature=1.0,
                       stream_id=reqs[3].stream_id)
    _engine(model, share_prefix=False).generate_blocking([alone])
    assert alone.output_tokens == reqs[3].output_tokens
    np.testing.assert_allclose(alone.output_logprobs, reqs[3].output_logprobs, atol=1e-5)


def _clustered_admits_no_fewer(model, clock):
    """Clustering changes how prompts prefill, never whether they admit:
    the same burst admits as many requests on the first pass with sharing
    on as off, and completes with the same greedy streams."""
    rng = np.random.default_rng(3)
    p_a, p_b = _prompt(rng, 18), _prompt(rng, 14)
    singles = [_prompt(rng, 10) for _ in range(2)]
    admitted, outputs = {}, {}
    for share in (True, False):
        eng = _engine(model, share_prefix=share)
        reqs = _group(p_a, 3, "A", max_new=4) + _group(p_b, 3, "B", max_new=4)
        reqs += [GenRequest(rid=f"s{i}", input_ids=list(p), max_new_tokens=4,
                            temperature=0.0) for i, p in enumerate(singles)]
        eng.submit_batch(reqs)
        eng.step(chunk=1)
        admitted[share] = sum(r is not None for r in eng.slot_req)
        while any(not r.stop_reason for r in reqs):
            eng.step()
        outputs[share] = [tuple(r.output_tokens) for r in reqs]
    assert admitted[True] >= admitted[False] == len(outputs[True])
    assert outputs[True] == outputs[False]


def _reservation_strictly_greater(model, clock):
    """A slot whose retained prefix is exactly reuse_min_tokens long is not
    reserved by abort_all (its owner's resubmit could never claim it);
    a longer one is."""
    rng = np.random.default_rng(6)
    eng = _engine(model, n_slots=2, reuse_min_tokens=8, abort_reserve_s=30.0)
    r1 = GenRequest(rid="eq", input_ids=_prompt(rng, 7), max_new_tokens=8, temperature=0.0)
    eng.submit(r1)
    eng._admit()  # the prefill's token is delivered: lengths 7 + 1 pending
    s_eq = next(s for s in range(2) if eng.slot_req[s] is r1)
    assert int(eng.lengths[s_eq]) == 7
    eng.step(chunk=1)
    assert int(eng.lengths[s_eq]) == 8
    eng.abort_all("abort")
    assert eng._reserved_until[s_eq] == 0.0
    r2 = GenRequest(rid="gt", input_ids=_prompt(rng, 16), max_new_tokens=8, temperature=0.0)
    eng.submit(r2)
    eng.step(chunk=1)
    s_gt = next(s for s in range(2) if eng.slot_req[s] is r2)
    eng.abort_all("abort")
    assert eng._reserved_until[s_gt] > engine_mod.time.monotonic()


def _abort_mid_pass(model, clock):
    """An abort_all landing mid-admission (between the intake and the
    holdback write-back) finishes every drained request exactly once and
    resurrects none; the engine serves cleanly afterwards."""
    rng = np.random.default_rng(7)
    eng = _engine(model, n_slots=2)
    counts: dict = {}
    reqs = []
    for i in range(6):  # more than the slots: some are held back
        r = GenRequest(rid=f"h{i}", input_ids=_prompt(rng, 10), max_new_tokens=4,
                       temperature=0.0)
        counts[r.rid] = 0
        r.on_done = lambda rr: counts.__setitem__(rr.rid, counts[rr.rid] + 1)
        reqs.append(r)
        eng.submit(r)
    orig = eng._plan_clusters

    def aborting_plan(entries, matched):
        eng.abort_all("abort")
        return orig(entries, matched)

    eng._plan_clusters = aborting_plan
    eng.step()
    eng._plan_clusters = orig
    with eng._lock:
        assert not eng._holdback and not eng._admitting
    assert all(r.stop_reason == "abort" and counts[r.rid] == 1 for r in reqs)
    assert all(s is None for s in eng.slot_req)
    assert eng.active_count() == 0
    fresh = GenRequest(rid="after", input_ids=_prompt(rng, 8), max_new_tokens=3,
                       temperature=0.0)
    eng.generate_blocking([fresh])
    assert fresh.stop_reason == "length" and len(fresh.output_tokens) == 3


def _match_window_caps_scan(model, clock):
    """The lcp scan covers the first match_window requests of the drained
    window, not all of it: a resubmit beyond the cap admits fresh (no
    reuse), one within it reuses its retained prefix."""
    rng = np.random.default_rng(10)
    for window, want_reuse in ((2, False), (3, True)):
        eng = _engine(model, n_slots=4, match_window=window, admission_window=16)
        p = _prompt(rng, 16)
        r0 = GenRequest(rid="seed", input_ids=p, max_new_tokens=2, temperature=0.0)
        eng.generate_blocking([r0])
        assert eng.retained_len.max() > 0
        others = [GenRequest(rid=f"o{i}", input_ids=_prompt(rng, 8), max_new_tokens=2,
                             temperature=0.0) for i in range(2)]
        resume = GenRequest(rid="seed", input_ids=p + r0.output_tokens, max_new_tokens=2,
                            temperature=0.0)
        eng.generate_blocking(others + [resume])
        assert all(r.stop_reason == "length" for r in others + [resume])
        assert (eng.stats["reused_tokens"] > 0) == want_reuse, window


def _fresh_waits_out_reservation(model, clock):
    """A reservation parks fresh prompts until its TTL lapses; then they
    take the slot, and the lapse is counted once."""
    rng = np.random.default_rng(14)
    eng = _engine(model, n_slots=1, abort_reserve_s=0.2)
    r1 = GenRequest(rid="gone", input_ids=_prompt(rng, 24), max_new_tokens=16,
                    temperature=0.0)
    eng.submit(r1)
    eng.step(chunk=2)
    eng.abort_all("abort")
    f = GenRequest(rid="fresh", input_ids=_prompt(rng, 8), max_new_tokens=4, temperature=0.0)
    eng.submit(f)
    for _ in range(3):
        eng.step()
    assert not f.stop_reason and eng.slot_req[0] is None  # reserved for "gone"
    assert eng.stats["reservations_lapsed"] == 0
    clock(0.25)
    while not f.stop_reason:
        eng.step()
    assert len(f.output_tokens) == 4
    assert eng.stats["reservations_lapsed"] == 1
    assert eng.stats["prefill_tokens"] == len(r1.input_ids) + len(f.input_ids)


def _group_hold_ttl(model, clock):
    """A declared group missing members is held for group_hold_s at most;
    then the partial group admits, and its members still share their
    prefix with each other."""
    rng = np.random.default_rng(8)
    eng = _engine(model, group_hold_s=0.15)
    prompt = _prompt(rng, 16)
    partial = _group(prompt, 4, "P", max_new=3)[:2]  # 2 of a declared 4
    for r in partial:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert all(r is None for r in eng.slot_req[: eng.n_slots])  # held
    assert eng.active_count() == 2
    clock(0.1)
    eng.step()
    assert all(r is None for r in eng.slot_req[: eng.n_slots])  # still within the TTL
    clock(0.1)
    while any(not r.stop_reason for r in partial):
        eng.step()
    assert eng.stats["shared_tokens"] == len(prompt) - 1
    assert eng.stats["copy_calls"] == 1


def _abort_storm_keeps_prefixes(model, clock):
    """A group aborted mid-decode races back behind fresh prompts: every
    sibling reclaims its own retained prefix (the reservations hold the
    slots), exactly one terminal callback per request object, and the
    resumed greedy streams equal an uninterrupted run."""
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, 24)
    eng = _engine(model, n_slots=4)
    counts: dict = {}
    reqs = _group(prompt, 4, "W", max_new=24, counts=counts)
    eng.submit_batch(reqs)
    eng.step(chunk=4)
    eng.abort_all("abort")
    assert all(r.stop_reason == "abort" and counts[r.rid] == 1 for r in reqs)
    fresh = [GenRequest(rid=f"f{i}", input_ids=_prompt(rng, 24), max_new_tokens=4,
                        temperature=0.0) for i in range(4)]
    resubs = [GenRequest(rid=r.rid, input_ids=r.input_ids + r.output_tokens,
                         max_new_tokens=24 - len(r.output_tokens), temperature=0.0,
                         group_id="W", group_n=4) for r in reqs]
    reused0 = eng.stats["reused_tokens"]
    eng.generate_blocking(fresh + resubs)
    assert eng.stats["reused_tokens"] - reused0 >= sum(len(r.input_ids) - 1 for r in resubs)
    assert eng.stats["reservations_lapsed"] == 0
    assert all(counts[r.rid] == 1 for r in reqs)
    solo = GenRequest(rid="solo", input_ids=list(prompt), max_new_tokens=24, temperature=0.0)
    _engine(model, kv_reuse=False, share_prefix=False).generate_blocking([solo])
    for r, rr in zip(reqs, resubs):
        assert r.output_tokens + rr.output_tokens == solo.output_tokens


CASES = {
    "sampled_siblings_stay_independent": _sampled_siblings_stay_independent,
    "clustered_admission_admits_no_fewer": _clustered_admits_no_fewer,
    "reservation_threshold_strictly_greater": _reservation_strictly_greater,
    "abort_mid_admission_never_resurrects": _abort_mid_pass,
    "match_window_caps_the_lcp_scan": _match_window_caps_scan,
    "fresh_prompts_wait_out_a_reservation": _fresh_waits_out_reservation,
    "group_hold_ttl_admits_a_partial_group": _group_hold_ttl,
    "abort_storm_keeps_each_prefix": _abort_storm_keeps_prefixes,
}


@pytest.mark.parametrize("case", list(CASES))
def test_behaviour(model, clock, case):
    CASES[case](model, clock)


def test_abort_from_another_thread_during_decode(model):
    """abort_all from a control thread while the worker steps: every
    request finishes once, retained prefixes stay consistent with the
    radix index, and a resubmit then reuses its prefix."""
    rng = np.random.default_rng(12)
    eng = _engine(model)
    reqs = [GenRequest(rid=f"r{i}", input_ids=_prompt(rng, 20), max_new_tokens=64,
                       temperature=0.0) for i in range(4)]
    eng.submit_batch(reqs)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            eng.step(chunk=2)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the two threads finely
    t = threading.Thread(target=worker, daemon=True)
    try:
        t.start()
        deadline = _time.monotonic() + 60
        while not all(len(r.output_tokens) >= 3 for r in reqs):
            assert _time.monotonic() < deadline and t.is_alive()
            _time.sleep(0.001)
        eng.abort_all("abort")
        stop.set()
        t.join(30)
    finally:
        stop.set()
        sys.setswitchinterval(old_interval)
    assert not t.is_alive()
    assert all(r.stop_reason == "abort" for r in reqs)
    for s in range(eng.n_slots):
        toks = eng.pool.device_tokens(s)
        n = int(eng.retained_len[s])
        if toks is not None:
            assert len(toks) == n and list(toks) == list(eng.seq_tokens[s, :n])
    r = reqs[0]
    resumed = GenRequest(rid=r.rid, input_ids=r.input_ids + r.output_tokens,
                         max_new_tokens=4, temperature=0.0)
    eng.generate_blocking([resumed])
    assert resumed.cache_hit_tokens == len(resumed.input_ids) - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: decode attention there is the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.gpu
def test_share_on_against_off_on_the_card(cuda_device):
    """On the card, f32: two groups and a single with sharing on and off.
    Greedy streams equal, every admitted prompt token accounted once (cold +
    suffix + reused + shared), shared tokens only with sharing on, and the
    ragged kernel launched once per layer per decode step."""
    from areal_tpu_torch.ops.ragged_decode import ragged_paged_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config(**KW)
    gpu_model = init_params(cfg, 5, cuda_device)
    rng = np.random.default_rng(2)
    prompts = [_prompt(rng, 40), _prompt(rng, 25), _prompt(rng, 9)]
    outs = {}
    for share in (True, False):
        eng = GenEngine(cfg, params=gpu_model, device=cuda_device,
                        **dict(ENGINE, share_prefix=share))
        reqs = (_group(prompts[0], 4, "A", max_new=12) + _group(prompts[1], 3, "B", max_new=9)
                + [GenRequest(rid="s", input_ids=prompts[2], max_new_tokens=7,
                              temperature=0.0)])
        ragged_paged_attention.launches = 0
        eng.generate_blocking(reqs)
        assert _accounted(eng) == sum(len(r.input_ids) for r in reqs)
        assert (eng.stats["shared_tokens"] > 0) == share
        assert ragged_paged_attention.launches == cfg.num_layers * eng.stats["decode_steps"] > 0
        outs[share] = [r.output_tokens for r in reqs]
    assert outs[True] == outs[False]
