"""Length-cohort tiers and migration in the port's engine (`gen/engine.py`
`plan_decode_tiers`, admission by cohort, `_plan_migrations`,
`tier_occupancy`, the spec controller per tier).

- Against JAX: the reference's tiered `GenEngine` (its ragged kernel in
  interpret mode) and the port's, on the same converted weights, through a
  workload whose long-budget request starts in the short cohort and
  migrates: greedy streams equal, logprobs within 1e-4 (f32 in another op
  order), the same number of migrations.
- Torch against torch (the behaviours of `tests/test_tiered_decode.py` and
  `tests/test_spec_decode.py::test_spec_migration_parity`): tiered equals
  untiered over several layouts, greedy and sampled; a migration mid
  generation, with and without speculation; a group fanned out into a
  tier; cohort placement; the layout and its validation; the tier labels
  of the telemetry events.  Tokens compare exactly, logprobs within 1e-3
  (a last-bit difference of the CPU's products at another row count
  compounds along a stream; `tests/test_torch_spec_decode.py` says more).
"""

import numpy as np
import pytest

from areal_tpu_torch.gen.engine import GenEngine, GenRequest, plan_decode_tiers
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
ENGINE = dict(n_slots=4, max_seq_len=256, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4, seed=3)
LOGP_ATOL = 1e-3  # torch against torch
JAX_ATOL = 1e-4
MIGRATING = dict(decode_tier_lens=[64, 256], decode_tier_slots=[2, 2], decode_chunk=4)


@pytest.fixture(scope="module")
def params():
    return init_params(tiny_config(**KW), 0, "cpu")


def _engine(params, **kw):
    return GenEngine(params.cfg, params=params, device="cpu", **dict(ENGINE, **kw))


def _run(eng, reqs):
    eng.generate_blocking(reqs)
    return reqs


def _same(got, want, atol=LOGP_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.output_tokens, g.stop_reason) == (w.output_tokens, w.stop_reason), g.rid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=atol, rtol=0)


def _mixed(request, seed, temperature):
    rng = np.random.default_rng(seed)
    return [request(rid=f"r{i}", input_ids=rng.integers(0, 97, n).tolist(), max_new_tokens=m,
                    temperature=temperature, top_p=tp)
            for i, (n, m, tp) in enumerate([(10, 6, 1.0), (24, 30, 0.9), (7, 12, 1.0),
                                            (40, 9, 1.0)])]


def _migrating(request, seed, temperature, prompt=None):
    """Two short-lived long-budget requests take the long tier; the third,
    long-budget too, lands in the short one and outgrows its 64-token
    ceiling once a long slot has freed."""
    rng = np.random.default_rng(seed)
    prompt = prompt or (lambda n: rng.integers(0, 97, n).tolist())
    blockers = [request(rid=f"b{i}", input_ids=prompt(30), max_new_tokens=40,
                        temperature=temperature) for i in range(2)]
    return blockers + [request(rid="mover", input_ids=prompt(40), max_new_tokens=60,
                               temperature=temperature)]


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def test_tiered_engine_matches_the_jax_tiered_engine_through_a_migration():
    import jax

    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest
    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    tree = jax.tree_util.tree_map(np.asarray, jax_init(jax_tiny(**KW), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(20)
    for k in ("bq", "bk", "bv"):
        tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(
            tree["layers"]["attn"][k].shape)).astype(np.float32)
    cfg = tiny_config(**KW)
    jax_eng = JaxEngine(jax_tiny(**KW), params=tree, ragged_attn=True, **ENGINE, **MIGRATING)
    port = GenEngine(cfg, params=params_from_jax(tree, cfg, "cpu"), device="cpu", **ENGINE,
                     **MIGRATING)
    want = _run(jax_eng, _migrating(JaxRequest, 21, 0.0))
    got = _run(port, _migrating(GenRequest, 21, 0.0))
    assert jax_eng.stats["tier_migrations"] >= 1
    assert port.stats["tier_migrations"] == jax_eng.stats["tier_migrations"]
    _same(got, want, atol=JAX_ATOL)
    port.pool.check_page_table()


# ---------------------------------------------------------------------------
# torch against torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_tiered_matches_untiered(params, temperature):
    """One mixed-length workload through 1, 2 and 3 tiers and an uneven
    explicit layout: the same streams (counter-keyed sampling)."""
    layouts = [dict(decode_tiers=1), dict(decode_tiers=2), dict(decode_tiers=3),
               dict(decode_tier_lens=[64, 256], decode_tier_slots=[3, 1])]
    outs = [_run(_engine(params, **kw), _mixed(GenRequest, 11, temperature)) for kw in layouts]
    for got in outs[1:]:
        _same(got, outs[0])


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_mid_generation_migration_parity(params, spec):
    """The mover migrates (a page-table remap) and its sampled stream is the
    untiered engine's; under speculation too, whose verify writes K/V
    beyond the accepted frontier that the migration must not carry."""
    def tiled(rng):
        def prompt(n):
            seg = rng.integers(0, 97, 7).tolist()
            return (seg * (n // 7 + 1))[:n]
        return prompt

    kw = dict(spec_decode=True) if spec else {}
    tiered = _engine(params, **MIGRATING, **kw)
    got = _run(tiered, _migrating(GenRequest, 21, 1.0, tiled(np.random.default_rng(21))))
    assert tiered.stats["tier_migrations"] >= 1, tiered.stats
    if spec:
        assert tiered.stats["spec_drafted"] > 0
    untiered = _engine(params, decode_chunk=4)
    want = _run(untiered, _migrating(GenRequest, 21, 1.0, tiled(np.random.default_rng(21))))
    _same(got, want)
    tiered.pool.check_page_table()
    # the mover ended in the long tier; its old row re-homed a retained prefix
    assert any(tiered.pool.device_tokens(s) is not None for s in range(tiered.n_slots))


def test_group_fanout_sibling_lands_in_a_tier(params):
    """A declared group fanned out across the tiers: one prefill, one copy,
    every sibling the solo greedy stream."""
    prompt = np.random.default_rng(4).integers(0, 97, 24).tolist()
    solo = _run(_engine(params), [GenRequest(rid="solo", input_ids=list(prompt),
                                             max_new_tokens=6, temperature=0.0)])[0]
    eng = _engine(params, decode_tiers=2)
    reqs = [GenRequest(rid=f"G-{i}", input_ids=list(prompt), max_new_tokens=6,
                       temperature=0.0, group_id="G", group_n=4) for i in range(4)]
    _run(eng, reqs)
    _same(reqs, [solo] * 4)
    assert eng.stats["prefill_calls"] == 1 and eng.stats["copy_calls"] == 1
    assert eng.stats["shared_tokens"] == 3 * (len(prompt) - 1)


def test_admission_places_by_length_cohort(params):
    """Short budgets land in the short cohort (the first block), long ones
    in the long one; occupancy read before any decode."""
    eng = _engine(params, decode_tier_lens=[64, 256], decode_tier_slots=[2, 2])
    short = [GenRequest(rid=f"s{i}", input_ids=list(range(1, 11)), max_new_tokens=8,
                        temperature=1.0) for i in range(2)]
    long_ = [GenRequest(rid=f"l{i}", input_ids=list(range(1, 41)), max_new_tokens=30,
                        temperature=1.0) for i in range(2)]
    for r in long_ + short:  # the long ones first: placement is by budget, not order
        eng.submit(r)
    eng._admit()
    assert eng.tier_occupancy() == [2, 2]
    assert all(eng.slot_req[s].rid.startswith("s") for s in range(2))
    while any(not r.stop_reason for r in short + long_):
        eng.step()
    assert eng.tier_occupancy() == [0, 0]


def test_plan_decode_tiers_layouts():
    assert plan_decode_tiers(64, 16384, 3, 128) == ([4096, 8192, 16384], [32, 16, 16])
    assert plan_decode_tiers(8, 2048, 1, 128) == ([2048], [8])
    assert plan_decode_tiers(16, 2048, 2, 128) == ([1024, 2048], [8, 8])
    with pytest.raises(ValueError):
        plan_decode_tiers(2, 2048, 4, 128)


def test_tier_layout_validation(params):
    with pytest.raises(ValueError, match="sum"):
        _engine(params, decode_tier_lens=[64, 256], decode_tier_slots=[2, 3])
    with pytest.raises(ValueError, match="ascend"):
        _engine(params, decode_tier_lens=[256, 64], decode_tier_slots=[2, 2])
    with pytest.raises(ValueError, match="together"):
        _engine(params, decode_tier_lens=[64, 256])
    eng = _engine(params, decode_tier_lens=[64, 512], decode_tier_slots=[3, 1])
    assert eng.tier_bounds == [64, 256] and eng.tier_start == [0, 3]
    assert eng.slot_tier.tolist() == [0, 0, 0, 1, 1]  # the scratch row in the last tier


def test_events_and_acceptance_rates_carry_each_tier(params):
    """Admission events carry the slot's tier, decode_chunk and spec_verify
    events one per occupied tier with its label; the acceptance rates come
    one a tier."""
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    telemetry.EVENTS.clear()
    try:
        eng = _engine(params, decode_tier_lens=[64, 256], decode_tier_slots=[2, 2],
                      spec_decode=True, spec_draft_len=3)
        reqs = [GenRequest(rid="short", input_ids=[5, 6, 7] * 4, max_new_tokens=8,
                           temperature=0.0),
                GenRequest(rid="long", input_ids=[8, 9] * 20, max_new_tokens=100,
                           temperature=0.0)]
        _run(eng, reqs)
        evs = telemetry.EVENTS.snapshot()
    finally:
        telemetry.set_enabled(was)
        telemetry.EVENTS.clear()
    admitted = {e["trace_id"]: e["tier"] for e in evs if e["event"] == "admission"}
    assert admitted == {"short": 0, "long": 1}
    steps = [e for e in evs if e["event"] in ("decode_chunk", "spec_verify")]
    assert {e["tier"] for e in steps} == {0, 1}
    for e in steps:
        assert e["trace_ids"] == (["short"] if e["tier"] == 0 else ["long"])
    assert any(e["event"] == "spec_verify" and e["draft_len"] == 3 for e in steps)
    rates = eng.spec_acceptance_rates()
    assert len(rates) == 2 and all(0.0 <= r <= 1.0 for r in rates)
