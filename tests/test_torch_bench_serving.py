"""The port's serving bench (`areal_tpu_torch/scripts/bench_serving.py`)
against the reference's `scripts/bench_serving.py`, and the port's
weight-sync bench, on the CPU.

Both benches run the tiny Qwen2-style model of `serving_model_setup("tiny")`
in f32 on the same weights (the JAX tree through the port's converter):

- `bench_multi_turn`, `bench_group_fanout`, `bench_prefill` and
  `bench_spec_decode_ab` give the same token accounting as the JAX
  functions: prompt, suffix, reused and shared tokens, fan-out copies,
  host swaps and evictions, decode calls and verify calls, drafted and
  accepted tokens on the repetition params, compared exactly;
- the greedy streams of the repetition params (the spec A/B's prompts)
  are equal, and spec on equals spec off in both packages;
- each result's `k2_calls` (layers x (decode steps + verify calls) over
  its engines' lives, what the kernel's counter reads on the card) equals
  the ragged-decode calls the model made, counted here on the plain path;
- seeded on the greedy map's cycles (`greedy_map`, which equals the
  engine's own greedy step), the spec A/B's on arm drafts and verifies,
  with equal streams;
- `--ab-ragged` refuses with its reason;
- `bench_weight_sync` reports two readings of each publish path, in the
  order transfer, disk, disk, transfer, and the server ends at the last
  publish's version.

The JAX engines share their jitted programs (functions of the model config
and the slot grid alone), as `tests/test_torch_prefix_reuse.py` does.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.scripts import bench_serving as bs
from areal_tpu_torch.scripts import bench_weight_sync
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = ("_prefill_fn", "_suffix_prefill_fn", "_decode_fn", "_verify_fn",
            "_host_gather_fn", "_host_scatter_fn")
SLOTS, MAX_LEN = 4, 256


@pytest.fixture(scope="module")
def both(monkeypatch_module):
    """(the reference bench module with shared programs, JAX cfg and params,
    port cfg and params) on the same weights."""
    import jax

    spec = importlib.util.spec_from_file_location(
        "jax_bench_serving", os.path.join(REPO, "scripts", "bench_serving.py"))
    jbs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbs)
    cache = {}
    build = jbs._engine

    def shared(cfg, params, n_slots, max_seq_len, kv_reuse=True, decode_chunk=8, **kw):
        eng = build(cfg, params, n_slots, max_seq_len, kv_reuse, decode_chunk, **kw)
        key = (n_slots, max_seq_len, decode_chunk)
        for name, fn in cache.setdefault(key, {n: getattr(eng, n) for n in PROGRAMS}).items():
            setattr(eng, name, fn)
        return eng

    monkeypatch_module.setattr(jbs, "_engine", shared)
    jcfg, jparams = jbs.serving_model_setup("tiny")
    cfg, _ = bs.serving_model_setup("tiny", "cpu")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jbs, jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture
def k2_calls(monkeypatch):
    """Counts the model's ragged-decode calls (on the CPU they run the
    kernel's plain version, which no launch counter sees)."""
    from areal_tpu_torch.models import transformer

    calls = [0]
    inner = transformer.ragged_paged_attention

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(transformer, "ragged_paged_attention", counted)
    return calls


def _counts(d, drop=("wall_s", "tokens_per_sec", "speedup", "ms", "k2_calls")):
    """A bench result without its clocks (and the port's kernel count)."""
    if isinstance(d, dict):
        return {k: _counts(v, drop) for k, v in d.items() if k not in drop}
    return d


def test_multi_turn_accounting_matches_jax(both, k2_calls):
    jbs, jcfg, jp, cfg, tp = both
    kw = dict(n_convs=SLOTS, turns=3, turn_prompt=24, turn_gen=8, max_seq_len=MAX_LEN)
    got = bs.bench_multi_turn(cfg, tp, **kw)
    assert got["k2_calls"] == k2_calls[0] > 0
    want = jbs.bench_multi_turn(jcfg, jp, **kw)
    assert _counts(got) == _counts(want)
    # the reuse engine prefills the first turn cold and each later turn's
    # suffix; every earlier token of the transcript is reused
    assert got["reuse"]["prefill_tokens"] == SLOTS * 24
    assert got["reuse"]["reused_tokens"] > 0 and got["cold"]["reused_tokens"] == 0
    assert (got["reuse"]["prefill_tokens"] + got["reuse"]["suffix_tokens"]
            + got["reuse"]["reused_tokens"] == got["cold"]["prefill_tokens"])


def test_group_fanout_accounting_matches_jax(both):
    jbs, jcfg, jp, cfg, tp = both
    kw = dict(group_size=SLOTS, n_groups=2, prompt_len=40, gen_tokens=8, max_seq_len=MAX_LEN)
    got, want = bs.bench_group_fanout(cfg, tp, **kw), jbs.bench_group_fanout(jcfg, jp, **kw)
    want_counts = _counts(want)
    for mode in ("share", "noshare", "share_host"):
        want_counts[mode].setdefault("reused_tokens", 0)  # the port reports it too
    assert _counts(got) == want_counts
    assert got["streams_bit_identical"] and want["streams_bit_identical"]
    # each group's prompt prefills once; its siblings inherit all but the
    # last token
    assert got["share"]["shared_tokens"] == 2 * (SLOTS - 1) * (40 - 1)
    assert got["noshare"]["prefill_tokens"] == 2 * SLOTS * 40
    assert got["share_host"]["prefix_cache_host_swaps"] > 0


def test_prefill_accounting_matches_jax(both):
    jbs, jcfg, jp, cfg, tp = both
    kw = dict(buckets=(32, 64, 128), rows=2, max_seq_len=MAX_LEN)
    got, want = bs.bench_prefill(cfg, tp, **kw), jbs.bench_prefill(jcfg, jp, **kw)
    assert set(got) - {"prefill_tokens", "k2_calls"} == set(want) == {
        "bucket_32", "bucket_64", "bucket_128"}
    assert all(got[k]["tokens_per_sec"] > 0 for k in want)
    # warm and timed admissions of `rows` prompts of bucket - 1 tokens
    assert got["prefill_tokens"] == sum(2 * 2 * (b - 1) for b in (32, 64, 128))


def test_spec_decode_ab_matches_jax(both, k2_calls):
    jbs, jcfg, jp, cfg, tp = both
    kw = dict(n_slots=SLOTS, prompt_len=24, gen_tokens=24, max_seq_len=MAX_LEN, draft_len=7)
    got = bs.bench_spec_decode_ab(cfg, tp, **kw)
    # the seed rollout, then off and on, each warmed with the timed workload
    assert got["k2_calls"] == k2_calls[0] > 0
    want = jbs.bench_spec_decode_ab(jcfg, jp, **kw)
    for mode in ("off", "on"):
        w = _counts(want[mode])
        g = _counts(got[mode])
        assert g.pop("decode_steps") == 8 * g["decode_calls"]
        assert g == w, mode
    assert got["on"]["spec_draft_tokens"] > 0 and got["on"]["verify_calls"] > 0
    assert got["streams_bit_identical"] and want["streams_bit_identical"]
    # the tiny vocabulary's greedy cycles are short: some prompts repeat
    assert len(got["prompt_distinct_tokens"]) == SLOTS and min(got["prompt_distinct_tokens"]) < 24


def test_map_cycles_finds_every_cycle():
    # 0 -> 1 -> 2 -> 0, 3 fixed, 4 -> 3, 5 <-> 6, 7 -> 5
    assert bs.map_cycles([1, 2, 0, 3, 3, 6, 5, 5]) == [[3], [5, 6], [0, 1, 2]]
    assert bs.map_cycles(np.array([0])) == [[0]]


def test_spec_ab_seeded_on_cycles_drafts(both, k2_calls):
    _, _, _, cfg, tp = both
    rep = bs._repetition_params(cfg, tp)
    nxt = bs.greedy_map(cfg, rep, chunk=100)
    assert nxt.shape == (cfg.vocab_size,)
    # the map is the engine's own greedy decode on the repetition params
    eng = bs._engine(cfg, rep, SLOTS, MAX_LEN, kv_reuse=False)
    starts = [0, 97, 300, cfg.vocab_size - 1]
    reqs = [bs.GenRequest(rid=f"s{i}", input_ids=[t], max_new_tokens=12, temperature=0.0)
            for i, t in enumerate(starts)]
    eng.generate_blocking(reqs)
    for t, r in zip(starts, reqs):
        walk = [t] + list(r.output_tokens)
        assert [int(nxt[a]) for a in walk[:-1]] == walk[1:]
    del eng
    cycles = bs.map_cycles(nxt)
    assert all(int(nxt[c[-1]]) == c[0] and all(int(nxt[a]) == b for a, b in zip(c, c[1:]))
               for c in cycles)
    calls0 = k2_calls[0]
    got = bs.bench_spec_decode_ab(cfg, tp, n_slots=SLOTS, prompt_len=24, gen_tokens=24,
                                  max_seq_len=MAX_LEN, draft_len=7, seed_on_cycles=True)
    assert got["k2_calls"] == k2_calls[0] - calls0 > 0
    assert got["cycle_lengths"] == [len(c) for c in cycles[:SLOTS]]
    assert max(got["prompt_distinct_tokens"]) <= 12  # every prompt repeats its cycle
    assert got["on"]["spec_draft_tokens"] > 0 and got["on"]["verify_calls"] > 0
    assert got["on"]["spec_accepted_tokens"] > 0
    assert got["off"]["verify_calls"] == 0 and got["streams_bit_identical"]


def test_repetition_greedy_streams_match_jax(both):
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    jbs, jcfg, jp, cfg, tp = both
    rep_j, rep_t = jbs._repetition_params(jcfg, jp), bs._repetition_params(cfg, tp)
    # the port's copy: the caller's weights stay as they were
    assert not all(float(p.abs().sum()) == 0 for n, p in tp.named_parameters()
                   if n.endswith("o_proj.weight"))
    assert all(float(p.abs().sum()) == 0 for n, p in rep_t.named_parameters()
               if n.endswith("o_proj.weight"))
    seeds = np.random.default_rng(9).integers(0, cfg.vocab_size, SLOTS).tolist()
    streams = []
    for engine, request, params, c in ((jbs._engine, JaxRequest, rep_j, jcfg),
                                       (bs._engine, bs.GenRequest, rep_t, cfg)):
        eng = engine(c, params, SLOTS, MAX_LEN, kv_reuse=False)
        reqs = [request(rid=f"s{i}", input_ids=[int(s)], max_new_tokens=40, temperature=0.0)
                for i, s in enumerate(seeds)]
        eng.generate_blocking(reqs)
        streams.append([r.output_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 40 for s in streams[1])


def test_ab_ragged_refuses(capsys):
    with pytest.raises(SystemExit) as e:
        bs.main(["--ab-ragged", "--device", "cpu", "--model", "tiny"])
    assert e.value.code == 2
    assert "no dense decode path" in capsys.readouterr().err


def test_main_prints_one_json_line(capsys, k2_calls):
    bs.main(["--device", "cpu", "--model", "tiny", "--slots", "2", "--skip-prefill",
             "--skip-multi-turn", "--skip-group", "--ab-slots", "2", "--ab-ceilings",
             "256,512", "--ab-gen", "24", "--ab-spec", "--spec-slots", "2", "--spec-gen",
             "24", "--spec-seed-on-cycles"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device_kind"] == "cpu" and out["decode"]["2"]["tokens_per_sec"] > 0
    ab = out["decode_ceiling_ab"]
    assert set(ab["by_ceiling"]) == {"256", "512"} and ab["large_over_small_tok_s"] > 0
    # the ragged kernel reads occupied pages: the larger ceiling reads a
    # smaller share of its width
    assert (ab["by_ceiling"]["512"]["decode_attended_fraction"]
            < ab["by_ceiling"]["256"]["decode_attended_fraction"])
    spec = out["spec_ab"]
    assert spec["on"]["verify_calls"] > 0 and spec["streams_bit_identical"]
    assert (out["decode"]["2"]["k2_calls"] + ab["k2_calls"] + spec["k2_calls"]
            == k2_calls[0] > 0)


def test_weight_sync_reports_both_paths(tmp_path):
    out = bench_weight_sync.run(model="tiny", device="cpu", work_dir=str(tmp_path))
    assert out["order"] == ["transfer", "disk", "disk", "transfer"]
    assert len(out["transfer_path_seconds"]) == len(out["disk_path_seconds"]) == 2
    assert min(out["transfer_path_seconds"]) > 0 and min(out["disk_path_seconds"]) > 0
    for disk, save, load in zip(out["disk_path_seconds"], out["disk_save_seconds"],
                                out["disk_load_seconds"]):
        assert save + load == pytest.approx(disk, abs=2e-3)
    assert out["disk_bytes_written"] >= 2 * out["model_bytes_bf16"] > 0
    assert not os.listdir(tmp_path)  # each snapshot is removed after its reload
    # every publish committed: the transfers v1 and v4, the disk reloads v2 and v3
    assert out["server_version"] == 4
