"""The port's trace analytics (`areal_tpu_torch/obs/`) against the JAX
package's `areal_tpu/obs/`, exactly.

- `synthetic_mixed`, `scale`, `summarize`, `prompt_ids` and
  `arrivals_from_trace` give item for item what the JAX module gives, over
  several seeds, durations, rates and vocabularies;
- `analyze` (records, completeness, pauses, chunk latencies, restarts),
  `check_accounting`, `build_report` and `render_markdown` equal the JAX
  results on every event log `tests/test_trace_analytics.py` builds (the
  fixture logs under `tests/data/traces/` and its in-line logs), and on
  the events of a port replay;
- the port's own events, from a tiny CPU replay through the port's
  server and router, parse into a complete report (no dropped events, no
  orphans, the accounting identity holding) under both analyzers.
"""

import copy
import dataclasses
import json
import os

import pytest

from areal_tpu_torch.obs import slo, trace, workload
from areal_tpu_torch.scripts import bench_replay
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TRACES = os.path.join(os.path.dirname(__file__), "data", "traces")
FIXTURES = sorted(f for f in os.listdir(TRACES) if f.endswith(".jsonl"))


def _jax():
    from areal_tpu.obs import slo as jslo
    from areal_tpu.obs import trace as jtrace
    from areal_tpu.obs import workload as jwl

    return jtrace, jwl, jslo


def _inline_logs():
    """The in-line event logs of `tests/test_trace_analytics.py`."""
    mono = [
        {"ts": 5.0, "mono": 10.0, "pid": 7, "event": "rollout_submit", "trace_id": "m1",
         "input_len": 4},
        {"ts": 5.0, "mono": 10.2, "pid": 7, "event": "admission", "trace_id": "m1",
         "kind": "fresh"},
        {"ts": 5.0, "mono": 10.5, "pid": 7, "event": "gen_done", "trace_id": "m1",
         "stop_reason": "stop", "output_len": 4, "latency_s": 0.5},
    ]
    two_pids = copy.deepcopy(mono)
    two_pids[1]["pid"] = 8
    client_only = [
        {"ts": 1.0, "event": "rollout_submit", "trace_id": "c1", "input_len": 4},
        {"ts": 1.4, "event": "gen_done", "trace_id": "c1", "stop_reason": "stop",
         "output_len": 4, "latency_s": 0.4},
    ]
    rejoined = [
        {"ts": 1.0, "event": "rollout_submit", "trace_id": "r1", "input_len": 4},
        {"ts": 1.2, "event": "resubmit", "trace_id": "r1", "from_server": "s0",
         "to_server": "s1", "attempt": 2},
        {"ts": 1.6, "event": "gen_done", "trace_id": "r1", "stop_reason": "stop",
         "output_len": 4, "latency_s": 0.6},
    ]
    open_trace = [{"ts": 1.0, "event": "rollout_submit", "trace_id": "o1", "input_len": 4}]
    interrupted = [
        {"ts": 1.0, "event": "rollout_submit", "trace_id": "i1", "input_len": 4},
        {"ts": 1.2, "event": "interrupt", "trace_id": "i1"},
        {"ts": 1.6, "event": "gen_done", "trace_id": "i1", "stop_reason": "stop",
         "output_len": 4, "latency_s": 0.6},
    ]
    resumed = copy.deepcopy(interrupted)
    resumed.insert(2, {"ts": 1.4, "event": "resume", "trace_id": "i1", "attempt": 1,
                       "generated": 2, "prompt_len": 4})
    cache_hit = [
        {"ts": 1.0, "mono": 1.0, "pid": 7, "event": "rollout_submit", "trace_id": "rch",
         "input_len": 4},
        {"ts": 1.1, "mono": 1.1, "pid": 7, "event": "resubmit", "trace_id": "rch",
         "server": "b"},
        {"ts": 1.15, "mono": 1.15, "pid": 7, "event": "resubmit_cache_hit",
         "trace_id": "rch", "server": "b", "hit_tokens": 3},
        {"ts": 1.5, "mono": 1.5, "pid": 7, "event": "gen_done", "trace_id": "rch",
         "stop_reason": "stop", "output_len": 4, "latency_s": 0.5, "attempts": 2},
    ]
    with open(os.path.join(TRACES, "clean.jsonl")) as f:
        clean = [json.loads(ln) for ln in f if ln.strip()]
    violated = copy.deepcopy(clean)
    next(e for e in violated if e["event"] == "gen_done")["latency_s"] = 2.0
    jitter = copy.deepcopy(clean)
    next(e for e in jitter if e["event"] == "gen_done")["latency_s"] = 0.73
    return {"mono": mono, "two_pids": two_pids, "client_only": client_only,
            "rejoined": rejoined, "open": open_trace, "interrupted": interrupted,
            "resumed": resumed, "cache_hit": cache_hit, "violated": violated,
            "jitter": jitter}


@pytest.fixture(scope="module")
def replay_events(tmp_path_factory):
    """A tiny CPU replay through one port server and the port's router:
    its events file and curve JSON."""
    d = tmp_path_factory.mktemp("replay")
    out = d / "curves.json"
    rc = bench_replay.main([
        "--device", "cpu", "--model", "tiny", "--servers", "1", "--router",
        "--workload", "mixed", "--duration", "4", "--base-rps", "4", "--seed", "3",
        "--rates", "4", "--n-slots", "8", "--max-seq-len", "256", "--max-new-tokens", "16",
        "--telemetry-dir", str(d), "--out", str(out)])
    assert rc == 0
    return str(d / "events.jsonl"), json.loads(out.read_text())


def _sources(replay_events):
    srcs = {name: os.path.join(TRACES, name) for name in FIXTURES}
    srcs.update(_inline_logs())
    srcs["port_replay"] = replay_events[0]
    return srcs


WORKLOADS = [
    dict(seed=0, duration_s=8.0, base_rps=2.0, max_prompt_len=128, max_new_tokens=16,
         rate=1.0, vocab=512),
    dict(seed=1, duration_s=20.0, base_rps=4.0, max_prompt_len=512, max_new_tokens=32,
         rate=4.0, vocab=151936),
    dict(seed=7, duration_s=30.0, base_rps=1.5, max_prompt_len=64, max_new_tokens=64,
         rate=16.0, vocab=97),
    dict(seed=3, duration_s=10.0, base_rps=8.0, max_prompt_len=1024, max_new_tokens=8,
         rate=2.5, vocab=512),
]


@pytest.mark.parametrize("case", WORKLOADS, ids=lambda c: f"seed{c['seed']}-x{c['rate']:g}")
def test_workload_matches_jax(case):
    _, jwl, _ = _jax()
    kw = {k: case[k] for k in ("seed", "duration_s", "base_rps", "max_prompt_len",
                               "max_new_tokens")}
    got, want = workload.synthetic_mixed(**kw), jwl.synthetic_mixed(**kw)
    assert got and [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in want]
    assert {a.kind for a in got} >= {"chat"}
    gs, ws = workload.scale(got, case["rate"]), jwl.scale(want, case["rate"])
    assert [dataclasses.asdict(a) for a in gs] == [dataclasses.asdict(a) for a in ws]
    assert workload.summarize(gs) == jwl.summarize(ws)
    for a, b in zip(gs, ws):
        assert (workload.prompt_ids(a, vocab=case["vocab"], seed=case["seed"])
                == jwl.prompt_ids(b, vocab=case["vocab"], seed=case["seed"]))
    with pytest.raises(ValueError):
        workload.scale(got, 0)


def test_arrivals_from_trace_matches_jax(replay_events):
    _, jwl, _ = _jax()
    for src in [os.path.join(TRACES, n) for n in FIXTURES] + [replay_events[0]]:
        for budget in (16, 64):
            got = workload.arrivals_from_trace(src, default_budget=budget)
            want = jwl.arrivals_from_trace(src, default_budget=budget)
            assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a)
                                                            for a in want], src
    assert len(workload.arrivals_from_trace(replay_events[0])) == replay_events[1]["rates"][0]["n"]


def _without_clock(report):
    return {k: v for k, v in report.items() if k != "generated_unix"}


def test_analyzer_and_report_match_jax(replay_events):
    jtrace, _, jslo = _jax()
    for name, src in _sources(replay_events).items():
        for strict in (False, True):
            got = trace.analyze(src, strict_open=strict)
            want = jtrace.analyze(src, strict_open=strict)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            assert [r.stage_sum() for r in got.records] == [r.stage_sum()
                                                           for r in want.records]
            assert ([dataclasses.asdict(r) for r in got.closed]
                    == [dataclasses.asdict(r) for r in want.closed])
            for tol, floor in ((0.05, 0.025), (0.01, 0.0)):
                assert dataclasses.asdict(trace.check_accounting(
                    got.records, tolerance=tol, abs_floor_s=floor)) == dataclasses.asdict(
                    jtrace.check_accounting(want.records, tolerance=tol, abs_floor_s=floor))
            g = slo.build_report(src, run_id="t", strict_open=strict)
            w = jslo.build_report(src, run_id="t", strict_open=strict)
            assert _without_clock(g) == _without_clock(w), name
            assert slo.render_markdown(g) == jslo.render_markdown(w)
    # the dropped-events override of a live snapshot
    src = os.path.join(TRACES, "clean.jsonl")
    assert (dataclasses.asdict(trace.analyze(src, dropped_events=3))
            == dataclasses.asdict(jtrace.analyze(src, dropped_events=3)))
    assert trace.dist_summary(range(1, 101)) == jtrace.dist_summary(range(1, 101))


def test_port_replay_events_make_a_complete_report(replay_events):
    jtrace, _, jslo = _jax()
    events, curves = replay_events
    (rate,) = curves["rates"]
    assert rate["n"] > 0 and rate["errors"] == 0 and rate["ok"] == rate["n"]
    names = {json.loads(ln)["event"] for ln in open(events) if ln.strip()}
    assert {"rollout_submit", "admission", "prefill", "decode_chunk", "gen_done"} <= names
    for build in (slo.build_report, jslo.build_report):
        report = build(events, run_id="port")
        assert report["complete"], report["completeness"]
        assert report["completeness"]["dropped_events"] == 0
        assert report["completeness"]["orphan_traces"] == []
        assert report["accounting"]["ok"] and report["accounting"]["checked"] > 0
        assert report["trajectories"]["lost"] == 0
        # every driven request closed, next to the server's own spans
        assert report["trajectories"]["closed"] >= rate["n"]
        assert report["stages"]["decode"]["count"] > 0


def test_slo_cli(tmp_path, replay_events):
    out, md = tmp_path / "r.json", tmp_path / "r.md"
    rc = slo.main([replay_events[0], "--out", str(out), "--md", str(md), "--run-id", "x",
                   "--require-complete", "--require-identity"])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["schema"] == slo.SCHEMA and report["run_id"] == "x"
    assert md.read_text().startswith("# SLO report x")
    assert slo.main([os.path.join(TRACES, "dropped.jsonl"), "--require-complete"]) == 1
