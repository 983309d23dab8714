"""The port's replay rig (`areal_tpu_torch/scripts/bench_replay.py`) on the
CPU: one port server behind the port's router, the seeded mixed workload
at rates 1 and 4; then the disaggregated A/B on three servers.

- every arrival is answered, with no error, at each rate, and the load client
  reports its own send lag;
- the run's telemetry makes a complete SLO report (no dropped events, no
  orphan spans, the accounting identity holding, nothing lost) in the
  port's format, and the root `scripts/check_slo.py`, which reads only
  JSON, gates it: exit 0 or 1 (a band verdict), never 2 (unusable input);
- the fleet's decode work is reported, and its prefix-cache hits are
  those of the workload's groups;
- `--disagg` serves the same pinned streams in both phases, with handoffs
  and nothing lost, and the disaggregated phase's report is complete.
"""

import json
import os
import subprocess
import sys

import pytest

from areal_tpu_torch.obs import workload
from areal_tpu_torch.scripts import bench_replay
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = ["--model", "tiny", "--device", "cpu", "--workload", "mixed", "--seed", "1",
            "--duration", "4", "--base-rps", "4", "--n-slots", "8", "--max-seq-len", "256",
            "--max-new-tokens", "16"]


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    rc = bench_replay.main(WORKLOAD + [
        "--servers", "1", "--router", "--rates", "1,4", "--telemetry-dir", str(d),
        "--slo-report", str(d / "SLO_REPORT.json"), "--out", str(d / "curves.json")])
    assert rc == 0
    return d, json.loads((d / "curves.json").read_text())


def test_every_arrival_answered(replay):
    _, out = replay
    arrivals = workload.synthetic_mixed(seed=1, duration_s=4, base_rps=4, max_prompt_len=128,
                                        max_new_tokens=16)
    assert out["workload"] == workload.summarize(arrivals)
    assert {k for k in out["workload"]["by_kind"]} >= {"chat", "group"}
    assert [r["rate"] for r in out["rates"]] == [1.0, 4.0]
    for r in out["rates"]:
        assert r["n"] == len(arrivals) and r["ok"] == r["n"] and r["errors"] == 0
        assert r["output_tokens"] > 0 and r["latency_s"]["count"] == r["n"]
        assert r["send_lag_s"]["count"] == r["n"] and r["send_lag_s"]["min"] >= 0
    assert out["fleet"]["router"] and out["fleet"]["servers"] == 1
    assert out["fleet_k2"]["decode_steps"] > 0
    # each GRPO group's siblings after the first ride its prompt
    assert out["prefix_cache"]["hits"] > 0


def test_slo_report_complete_and_gated(replay):
    d, out = replay
    report = json.loads((d / "SLO_REPORT.json").read_text())
    assert report["schema"] == "areal-slo-report/v1"
    assert report["complete"] and out["slo_complete"]
    comp = report["completeness"]
    assert comp["dropped_events"] == 0 and comp["orphan_traces"] == [] and not comp["errors"]
    assert report["accounting"]["ok"] and report["accounting"]["violations"] == 0
    n = sum(r["n"] for r in out["rates"])
    traj = report["trajectories"]
    assert traj["lost"] == 0 and traj["closed"] >= n and traj["open"] == 0
    assert report["prefix_cache"] == out["prefix_cache"]
    assert (d / "SLO_REPORT.md").read_text().startswith("# SLO report replay")
    assert out["telemetry"]["dropped_events"] == 0
    gate = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "check_slo.py"), "--report",
         str(d / "SLO_REPORT.json"), "--baseline",
         os.path.join(REPO, "tests", "data", "slo_baseline.json")],
        capture_output=True, text=True, timeout=120)
    assert gate.returncode in (0, 1), gate.stdout + gate.stderr


def test_disagg_ab_streams_equal(tmp_path, capsys):
    rc = bench_replay.main(WORKLOAD + [
        "--servers", "3", "--disagg", "--rates", "2", "--telemetry-dir", str(tmp_path),
        "--out", str(tmp_path / "ab.json")])
    out = json.loads((tmp_path / "ab.json").read_text())
    assert rc == 0, out["gates"]
    bit = out["bit_identity"]
    n = out["workload"]["n"]
    assert bit["compared"] == n and bit["token_mismatches"] == 0
    assert all(out["gates"].values())
    dis = out["phases"]["disagg"]
    assert dis["router"]["handoffs"] > 0
    assert sorted(dis["router"]["roles"].values()) == ["decode", "decode", "prefill"]
    for mode in ("colocated", "disagg"):
        (curve,) = out["phases"][mode]["curve"]
        assert curve["ok"] == n and curve["errors"] == 0
        assert out["phases"][mode]["slo"]["complete"], mode
    assert out["phases"]["disagg"]["slo"]["handoff"]["n"] > 0
    assert "disagg A/B ok" in capsys.readouterr().err
