"""Crash and preemption recovery of the port's example, end to end on the
CPU: `python -m areal_tpu_torch.examples.math.gsm8k_grpo --launch` as a
user runs it, through `LocalLauncher.run`, against one real port server
(a process of its own, started once for the file, tiny f32 model) that
outlives every trainer, as a rollout fleet does.  The trainers are real
subprocesses, killed by real signals from their fault points
(`AREAL_FAULT_POINTS`, which the launcher hands to the first launch
only).  Nothing waits on a wall-clock sleep: the launcher relaunches at
once, every trainer has a timeout of its own, and the checks read the
files the processes leave (the StatsLogger's lines, the launcher's
events, the server's arrival log).

- SIGKILL at the end of step 1 (transfer publish, KL to the ref, eval):
  the steps, run ids and versions continue ([0, 1, 2], [0, 0, 1],
  [1, 2, 3]), the ledger balances on every step, the lost count equals
  the settled one, and the first thing run 1 asks of the server is the
  reload pinned to version 2 (an aborting commit), before any generate.
- SIGKILL in the middle of the step-1 dump (disk publish): run 1 resumes
  from the step-0 generation and replays step 1; its first request is
  the disk reload pinned to version 1.
- SIGTERM at the end of step 1: the preemption dump, exit 75, and a
  relaunch although `recover.retries` is 0.
"""

import json
import os
import re

import pytest

from areal_tpu_torch.api.config import GenServerConfig
from areal_tpu_torch.examples.math import gsm8k_grpo
from areal_tpu_torch.launcher.local import LocalLauncher
from areal_tpu_torch.utils.http import request_with_retry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARRIVAL = re.compile(r"arrival (\S+) at (\S+) (.*)$")  # the server's arrival log line
TRAINER_TIMEOUT = 120  # seconds, per trainer process
COMMON = ["--device", "cpu", "--model", "tiny", "--launch", "--relaunch-delay", "0",
          "--trainer-timeout", str(TRAINER_TIMEOUT), "total_train_steps=3",
          "gconfig.max_new_tokens=8", "gconfig.n_samples=2", "actor.group_size=2",
          "train_dataset.batch_size=4", "rollout.consumer_batch_size=4",
          "rollout.request_timeout=60", "recover.mode=fault"]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """One port server on the seeded tiny model the trainers start from."""
    root = tmp_path_factory.mktemp("recover_e2e")
    config, args = gsm8k_grpo.parse_args(["--device", "cpu", "--model", "tiny",
                                          f"cluster.fileroot={root}"])
    v0 = gsm8k_grpo.write_init_snapshot(config, "tiny", "cpu")
    launcher = LocalLauncher(str(root / "server_logs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=v0, dtype="float32", max_seqs=8, max_context_len=1024), device="cpu",
            timeout=120)[0]
    try:
        yield dict(addr=addr, v0=v0, log=root / "server_logs" / "gen_server_0.log")
    finally:
        launcher.stop_all()


def _launch(server, tmp_path, monkeypatch, faults, extra):
    """Reset the server to v0, run the example through the launcher;
    returns (rc, stats lines, launcher events, server arrivals)."""
    request_with_retry(server["addr"], "/update_weights_from_disk",
                       {"path": server["v0"], "version": 0})
    monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", server["addr"])
    monkeypatch.setenv("AREAL_FAULT_POINTS", faults)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("AREAL_RUN_ID", raising=False)
    rc = gsm8k_grpo.main(COMMON + [f"cluster.fileroot={tmp_path}"] + extra)

    def lines(path):
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    run_dir = tmp_path / "gsm8k-grpo" / "trial0"
    stats = lines(tmp_path / "logs" / "gsm8k-grpo" / "trial0" / "stats.jsonl")
    events = lines(run_dir / "logs" / "launcher.jsonl")
    with open(server["log"]) as f:
        arrivals = [(float(m[2]), m[1], json.loads(m[3])) for m in map(ARRIVAL.search, f) if m]
    return rc, stats, events, arrivals


def _first_requests_of(events, arrivals, run_id, n):
    start = next(e["ts"] for e in events if e["event"] == "trainer_start"
                 and e["run_id"] == run_id)
    return [(path, detail) for ts, path, detail in arrivals if ts > start][:n]


def _ledger_ok(rec):
    return rec["ledger/submitted"] == (rec["ledger/accepted"] + rec["ledger/rejected"]
                                       + rec["ledger/running"])


def test_sigkill_after_step_then_relaunch_resumes(server, tmp_path, monkeypatch):
    rc, stats, events, arrivals = _launch(
        server, tmp_path, monkeypatch, "train_step@2:kill",
        ["--weight-update-mode", "transfer", "recover.retries=1", "checkpointer.freq_steps=1",
         "recover.keep_generations=1", "actor.kl_ctl=0.01", "ref.dtype=float32",
         "valid_dataset.type=gsm8k-synth", "valid_dataset.batch_size=4",
         "evaluator.freq_secs=0"])
    assert rc == 0
    assert [(e["run_id"], e["rc"]) for e in events if e["event"] == "trainer_exit"] == \
        [(0, -9), (1, 0)]
    assert [s["global_step"] for s in stats] == [0, 1, 2]
    assert [s["run_id"] for s in stats] == [0, 0, 1]
    assert [s["version"] for s in stats] == [1, 2, 3]
    assert all(_ledger_ok(s) for s in stats)
    assert stats[2]["lost_trajectories"] == stats[2]["recover/settled_inflight"]
    assert stats[2]["recover/recovered_step"] == 1
    assert all(s["kl_ref"] != 0 and "eval_reward_mean" in s for s in stats)
    # run 1's first requests: the transfer replay at the recovered version,
    # committed with an abort, before any generate
    first = _first_requests_of(events, arrivals, 1, 3)
    assert first[0] == ("/update_weights_chunk",
                        {"action": "prepare", "version": 2})
    assert first[1] == ("/update_weights_chunk",
                        {"action": "commit", "version": 2, "live": False})
    assert first[2][0] == "/generate"
    assert request_with_retry(server["addr"], "/metrics", method="GET")["version"] == 3
    gens = os.listdir(tmp_path / "gsm8k-grpo" / "trial0" / "recover")
    assert sorted(g for g in gens if g.startswith("gen-")) == ["gen-00000002"]


def test_sigkill_mid_dump_resumes_from_previous_generation(server, tmp_path, monkeypatch):
    rc, stats, events, arrivals = _launch(
        server, tmp_path, monkeypatch, "recover_mid_dump@2:kill",
        ["--weight-update-mode", "disk", "async_training=false", "recover.retries=1",
         "checkpointer.freq_secs=0"])
    assert rc == 0
    assert [(e["run_id"], e["rc"]) for e in events if e["event"] == "trainer_exit"] == \
        [(0, -9), (1, 0)]
    # step 1 never finished its dump, so it is replayed from gen-00000000
    assert [s["global_step"] for s in stats] == [0, 1, 2]
    assert [s["run_id"] for s in stats] == [0, 1, 1]
    assert [s["version"] for s in stats] == [1, 2, 3]
    assert stats[1]["recover/recovered_step"] == 0
    assert all(_ledger_ok(s) for s in stats)
    first = _first_requests_of(events, arrivals, 1, 2)
    assert first[0] == ("/update_weights_from_disk", {"version": 1})
    assert first[1][0] == "/generate"
    root = tmp_path / "gsm8k-grpo" / "trial0" / "recover"
    assert not [d for d in os.listdir(root) if d.startswith(".tmp-")]  # swept


def test_sigterm_dumps_exits_75_and_relaunches_without_a_retry(server, tmp_path, monkeypatch):
    rc, stats, events, arrivals = _launch(
        server, tmp_path, monkeypatch, "train_step@2:term",
        ["--weight-update-mode", "transfer", "recover.retries=0"])
    assert rc == 0
    assert [(e["run_id"], e["rc"]) for e in events if e["event"] == "trainer_exit"] == \
        [(0, 75), (1, 0)]
    assert [s["global_step"] for s in stats] == [0, 1, 2]
    assert [s["run_id"] for s in stats] == [0, 0, 1]
    assert [s["version"] for s in stats] == [1, 2, 3]
    assert stats[2]["recover/recovered_step"] == 1
    with open(tmp_path / "gsm8k-grpo" / "trial0" / "recover" / "gen-00000001" /
              "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["run_id"] == 0  # the preemption dump, not a periodic one
    first = _first_requests_of(events, arrivals, 1, 2)
    assert first[0][1]["version"] == 2 and first[1][1]["action"] == "commit"


# a trainer stand-in: records the fault points it was given, then exits
# with the codes of AREAL_TEST_RCS in launch order, or sleeps past the
# launcher's timeout on "hang"
_STAND_IN = """
import json, os, sys, time
path = os.environ["AREAL_TEST_SEEN"]
seen = json.load(open(path)) if os.path.exists(path) else []
seen.append(os.environ.get("AREAL_FAULT_POINTS"))
json.dump(seen, open(path, "w"))
rc = os.environ["AREAL_TEST_RCS"].split(",")[len(seen) - 1]
if rc == "hang":
    time.sleep(60)
sys.exit(int(rc))
"""


@pytest.mark.parametrize("mode,retries,rcs,want_rc,want_runs", [
    ("fault", 1, "3,0", 0, 2),          # one crash, relaunched
    ("fault", 1, "3,3,0", 3, 2),        # the second crash uses up the retry
    ("auto", 0, "75,75,0", 0, 3),       # preemptions use no retry
    ("disabled", 3, "3,0", 3, 1),       # no recovery, no relaunch
    ("fault", 1, "hang,0", 0, 2),       # a trainer past its timeout is killed
])
def test_launcher_relaunch_policy(tmp_path, monkeypatch, mode, retries, rcs, want_rc,
                                  want_runs):
    import sys

    from areal_tpu_torch.api.config import RecoverConfig

    monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", "127.0.0.1:9")  # never contacted
    monkeypatch.setenv("AREAL_TEST_SEEN", str(tmp_path / "seen.json"))
    monkeypatch.setenv("AREAL_TEST_RCS", rcs)
    monkeypatch.setenv("AREAL_FAULT_POINTS", "train_step@1:kill")
    monkeypatch.delenv("AREAL_RUN_ID", raising=False)
    launcher = LocalLauncher(str(tmp_path / "logs"))
    rc = launcher.run([sys.executable, "-c", _STAND_IN],
                      RecoverConfig(mode=mode, retries=retries), relaunch_delay=0,
                      trainer_timeout=5)
    assert rc == want_rc
    with open(tmp_path / "logs" / "launcher.jsonl") as f:
        events = [json.loads(ln) for ln in f]
    starts = [e["run_id"] for e in events if e["event"] == "trainer_start"]
    assert starts == list(range(want_runs))
    if rcs.startswith("hang"):
        assert [e["rc"] for e in events if e["event"] == "trainer_exit"][0] == -9
    with open(tmp_path / "seen.json") as f:  # the fault points reach run 0 only
        assert json.load(f) == ["train_step@1:kill"] + [None] * (want_runs - 1)
