"""The workloads and entry points around the engine's prefix reuse and
group fan-out, on the CPU.

- `RLVRWorkflow` declares each GRPO group (`group_id`, `group_n`) as the
  JAX workflow does; `MultiTurnWorkflow`'s trajectories equal the JAX
  workflow's on the same fake engine (exact: both are framework-free).
- The port's server parses a request's group and answers its
  `cache_hit_tokens`; the JAX client's GRPO burst against it shows
  `shared_tokens > 0` on `/metrics`, with every prompt token accounted once.
- The port's bench runs `--len-jitter`, `--dataset gsm8k-synth` and
  `--workflow multi_turn` and reports the latency distributions and the
  prefill accounting of each mode; it refuses flag combinations the JAX
  bench refuses, and `--share-prefix off` with `--transport remote`.
"""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest

from areal_tpu_torch.api import config as tconfig
from areal_tpu_torch.api import io_struct as tio
from areal_tpu_torch.gen import server
from areal_tpu_torch.gen.engine import GenEngine
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.scripts import bench_e2e_grpo as bench
from areal_tpu_torch.workflow.multi_turn import MultiTurnWorkflow
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)


class _ScriptedEngine:
    """Answers every request with tokens that depend on its prompt only,
    and records the requests."""

    def __init__(self, response_cls):
        self.response_cls = response_cls
        self.requests = []

    def get_version(self):
        return 3

    async def agenerate(self, req):
        self.requests.append(req)
        n = len(req.input_ids)
        toks = [(n * 7 + i) % 97 for i in range(4)]
        return self.response_cls(
            input_tokens=list(req.input_ids), output_tokens=toks,
            output_logprobs=[-0.5 * (i + 1) for i in range(len(toks))],
            output_versions=[3] * len(toks), stop_reason="length")


def test_rlvr_workflow_declares_its_groups_like_jax():
    from areal_tpu.api import config as jconfig
    from areal_tpu.api import io_struct as jio
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    item = {"input_ids": list(range(5, 25))}
    for n in (4, 1):
        seen = []
        for wf_cls, cfg, io in ((JaxRLVR, jconfig, jio), (RLVRWorkflow, tconfig, tio)):
            wf = wf_cls(reward_fn=bench._reward_last_even,
                        gconfig=cfg.GenerationHyperparameters(n_samples=n, max_new_tokens=4))
            engine = _ScriptedEngine(io.ModelResponse)
            asyncio.run(wf.arun_episode(engine, item))
            seen.append([(r.rid, r.group_id, r.group_n) for r in engine.requests])
        for reqs in seen:
            if n == 1:
                assert reqs == [(reqs[0][0], "", 0)]
            else:
                gid = reqs[0][1]
                assert gid and [(g, k) for _, g, k in reqs] == [(gid, n)] * n
                assert [rid for rid, _, _ in reqs] == [f"{gid}-{k}" for k in range(n)]


def test_multi_turn_trajectories_match_jax():
    """Episodes that end on the first, the second and the last turn (the
    grader accepts about a third of the completions), with the feedback
    suffix between turns."""
    from areal_tpu.api import config as jconfig
    from areal_tpu.api import io_struct as jio
    from areal_tpu.workflow.multi_turn import MultiTurnWorkflow as JaxMultiTurn

    turns = set()
    for length in range(8, 20):
        item = {"input_ids": list(range(1, length + 1)), "query_id": str(length)}
        runs = []
        for wf_cls, cfg, io in ((JaxMultiTurn, jconfig, jio), (MultiTurnWorkflow, tconfig, tio)):
            wf = wf_cls(reward_fn=bench._reward_mt,
                        gconfig=cfg.GenerationHyperparameters(max_new_tokens=4),
                        tokenizer=bench._FakeTokenizer(), max_turns=3)
            engine = _ScriptedEngine(io.ModelResponse)
            runs.append((asyncio.run(wf.arun_episode(engine, item)), engine))
        (want, jeng), (got, teng) = runs
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        assert [r.input_ids for r in teng.requests] == [r.input_ids for r in jeng.requests]
        # every turn's prompt extends the one before: the engine's reuse case
        for a, b in zip(teng.requests, teng.requests[1:]):
            assert b.input_ids[:len(a.input_ids)] == a.input_ids
        turns.add(len(teng.requests))
    assert turns == {1, 2, 3}


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.fixture
def live():
    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=8, max_seq_len=128,
                       prompt_bucket=16, kv_dtype="float32", reuse_min_tokens=4, device="cpu")
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    yield box["httpd"]
    box["httpd"].shutdown()
    t.join(30)


def test_server_parses_the_group_and_answers_cache_hits(live):
    port = live.port
    prompt = np.random.default_rng(3).integers(0, 97, 21).tolist()
    group = [{"rid": f"g-{k}", "input_ids": prompt, "group_id": "g", "group_n": 3,
              "sampling_params": {"max_new_tokens": 5}} for k in range(3)]
    res = _call(port, "/generate_batch", {"requests": group})["results"]
    assert sorted(r["cache_hit_tokens"] for r in res) == [0, 20, 20]
    m = _call(port, "/metrics")
    assert (m["prefill_tokens"], m["shared_tokens"], m["suffix_tokens"], m["copy_calls"]) == (
        21, 40, 2, 1)
    assert m["reused_tokens"] == m["reservations_lapsed"] == 0
    # the next turn of one transcript rides its retained prefix
    turn = prompt + res[0]["output_tokens"] + [1, 2, 3]
    nxt = _call(port, "/generate", {"rid": "t", "input_ids": turn,
                                    "sampling_params": {"max_new_tokens": 3}})
    assert nxt["cache_hit_tokens"] == len(prompt) + 4  # the pending token is recomputed
    assert _call(port, "/metrics")["reused_tokens"] == len(prompt) + 4


def test_jax_client_group_burst_shares_on_the_port_server(live):
    from areal_tpu.api.config import GenerationHyperparameters as JaxGen
    from areal_tpu.api.config import InferenceEngineConfig
    from areal_tpu.engine.jax_remote import RemoteJaxEngine
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    addr = f"127.0.0.1:{live.port}"
    eng = RemoteJaxEngine(InferenceEngineConfig(consumer_batch_size=2,
                                                max_concurrent_rollouts=8,
                                                request_timeout=60))
    eng.initialize(addr=addr)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, n).tolist() for n in (24, 18)]
    try:
        wf = JaxRLVR(reward_fn=bench._reward_last_even,
                     gconfig=JaxGen(n_samples=4, max_new_tokens=6))
        batch = eng.rollout_batch([{"input_ids": p} for p in prompts], workflow=wf)
    finally:
        eng.destroy()
    assert batch["input_ids"].shape[0] == 8
    m = _call(live.port, "/metrics")
    assert m["shared_tokens"] > 0 and m["copy_calls"] > 0
    accounted = (m["prefill_tokens"] + m["suffix_tokens"] + m["reused_tokens"]
                 + m["shared_tokens"])
    assert accounted == 4 * sum(len(p) for p in prompts)


BENCH = ["--device", "cpu", "--model", "tiny", "--steps", "1", "--warmup", "0",
         "--batch-size", "2", "--group-size", "2", "--n-slots", "8", "--max-seq-len", "256",
         "--prompt-len", "32", "--prompt-len-min", "16", "--max-new-tokens", "16"]
WORKLOADS = {
    "len_jitter": ["--len-jitter", "3"],
    "gsm8k_synth": ["--dataset", "gsm8k-synth"],
    "multi_turn": ["--workflow", "multi_turn", "--max-turns", "3"],
}


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_bench_workload_reports_latency(workload, capsys):
    assert bench.main(BENCH + WORKLOADS[workload]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["share_prefix"] == "on"
    for mode in ("sync", "async"):
        lat = res[mode]["latency"]
        assert lat["n"] > 0
        for key in ("e2e_s", "ttft_s", "inter_token_s"):
            d = lat[key]
            assert d["count"] > 0 and 0 < d["p50"] <= d["p99"] <= d["max"], (mode, key)
        assert set(res[mode]["prefill"]) == set(bench.PREFILL_KEYS)
    if workload == "multi_turn":
        assert res["workflow"] == "multi_turn" and res["kv_reuse"]["reused_tokens"] > 0
    else:
        assert res["shared_prefill"]["shared_tokens"] > 0
    if workload == "len_jitter":
        budgets = [d["max_new_tokens"] for d in bench.make_dataset(
            64, 512, 32, 16, len_jitter=3.0, max_new_tokens=16)]
        assert min(budgets) >= 4 and max(budgets) <= 16 and len(set(budgets)) > 4
        assert res["len_jitter"] == 3.0
    if workload == "gsm8k_synth":
        assert res["dataset"] == "gsm8k-synth"


@pytest.mark.parametrize("flags", [
    ["--transport", "remote", "--share-prefix", "off"],
    ["--workflow", "multi_turn", "--len-jitter", "1"],
    ["--dataset", "gsm8k-synth", "--workflow", "multi_turn"],
])
def test_bench_refuses_conflicting_flags(flags):
    with pytest.raises(SystemExit) as e:
        bench.main(BENCH + flags)
    assert e.value.code == 2
