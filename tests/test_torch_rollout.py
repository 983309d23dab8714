"""The port's rollout layer against the JAX package: the staleness
controller, the workflow executor, the RLVR workflow, the math reward, the
word tokenizer and the synthetic GSM8K generator.

All of these are framework-free copies, so the comparisons are exact:
capacities, ledgers, batches, trajectory dicts, rewards and token ids must
be equal, not close.
"""

import asyncio
import random
from dataclasses import asdict

import numpy as np
import pytest

from areal_tpu_torch.api import config as tconfig
from areal_tpu_torch.api import io_struct as tio
from areal_tpu_torch.core.executor import WorkflowExecutor
from areal_tpu_torch.core.staleness import StalenessManager
from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer, generate_problems
from areal_tpu_torch.reward import gsm8k_reward_fn
from areal_tpu_torch.utils.dataloader import StatefulDataLoader
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (max_concurrent_rollouts, consumer_batch_size, max_staleness, events):
# the sequences of tests/test_staleness.py.  An event is "submit",
# "accept", "reject" or ("cap", version).
STALENESS_CASES = {
    "concurrency_cap": (4, 100, 100, [("cap", 0)] + ["submit"] * 4
                        + [("cap", 0), "accept", ("cap", 0)]),
    "limit_zero": (1000, 4, 0, [("cap", 0)] + ["submit"] * 4 + [("cap", 0)]
                   + ["accept"] * 4 + [("cap", 0), ("cap", 1)]),
    "limit_eta": (1000, 2, 3, [("cap", 0)] + ["submit"] * 8 + [("cap", 0), ("cap", 2)]),
    "rejected_frees": (10, 2, 0, ["submit", "submit", ("cap", 0), "reject", ("cap", 0)]),
    "negative": (2, 1, 0, ["submit", "submit", ("cap", 0)]),
    "min_clamps": (0, 0, 0, [("cap", 0), ("cap", 3)]),
    "interleaved": (6, 3, 1, ["submit"] * 5 + [("cap", 0), "accept", "reject", ("cap", 1),
                                               "submit", "accept", "accept", ("cap", 2)]),
    "double_settle": (4, 2, 0, ["submit", "accept", "accept"]),
}


def _replay(manager, events):
    out = []
    for ev in events:
        try:
            if isinstance(ev, tuple):
                out.append(("cap", manager.get_capacity(ev[1])))
            else:
                getattr(manager, f"on_rollout_{ev}ed" if ev != "submit"
                        else "on_rollout_submitted")()
        except RuntimeError as e:
            out.append(("error", str(e)))
            break
        out.append(("stat", asdict(manager.get_stats())))
    return out


@pytest.mark.parametrize("case", sorted(STALENESS_CASES))
def test_staleness_manager_matches_jax(case):
    from areal_tpu.core.staleness import StalenessManager as JaxManager

    mc, bs, eta, events = STALENESS_CASES[case]
    want = _replay(JaxManager(mc, bs, eta), events)
    got = _replay(StalenessManager(mc, bs, eta), events)
    assert got == want
    if case == "double_settle":
        assert got[-1][0] == "error" and "staleness ledger violated" in got[-1][1]


class _FakeEngine:
    """Deterministic inference engine: a request's completion is a fixed
    function of its prompt and budget; each token carries the engine's
    current version, each logprob is -(token % 7) / 10."""

    def __init__(self, response_cls):
        self.response_cls = response_cls
        self.version = 0

    def get_version(self):
        return self.version

    async def agenerate(self, req):
        await asyncio.sleep(0)
        seed = sum(req.input_ids) + 31 * len(req.input_ids)
        n = 1 + seed % req.gconfig.max_new_tokens
        toks = [(seed * (i + 3)) % 101 for i in range(n)]
        return self.response_cls(
            input_tokens=list(req.input_ids), output_tokens=toks,
            output_logprobs=[-(t % 7) / 10 for t in toks],
            output_versions=[self.version] * n, stop_reason="length")


class _Workflow:
    """One request per item through the engine, scored in process; `pkg`
    is the package's io_struct module and `gen` its generation config."""

    def __init__(self, request_cls, gen_cls):
        self.request_cls, self.gen_cls = request_cls, gen_cls

    async def arun_episode(self, engine, data):
        resp = await engine.agenerate(self.request_cls(
            input_ids=list(data["input_ids"]), gconfig=self.gen_cls(max_new_tokens=9)))
        ids = resp.input_tokens + resp.output_tokens
        return {
            "input_ids": np.array([ids], np.int32),
            "attention_mask": np.ones((1, len(ids)), bool),
            "versions": np.array([[-1] * resp.input_len + resp.output_versions], np.int32),
            "rewards": np.array([sum(resp.output_tokens) % 2], np.float32),
        }


def _rows(batch):
    """Rows in a canonical order (the executor shuffles what it returns)."""
    order = sorted(range(batch["input_ids"].shape[0]),
                   key=lambda i: batch["input_ids"][i].tolist())
    return {k: v[order] for k, v in batch.items()}


def _run_executor(executor_cls, cfg, dl_cls, response_cls, request_cls, gen_cls, dataset):
    engine = _FakeEngine(response_cls)
    ex = executor_cls(cfg, engine)
    ex.initialize()
    batches = []
    try:
        loader = dl_cls(dataset, batch_size=4, seed=0)
        wf = _Workflow(request_cls, gen_cls)
        random.seed(0)
        for _ in range(4):
            batches.append(_rows(ex.prepare_batch(loader, workflow=wf)))
            engine.version += 1  # one train step per batch
        batches.append(_rows(ex.rollout_batch(dataset[:3], workflow=wf)))
        stats = asdict(ex.staleness_manager.get_stats())
    finally:
        ex.destroy()
    return batches, stats


def test_workflow_executor_batches_match_jax():
    from areal_tpu.api import config as jconfig
    from areal_tpu.api import io_struct as jio
    from areal_tpu.core.executor import WorkflowExecutor as JaxExecutor
    from areal_tpu.utils.dataloader import StatefulDataLoader as JaxLoader

    rng = np.random.default_rng(0)
    dataset = [{"input_ids": rng.integers(0, 50, int(rng.integers(3, 9))).tolist(),
                "query_id": str(i)} for i in range(10)]
    kw = dict(consumer_batch_size=4, max_concurrent_rollouts=8, max_head_offpolicyness=1,
              check_trajectory_format=True)
    want, wstats = _run_executor(JaxExecutor, jconfig.InferenceEngineConfig(**kw), JaxLoader,
                                 jio.ModelResponse, jio.ModelRequest,
                                 jconfig.GenerationHyperparameters, dataset)
    got, gstats = _run_executor(WorkflowExecutor, tconfig.InferenceEngineConfig(**kw),
                                StatefulDataLoader, tio.ModelResponse, tio.ModelRequest,
                                tconfig.GenerationHyperparameters, dataset)
    assert gstats == wstats
    assert gstats["submitted"] == gstats["accepted"] + gstats["rejected"] + gstats["running"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # later batches carry later versions: the executor consumed in order
    assert [int(b["versions"].max()) for b in got[:4]] == [0, 1, 2, 3]


SYNTH_SEED = 3


def _synth_items(n=4):
    tok = WordTokenizer()
    return tok, [{"input_ids": tok.apply_chat_template(p["messages"]),
                  "answer": p["answer"], "query_id": p["query_id"]}
                 for p in generate_problems(n, seed=SYNTH_SEED)]


class _FixedEngine:
    """Answers sample k of every prompt with a fixed completion: right,
    wrong, or without an answer marker."""

    def __init__(self, tok, answers, response_cls):
        self.tok, self.answers, self.response_cls = tok, answers, response_cls

    def get_version(self):
        return 2

    async def agenerate(self, req):
        k = int(req.rid.rsplit("-", 1)[1])
        ans = self.answers[k % len(self.answers)]
        text = [f" The answer is \\boxed{{{ans}}} .", " The answer is \\boxed{0} .",
                " 1 + 1 = 2 ."][k % 3]
        toks = self.tok.encode(text) + [self.tok.eos_token_id]
        return self.response_cls(
            input_tokens=list(req.input_ids), output_tokens=toks,
            output_logprobs=[-0.25 * (i + 1) for i in range(len(toks))],
            output_versions=[2] * len(toks), stop_reason="stop")


def test_rlvr_workflow_trajectories_match_jax():
    from areal_tpu.api import config as jconfig
    from areal_tpu.api import io_struct as jio
    from areal_tpu.reward import gsm8k_reward_fn as jax_reward
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    tok, items = _synth_items(2)
    for item in items:
        runs = []
        for wf_cls, cfg, io, reward in (
                (JaxRLVR, jconfig, jio, jax_reward),
                (RLVRWorkflow, tconfig, tio, gsm8k_reward_fn)):
            wf = wf_cls(reward_fn=reward, tokenizer=tok,
                        gconfig=cfg.GenerationHyperparameters(n_samples=3, max_new_tokens=16))
            engine = _FixedEngine(tok, [item["answer"]], io.ModelResponse)
            runs.append((asyncio.run(wf.arun_episode(engine, item)), wf))
        (want, _), (got, wf) = runs
        assert set(got) == set(want) == {"input_ids", "logprobs", "loss_mask", "versions",
                                         "rewards", "attention_mask"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        assert got["rewards"].tolist() == [1.0, 0.0, 0.0]  # right, wrong, no marker
        assert wf.reward_fn.timeouts == wf.reward_fn.failures == 0


REWARD_CASES = [
    ("The answer is \\boxed{42} .", "42"),
    ("so 6 x 7 = 42 . The answer is \\boxed{42.0} .", "42"),
    ("The answer is \\boxed{41} .", "42"),
    ("6 x 7 = 42 .", "42"),
    ("The final answer is \\frac{1}{2}", "0.5"),
    ("#### 1,234", "1234"),
    ("The answer is \\boxed{\\sqrt{4}} .", "2"),
    ("The answer is \\boxed{50\\%} .", "0.5"),
]


@pytest.mark.parametrize("completion,answer", REWARD_CASES)
def test_gsm8k_reward_matches_jax(completion, answer):
    from areal_tpu.reward import gsm8k_reward_fn as jax_reward

    want = jax_reward("", completion, [], [], answer=answer)
    assert gsm8k_reward_fn("", completion, [], [], answer=answer) == want


def test_word_tokenizer_and_synth_rows_match_jax():
    from areal_tpu.dataset.gsm8k_synth import WordTokenizer as JaxTokenizer
    from areal_tpu.dataset.gsm8k_synth import generate_problems as jax_problems

    want = jax_problems(24, seed=SYNTH_SEED)
    got = generate_problems(24, seed=SYNTH_SEED)
    assert got == want
    jt, tt = JaxTokenizer(), WordTokenizer()
    assert tt.vocab == jt.vocab
    for p in got:
        ids = tt.apply_chat_template(p["messages"])
        assert ids == jt.apply_chat_template(p["messages"])
        sol = tt.encode(" " + p["solution"])
        assert sol == jt.encode(" " + p["solution"])
        assert tt.decode(sol) == jt.decode(sol)
        assert gsm8k_reward_fn("", tt.decode(sol), [], [], answer=p["answer"]) == 1.0
