"""The port's η-staleness ablation (`areal_tpu_torch/scripts/staleness_ablation.py`)
against the reference's `scripts/staleness_ablation.py`, on the CPU.

- The task is the reference's: with one tokenizer handed to both scripts
  (the port's `ArithmeticTokenizer`), the problems, the encoded prompts,
  the sequence length, the model config and the reward are equal exactly.
- The η FIFO: step t trains on the batch generated at step t - η (also
  with interrupted batches, whose first half comes from the η-old policy).
- One `_make_actor` update (decoupled: the proximal recompute, the
  behaviour-weight cap, group advantages, four minibatches) on one fixed
  batch sampled by the port, from the same warm parameters (the reference's
  SFT warm start, carried across by `models/convert.py`), lands within
  1e-5 of the JAX actor's parameters, in f32: Adam moves each element by
  about lr = 1e-4 a minibatch, and 1e-5 bounds the f32 reduction-order
  differences that its normalisation amplifies.
- The SFT warm start (`warmstart_params`: the token-aligned answer mask
  through `train_batch` with `sft_loss_fn`), from the JAX actor's initial
  parameters with the same tokenizer and seed, against the reference's
  `warmstart_params`.  After one step every element that Adam moved by a
  full step (at least 0.9 lr) is within 1e-5; the rest, whose
  gradient cancels to the scale of Adam's eps (1e-8), take a step that
  f32 rounding decides, within 2 lr.  Over WARM_SFT_STEPS steps each
  step's loss and gradient norm agree within 1e-5 relative, and each
  tensor's distance to JAX's is under 1e-3 of how far it moved: an
  element-wise 1e-5 does not hold there, because each later step
  normalises near-cancelling gradients again (the largest element moved
  1.8e-5 apart after 10 steps at lr 1e-3, each tensor 1.6e-4 of its
  movement).
- A 2-step CPU run of `main` writes its JSON.

The batch size is cut to a few prompts (the module constant
PROMPTS_PER_BATCH) so that the CPU runs take seconds.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.scripts import staleness_ablation as abl
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-5
SFT_STEPS = 30  # the warm start of the update check
WARM_SFT_STEPS = 10  # the SFT steps of the warm-start check
SFT_LR = 1e-3  # the scripts' default SFT learning rate
STAT_RTOL = 1e-5  # a step's loss and gradient norm, relative (f32 reduction order)
PARAM_NORM_RTOL = 1e-3  # a tensor's distance to JAX's, over how far it moved


@pytest.fixture(scope="module")
def jabl():
    spec = importlib.util.spec_from_file_location(
        "jax_staleness_ablation", os.path.join(REPO, "scripts", "staleness_ablation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_batches(monkeypatch):
    monkeypatch.setattr(abl, "PROMPTS_PER_BATCH", 4)


def test_task_matches_jax(jabl):
    tok = abl.ArithmeticTokenizer()
    for seed in (0, 1, 7):
        got = abl._problems(np.random.default_rng(seed), 64)
        want = jabl._problems(np.random.default_rng(seed), 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert abl._encode_prompts(tok, *got[:2]) == jabl._encode_prompts(tok, *want[:2])
        enc, ans = abl.Task(tok, 15, 18).batch_prompts(np.random.default_rng(seed))
        jenc, jans = jabl.Task(tok, 15, 18).batch_prompts(np.random.default_rng(seed))
        assert enc == jenc
        np.testing.assert_array_equal(ans, jans)
    task, mcfg = abl._task_setup(tok)
    jtask, jmcfg = jabl._task_setup(tok)
    assert (task.max_prompt, task.L) == (jtask.max_prompt, jtask.L) == (15, 18)
    for k in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "qkv_bias", "max_position_embeddings", "dtype"):
        assert getattr(mcfg, k) == getattr(jmcfg, k), k
    # the answer is a space token and a digit token, as under the reference's BPE
    p = tok.encode("Q: 3 + 4 = ? A:")
    assert tok.encode("Q: 3 + 4 = ? A: 7") == p + tok.encode(" 7") and len(tok.encode(" 7")) == 2
    assert tok.decode(tok.encode("Q: 3 + 4 = ? A: 7") + [tok.pad_token_id]) == "Q: 3 + 4 = ? A: 7"
    for comp in (" 7", "7", " 7 3", " 73", "Q 7", "", "  ", " 7A:", "?:", " 8"):
        for ans in (7, 8):
            assert task.reward(comp, ans) == jtask.reward(comp, ans), (comp, ans)


def test_eta_fifo_trains_on_old_batches(small_batches):
    tok = abl.ArithmeticTokenizer()
    warm = abl.warmstart_params(tok, 0, sft_steps=1, device="cpu")
    for eta, steps, interrupt, want in ((0, 2, 0, [(0, 0), (1, 1)]),
                                        (2, 5, 0, [(2, 0), (3, 1), (4, 2)]),
                                        (1, 4, 2, [(1, 0), (2, 1), (3, 2)])):
        consumed = []
        curve = abl.run(eta, eta != 2, steps, tok, warm, seed=3, interrupt_every=interrupt,
                        device="cpu", consumed=consumed)
        assert consumed == want, (eta, interrupt)
        assert len(curve) == steps and all(0.0 <= r <= 1.0 for r in curve)


def test_one_update_matches_jax(jabl, small_batches, monkeypatch):
    import jax

    monkeypatch.setattr(jabl, "PROMPTS_PER_BATCH", 4)
    tok = abl.ArithmeticTokenizer()
    task, mcfg = abl._task_setup(tok)
    jtask, jmcfg = jabl._task_setup(tok)
    # the warm parameters: the reference's SFT warm start, handed to both
    warm = jabl.warmstart_params(tok, 0, SFT_STEPS)
    ja = jabl._make_actor(jtask, jmcfg, 1, True, 1e-4, 10)
    ja.params = jax.tree_util.tree_map(
        lambda s, w: jax.device_put(np.asarray(w), s.sharding), ja.params, warm)
    ta = abl._make_actor(task, mcfg, 1, True, 1e-4, 10, device="cpu")

    def jax_params():
        return params_from_jax(jax.tree_util.tree_map(np.asarray, ja.params), mcfg, "cpu",
                               param_dtype="float32")

    abl._load(ta.model, abl._state(jax_params()))
    gen = torch.Generator().manual_seed(0)
    batch = abl._sample_batch(ta, mcfg, task, np.random.default_rng(0), gen)
    assert batch["input_ids"].shape == (4 * abl.GROUP, task.L)
    assert 0 < batch["rewards"].sum() < len(batch["rewards"])  # advantages are not all 0
    bj = {k: np.array(v) for k, v in batch.items()}
    bt = {k: np.array(v) for k, v in batch.items()}
    bj["prox_logp"] = ja.compute_logp(bj)
    bt["prox_logp"] = ta.compute_logp(bt)
    np.testing.assert_allclose(bt["prox_logp"], bj["prox_logp"], atol=1e-4, rtol=0)
    ja.compute_advantages(bj)
    ta.compute_advantages(bt)
    np.testing.assert_allclose(bt["advantages"], bj["advantages"], atol=1e-6, rtol=0)
    init = abl._state(ta.model)
    sj, st = ja.ppo_update(bj), ta.ppo_update(bt)
    assert len(sj) == len(st) == 4
    ref = dict(jax_params().named_parameters())
    moved = 0.0
    for n, p in ta.model.named_parameters():
        assert (p - ref[n]).abs().max().item() < PARAM_ATOL, n
        moved = max(moved, (p - init[n]).abs().max().item())
    assert moved > 10 * PARAM_ATOL  # the update moved the parameters (lr 1e-4)


def test_sft_warmstart_matches_jax(jabl, monkeypatch):
    import jax

    monkeypatch.setattr(abl, "PROMPTS_PER_BATCH", 4)
    monkeypatch.setattr(jabl, "PROMPTS_PER_BATCH", 4)
    tok = abl.ArithmeticTokenizer()
    task, mcfg = abl._task_setup(tok)
    jtask, jmcfg = jabl._task_setup(tok)

    def to_port(tree):
        return abl._state(params_from_jax(jax.tree_util.tree_map(np.asarray, tree), mcfg,
                                          "cpu", param_dtype="float32"))

    # the JAX actor's seeded initial parameters: the ones its warm start
    # builds, handed to the port's actor when `warmstart_params` makes it
    ja = jabl._make_actor(jtask, jmcfg, 0, True, SFT_LR, WARM_SFT_STEPS + 1)
    init = to_port(ja.params)
    ja.destroy()
    stats = {"port": [], "jax": []}

    def recording(make, key, load_init):
        def build(*a, **kw):
            actor = make(*a, **kw)
            if load_init:
                abl._load(actor.model, init)
            inner = actor.train_batch

            def train_batch(*x, **y):
                out = inner(*x, **y)
                stats[key].append({k: float(out[k]) for k in ("loss", "grad_norm")})
                return out

            actor.train_batch = train_batch
            return actor
        return build

    monkeypatch.setattr(abl, "_make_actor", recording(abl._make_actor, "port", True))
    monkeypatch.setattr(jabl, "_make_actor", recording(jabl._make_actor, "jax", False))

    # one step: every element that Adam moved by a full step agrees
    got = abl.warmstart_params(tok, 0, 1, sft_lr=SFT_LR, device="cpu")
    want = to_port(jabl.warmstart_params(tok, 0, 1, sft_lr=SFT_LR))
    assert set(got) == set(want) == set(init)
    for n, p in got.items():
        diff = (p - want[n]).abs()
        # Adam's first step is lr g / (|g| + eps): a full lr where |g| is
        # far above eps, a fraction of it where the gradient cancels to
        # eps's scale, and there the f32 rounding of g decides the step
        # (at 0.55 lr, |g| = 1.2 eps, the port and JAX stepped 1.1e-5 apart)
        full = (want[n] - init[n]).abs() >= 0.9 * SFT_LR
        assert diff[full].max().item() < PARAM_ATOL, n
        assert diff.max().item() < 2 * SFT_LR, n
    # WARM_SFT_STEPS steps: the same losses and gradient norms at every
    # step, and parameters that moved the same way
    got = abl.warmstart_params(tok, 0, WARM_SFT_STEPS, sft_lr=SFT_LR, device="cpu")
    want = to_port(jabl.warmstart_params(tok, 0, WARM_SFT_STEPS, sft_lr=SFT_LR))
    assert len(stats["port"]) == len(stats["jax"]) == 1 + WARM_SFT_STEPS
    for g, w in zip(stats["port"], stats["jax"]):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=STAT_RTOL, abs=0), k
    for n, p in got.items():
        moved = (want[n] - init[n]).norm().item()
        assert moved > 0, n
        assert (p - want[n]).norm().item() < PARAM_NORM_RTOL * moved, n


def test_two_step_run_writes_json(tmp_path, monkeypatch):
    monkeypatch.setattr(abl, "PROMPTS_PER_BATCH", 2)
    out = tmp_path / "abl.json"
    abl.main(["--device", "cpu", "--steps", "2", "--sft-steps", "1", "--etas", "0", "1",
              "--out", str(out)])
    res = json.loads(out.read_text())
    assert set(res["results"]) == {"eta0_decoupled", "eta0_naive", "eta1_decoupled",
                                   "eta1_naive"}
    for r in res["results"].values():
        assert 0.0 <= r["final_reward"] <= 1.0
        assert len(r["curves"]) == 1 and len(r["curves"][0]) == 2
    assert res["setup"]["device_kind"] == "cpu" and res["setup"]["steps"] == 2
