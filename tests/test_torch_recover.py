"""The training job's infrastructure in the torch port against the JAX
package, on the CPU at a tiny size (the cases of `tests/test_train_infra.py`
and the fault points of `tests/test_faults.py`):

- `FrequencyControl`, `Saver` (paths, periods, the staged publish) and
  `Evaluator` make the same decisions as JAX's over one step sequence, on
  a clock the test moves, and across a `state_dict` round trip.
- `RecoverHandler`, torch against torch on `TorchPPOActor`: the round trip
  (masters, `mu`/`nu` and the update count bit-equal, version, dataloader,
  saver), then one `ppo_update` from the loaded state bit-equal to the
  uninterrupted one; a torn dump falls back; a tampered generation is
  refused; a changed fingerprint is refused; the sidecar and the prune.
- The engine's f32 save read by JAX's `load_hf_params`, bit-equal; a JAX
  HF save read by the engine's `load`, bit-equal.
- `restore_staleness`: the same settled count, ledger and lost count as
  JAX's executor.
- `StatefulDataLoader` resumed mid-epoch: the order of JAX's.
- `seeding.set_random_seed`: the folded seeds and numpy streams of JAX's.
- `AREAL_FAULT_POINTS`: the same hits act as in JAX's parser.
"""

import json
import os
import random
import types

import numpy as np
import pytest
import torch

from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, RolloutStat, SaveLoadMeta, StepInfo
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.utils import faults, seeding
from areal_tpu_torch.utils import timer as ttimer
from areal_tpu_torch.utils.dataloader import StatefulDataLoader
from areal_tpu_torch.utils.evaluator import Evaluator
from areal_tpu_torch.utils.recover import (
    RecoverConfigMismatch,
    RecoverHandler,
    check_if_recover,
    config_fingerprint,
)
from areal_tpu_torch.utils.saver import Saver
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

V = 64


def _actor(lr=1e-2):
    cfg = tc.PPOActorConfig(
        init_from_scratch=True, dtype="float32", gradient_checkpointing=False,
        mb_spec=tc.MicroBatchSpec(n_mbs=1), pack_length_quantum=16, group_size=2,
        ppo_n_minibatches=2, adv_norm=tc.NormConfig(mean_level="batch", std_level="batch"),
        optimizer=tc.OptimizerConfig(lr=lr, warmup_steps_proportion=0.25,
                                     lr_scheduler_type="cosine", weight_decay=0.01))
    actor = TorchPPOActor(cfg, tiny_config(vocab_size=V, qkv_bias=True,
                                           hf_architecture="Qwen2ForCausalLM"), device="cpu")
    actor.initialize(ft_spec=FinetuneSpec(4, 16, 4))
    return actor


def _batch(seed):
    rng = np.random.default_rng(seed)
    B, L, P = 4, 12, 3
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < np.asarray([12, 8, 10, 12])[:, None]
    return {
        "input_ids": ids * mask,
        "attention_mask": mask,
        "loss_mask": np.pad(np.ones((B, L - P), np.float32), ((0, 0), (P, 0))) * mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": rng.normal(0.0, 1.0, B).astype(np.float32),
    }


def _update(actor, seed):
    batch = _batch(seed)
    batch["prox_logp"] = actor.compute_logp(batch)
    actor.compute_advantages(batch)
    return actor.ppo_update(batch)


def _rcfg(tmp_path, name, **kw):
    return tc.RecoverConfig(mode="auto", experiment_name=name, trial_name="t",
                            fileroot=str(tmp_path), **kw)


def _assert_same_state(a, b):
    for (n, p), (m, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert n == m and torch.equal(p, q), n
    oa, ob = a._optimizer, b._optimizer
    assert oa.names == ob.names and oa.count == ob.count
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    assert a.step_count == b.step_count


# ---------------------------------------------------------------------------
# frequency control, saver, evaluator: the JAX decisions
# ---------------------------------------------------------------------------

# (epoch, step, seconds the clock moves before the check, force)
SEQUENCE = [(0, s, 1.5, False) for s in range(6)] + [(1, 6, 0.5, False), (1, 7, 4.0, True),
                                                     (1, 8, 0.1, False), (2, 9, 7.0, False),
                                                     (2, 10, 0.0, False), (3, 11, 2.0, False)]


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("freq", [dict(freq_steps=3), dict(freq_secs=5),
                                  dict(freq_epochs=1, freq_steps=4), dict(freq_secs=0), {}])
def test_frequency_control_matches_jax(monkeypatch, freq):
    from areal_tpu.api.config import TimerConfig as JaxTimer
    from areal_tpu.utils import timer as jtimer

    clock = _Clock()
    for mod in (ttimer, jtimer):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    mine, theirs = ttimer.FrequencyControl(tc.TimerConfig(**freq)), \
        jtimer.FrequencyControl(JaxTimer(**freq))
    got, want = [], []
    for i, (epoch, step, dt, force) in enumerate(SEQUENCE):
        clock.now += dt
        got.append(mine.check(epoch, step, force))
        want.append(theirs.check(epoch, step, force))
        if i == 5:  # a resumed run continues the same decisions
            state = mine.state_dict()
            assert state == theirs.state_dict()
            mine = ttimer.FrequencyControl(tc.TimerConfig(**freq))
            mine.load_state_dict(state)
    assert got == want
    assert any(got) == bool(freq) or freq == {}


class _FakeEngine:
    """Writes a marker where the saver asks; records the requests."""

    def __init__(self):
        self.saved = []

    def save(self, meta):
        os.makedirs(meta.path, exist_ok=True)
        with open(os.path.join(meta.path, "config.json"), "w") as f:
            json.dump({"with_optim": meta.with_optim}, f)
        self.saved.append(meta.with_optim)


@pytest.mark.parametrize("for_recover", [False, True])
def test_saver_and_evaluator_match_jax(monkeypatch, tmp_path, for_recover):
    from areal_tpu.api.config import EvaluatorConfig as JaxEvalCfg
    from areal_tpu.api.config import SaverConfig as JaxSaverCfg
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.utils import timer as jtimer
    from areal_tpu.utils.evaluator import Evaluator as JaxEvaluator
    from areal_tpu.utils.saver import Saver as JaxSaver

    clock = _Clock()
    for mod in (ttimer, jtimer):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    kw = dict(experiment_name="e", trial_name="t", freq_steps=2, freq_secs=6)
    mine = Saver(tc.SaverConfig(fileroot=str(tmp_path / "torch"), **kw), FinetuneSpec(4, 24, 4),
                 for_recover=for_recover)
    theirs = JaxSaver(JaxSaverCfg(fileroot=str(tmp_path / "jax"), **kw), JaxSpec(4, 24, 4),
                      for_recover=for_recover)
    ev_mine = Evaluator(tc.EvaluatorConfig(freq_steps=3))
    ev_theirs = JaxEvaluator(JaxEvalCfg(freq_steps=3))
    e_mine, e_theirs = _FakeEngine(), _FakeEngine()
    calls = []
    for epoch, step, dt, force in SEQUENCE:
        clock.now += dt
        p = mine.save(e_mine, epoch, step % 6, step, force=force)
        q = theirs.save(e_theirs, epoch, step % 6, step, force=force)
        assert (p is None) == (q is None), step
        if p is not None:
            assert os.path.relpath(p, tmp_path / "torch") == os.path.relpath(q, tmp_path / "jax")
            assert os.path.isfile(os.path.join(p, "config.json"))
            assert not any(d.startswith(".tmp-") for d in os.listdir(os.path.dirname(p)))
        a = ev_mine.evaluate(lambda: calls.append(step) or {"x": step}, epoch, step % 6, step)
        b = ev_theirs.evaluate(lambda: {"x": step}, epoch, step % 6, step)
        assert a == b
    assert e_mine.saved == e_theirs.saved and e_mine.saved
    assert all(w == for_recover for w in e_mine.saved)
    assert calls and mine.state_dict().keys() == theirs.state_dict().keys()


# ---------------------------------------------------------------------------
# RecoverHandler, torch against torch
# ---------------------------------------------------------------------------


def test_recover_round_trip_then_update_is_bit_equal(tmp_path):
    """dump -> load into a fresh actor: masters, mu/nu, update count,
    version, dataloader and saver states restored; one ppo_update from
    the loaded state equals the uninterrupted update bit for bit."""
    live = _actor()
    for s in range(2):
        _update(live, s)
    live.set_version(2)
    handler = RecoverHandler(_rcfg(tmp_path, "rt"), fingerprint=config_fingerprint({"a": 1}))
    loader = StatefulDataLoader(list(range(32)), batch_size=4, seed=3)
    it = iter(loader)
    next(it), next(it), next(it)
    saver = Saver(tc.SaverConfig(experiment_name="rt", trial_name="t", fileroot=str(tmp_path),
                                 freq_steps=2))
    saver.freq.check(0, 2)
    handler.dump(live, StepInfo(epoch=0, epoch_step=1, global_step=1, steps_per_epoch=4),
                 saver=saver, dataloader=loader)
    assert check_if_recover(handler.config)
    assert handler.last_dump["bytes"] > 0 and handler.last_dump["digest_seconds"] >= 0
    optim = os.path.join(handler.generations()[-1], "checkpoint", "optimizer")
    assert os.path.isfile(os.path.join(optim, "adamw_state.json"))

    fresh = _actor()
    loader2 = StatefulDataLoader(list(range(32)), batch_size=4, seed=3)
    saver2 = Saver(saver.config)
    info = handler.load(fresh, saver=saver2, dataloader=loader2)
    assert info is not None and info.recover_start.global_step == 2
    assert fresh.get_version() == 2
    _assert_same_state(live, fresh)
    assert loader2.state_dict() == loader.state_dict()
    assert next(iter(loader2)) == next(it)
    assert saver2.freq.state_dict()["last_step"] == 2
    assert handler.last_load["recovered_step"] == 1 and handler.last_load["seconds"] > 0

    s_live, s_fresh = _update(live, 7), _update(fresh, 7)
    assert [s["loss"] for s in s_live] == [s["loss"] for s in s_fresh]
    _assert_same_state(live, fresh)


def test_optimizer_state_is_matched_by_name(tmp_path):
    """`load` puts each moment on its parameter by name, whatever order
    the parameters come in; a name that is missing is refused."""
    live = _actor()
    _update(live, 0)
    path = str(tmp_path / "ckpt")
    live.save(SaveLoadMeta(path=path, with_optim=True))
    fresh = _actor()
    opt = fresh._optimizer
    order = list(reversed(range(len(opt.names))))
    for attr in ("names", "params", "decay", "mu", "nu"):
        setattr(opt, attr, [getattr(opt, attr)[i] for i in order])
    fresh.load(SaveLoadMeta(path=path, with_optim=True))
    named = dict(zip(live._optimizer.names, live._optimizer.mu))
    for n, mu in zip(opt.names, opt.mu):
        assert torch.equal(mu, named[n]), n
    opt.names[0] = "model.nope"
    with pytest.raises(ValueError, match="do not match"):
        fresh.load(SaveLoadMeta(path=path, with_optim=True))


def test_torn_dump_falls_back(tmp_path):
    actor = _actor()
    _update(actor, 0)
    handler = RecoverHandler(_rcfg(tmp_path, "torn"))
    handler.dump(actor, StepInfo(0, 1, 1, 8))
    ref = actor.compute_logp(_batch(9))
    _update(actor, 1)
    try:
        faults.arm_fault_point("recover_mid_dump", action="raise")
        with pytest.raises(faults.InjectedFault):
            handler.dump(actor, StepInfo(0, 2, 2, 8))
    finally:
        faults.reset_fault_points()
    root = handler.recover_root()
    assert os.path.isdir(os.path.join(root, ".tmp-00000002"))
    assert not os.path.isdir(os.path.join(root, "gen-00000002"))
    fresh = _actor()
    info = handler.load(fresh)
    assert info.last_step_info.global_step == 1 and fresh.get_version() == 2
    np.testing.assert_array_equal(fresh.compute_logp(_batch(9)), ref)


def test_tampered_generation_and_changed_fingerprint_are_refused(tmp_path):
    actor = _actor()
    _update(actor, 0)
    fp = config_fingerprint({"lr": 1e-2})
    handler = RecoverHandler(_rcfg(tmp_path, "tamper"), fingerprint=fp)
    handler.dump(actor, StepInfo(0, 1, 1, 8))
    ref = actor.compute_logp(_batch(9))
    _update(actor, 1)
    handler.dump(actor, StepInfo(0, 2, 2, 8))
    newest = handler.generations()[-1]
    assert newest.endswith("gen-00000002")
    # a size-preserving change of the weights: only the digest sees it
    victim = os.path.join(newest, "checkpoint", "model.safetensors")
    with open(victim, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef\xde\xad\xbe\xef")
    fresh = _actor()
    info = handler.load(fresh)
    assert info.last_step_info.global_step == 1
    np.testing.assert_array_equal(fresh.compute_logp(_batch(9)), ref)
    other = RecoverHandler(handler.config, fingerprint=config_fingerprint({"lr": 5e-3}))
    with pytest.raises(RecoverConfigMismatch):
        other.load(_actor())


@pytest.mark.parametrize("keep", [1, 2])
def test_sidecar_and_prune(tmp_path, keep):
    actor = _actor()
    handler = RecoverHandler(_rcfg(tmp_path, "side", keep_generations=keep))
    for step in (1, 2, 3):
        _update(actor, step)
        actor.set_version(step + 1)
        handler.dump(actor, StepInfo(0, step, step, 8))
    names = [os.path.basename(g) for g in handler.generations()]
    assert names == ["gen-00000002", "gen-00000003"][-keep:]
    with open(os.path.join(handler.recover_root(), "recover_info.json")) as f:
        side = json.load(f)
    assert side["last_step_info"]["global_step"] == 3 and side["weight_version"] == 4
    assert side["latest"].endswith("gen-00000003")
    assert [os.path.basename(g) for g in side["generations"]] == names
    with open(os.path.join(handler.generations()[-1], "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["schema"] == "areal-recover/v1"
    assert {"checkpoint/model.safetensors", "checkpoint/optimizer/adamw.safetensors",
            "checkpoint/optimizer/adamw_state.json", "recover_state.pkl"} <= set(
                manifest["files"])
    assert set(manifest["async_state"]) == {"rollout_stat", "seed", "fleet_weight_version"}


def test_check_if_recover_modes_match_jax(tmp_path):
    from areal_tpu.api.config import RecoverConfig as JaxRecoverCfg
    from areal_tpu.utils.recover import check_if_recover as jax_check

    root = tmp_path / "e" / "t" / "recover"

    def both(mode, run_id=0):
        mine = tc.RecoverConfig(mode=mode, experiment_name="e", trial_name="t",
                                fileroot=str(tmp_path))
        theirs = JaxRecoverCfg(mode=mode, experiment_name="e", trial_name="t",
                               fileroot=str(tmp_path))
        out = []
        for fn, cfg in ((check_if_recover, mine), (jax_check, theirs)):
            try:
                out.append(fn(cfg, run_id))
            except FileNotFoundError:
                out.append("raises")
        assert out[0] == out[1], (mode, run_id, out)
        return out[0]

    assert [both(m) for m in ("disabled", "auto", "fault", "resume")] == \
        [False, False, False, "raises"]
    os.makedirs(root / ".tmp-00000003")  # a torn dump alone is invisible
    assert both("auto") is False
    os.makedirs(root / "gen-00000002")
    (root / "gen-00000002" / "manifest.json").write_text("{}")
    assert [both("auto"), both("fault", 0), both("fault", 1), both("resume")] == \
        [True, False, True, True]


# ---------------------------------------------------------------------------
# the engine's checkpoints against JAX's reader and writer
# ---------------------------------------------------------------------------


def test_engine_save_is_read_by_jax_and_jax_save_by_the_engine(tmp_path):
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.hf import load_hf_params as jax_load
    from areal_tpu.models.hf import save_hf_checkpoint as jax_save
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    from areal_tpu_torch.models.convert import params_from_jax

    actor = _actor()
    _update(actor, 0)
    path = str(tmp_path / "torch_save")
    actor.save(SaveLoadMeta(path=path, with_optim=True))
    jparams, jcfg = jax_load(path, dtype="float32")
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), actor.model_config,
                           device="cpu", param_dtype="float32")
    for (n, p), (m, q) in zip(actor.model.named_parameters(), back.named_parameters()):
        assert n == m and torch.equal(p, q), n
    # the bf16 export of the same engine is its bf16 cast
    export = str(tmp_path / "export")
    actor.save(SaveLoadMeta(path=export, with_optim=False))
    jexp, _ = jax_load(export, dtype="float32")
    for (n, p), (m, q) in zip(actor.model.named_parameters(), params_from_jax(
            jax.tree_util.tree_map(np.asarray, jexp), actor.model_config, device="cpu",
            param_dtype="float32").named_parameters()):
        assert torch.equal(p.to(torch.bfloat16).float(), q), n

    jc = jax_tiny(vocab_size=V, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
    theirs = jax_init(jc, jax.random.PRNGKey(3))
    jpath = str(tmp_path / "jax_save")
    jax_save(theirs, jc, jpath, save_dtype="float32")
    fresh = _actor()
    fresh.load(SaveLoadMeta(path=jpath, with_optim=False))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, theirs), fresh.model_config,
                           device="cpu", param_dtype="float32")
    for (n, p), (m, q) in zip(fresh.model.named_parameters(), want.named_parameters()):
        assert n == m and torch.equal(p, q), n


# ---------------------------------------------------------------------------
# ledger, dataloader, seeding, fault points against JAX
# ---------------------------------------------------------------------------


class _Versioned:
    def get_version(self):
        return 3


def test_restore_staleness_matches_jax():
    from areal_tpu.api.config import InferenceEngineConfig as JaxRolloutCfg
    from areal_tpu.api.io_struct import RolloutStat as JaxStat
    from areal_tpu.core.executor import WorkflowExecutor as JaxExecutor

    from areal_tpu_torch.core.executor import WorkflowExecutor

    kw = dict(max_concurrent_rollouts=16, consumer_batch_size=4, max_head_offpolicyness=2)
    mine = WorkflowExecutor(tc.InferenceEngineConfig(**kw), _Versioned())
    theirs = JaxExecutor(JaxRolloutCfg(**kw), _Versioned())
    for snap in (dict(submitted=20, accepted=12, rejected=2, running=6),
                 dict(submitted=8, accepted=8, rejected=0, running=0)):
        mine.lost_trajectories = theirs.lost_trajectories = 1
        a = mine.restore_staleness(RolloutStat(**snap))
        b = theirs.restore_staleness(JaxStat(**snap))
        assert a == b == snap["running"]
        assert vars(mine.staleness_manager.get_stats()) == vars(
            theirs.staleness_manager.get_stats())
        assert mine.lost_trajectories == theirs.lost_trajectories == 1 + a
        assert mine.get_capacity() == theirs.get_capacity()
        mine.staleness_manager.on_rollout_submitted()  # the invariant holds on
        mine.staleness_manager.on_rollout_accepted()


def test_dataloader_resumes_mid_epoch_in_jax_order():
    from areal_tpu.utils.dataloader import StatefulDataLoader as JaxLoader

    data = list(range(30))
    straight = StatefulDataLoader(data, 4, seed=5)
    whole = list(straight) + list(straight)
    mine, theirs = StatefulDataLoader(data, 4, seed=5), JaxLoader(data, 4, seed=5)
    it_m, it_t = iter(mine), iter(theirs)
    head = [next(it_m) for _ in range(3)]
    assert head == [next(it_t) for _ in range(3)]
    assert mine.state_dict() == theirs.state_dict()
    resumed, jresumed = StatefulDataLoader(data, 4, seed=5), JaxLoader(data, 4, seed=5)
    resumed.load_state_dict(mine.state_dict())
    jresumed.load_state_dict(theirs.state_dict())
    tail = list(resumed) + list(resumed)
    assert tail == list(jresumed) + list(jresumed)
    assert head + tail == whole[:len(head) + len(tail)]


@pytest.mark.parametrize("seed,key", [(1, "trainer"), (0, ""), (12345, "rollout/3")])
def test_set_random_seed_matches_jax(seed, key):
    from areal_tpu.utils import seeding as jseeding

    a = seeding.set_random_seed(seed, key)
    want_np, want_py = np.random.rand(4), random.random()
    torch_draw = torch.rand(3)
    b = jseeding.set_random_seed(seed, key)
    assert a == b == seeding._fold(seed, key) == jseeding._fold(seed, key)
    np.testing.assert_array_equal(np.random.rand(4), want_np)
    assert random.random() == want_py
    assert seeding.get_seed() == jseeding.get_seed() == seed
    torch.manual_seed(a)
    assert torch.equal(torch.rand(3), torch_draw)


def test_env_fault_points_match_jax(monkeypatch):
    from areal_tpu.utils import faults as jfaults

    monkeypatch.setenv("AREAL_FAULT_POINTS", "train_step@3:raise, recover_mid_dump:raise")
    for mod in (faults, jfaults):
        mod.reset_fault_points()
    try:
        for mod in (faults, jfaults):
            hits = []
            for name in ("train_step",) * 4 + ("recover_mid_dump", "other"):
                try:
                    mod.fault_point(name)
                    hits.append(False)
                except mod.InjectedFault:
                    hits.append(True)
            assert hits == [False, False, True, False, True, False]
        with pytest.raises(ValueError):
            faults.arm_fault_point("x", action="explode")
    finally:
        for mod in (faults, jfaults):
            mod.reset_fault_points()
