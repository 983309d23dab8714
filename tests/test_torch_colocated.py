"""The port's colocated engine (`areal_tpu_torch/engine/colocated.py`) and
the generation engine's in-memory weight paths, against the JAX package.

- The three behaviours of `tests/test_colocated.py` on the port:
  rollout/train alternation with the in-memory handoff, the abort-and-
  resume contract, and re-arming with the same weights.
- The JAX and the port `ColocatedEngine` give equal greedy streams through
  `rollout_batch`, before and after `publish_weights` of a second
  parameter set.
- `swap_weights_live` between two hand-driven `step()` calls gives equal
  streams and per-token versions in both packages.

f32 on the CPU, weights carried over with `params_from_jax`.  Greedy
streams must be equal; logprobs agree to 1e-4 (f32 forwards in another op
order, as in test_torch_engine.py).
"""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine.colocated import ColocatedEngine
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config

ATOL = 1e-4
KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
ENGINE = dict(n_slots=4, max_seq_len=256, prompt_bucket=16, kv_dtype="float32")


@pytest.fixture(scope="module")
def trees():
    """Two JAX parameter sets (random q/k/v biases), as numpy trees."""
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**KW)
    out = []
    for seed in (0, 1):
        tree = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed + 10)
        for k in ("bq", "bk", "bv"):
            tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(
                tree["layers"]["attn"][k].shape)).astype(np.float32)
        out.append(tree)
    return jcfg, out


def _model(tree):
    return params_from_jax(tree, tiny_config(**KW), "cpu")


def _colocated(tree, **kw):
    return ColocatedEngine(tiny_config(**KW), params=_model(tree), device="cpu",
                           **dict(ENGINE, **kw))


class _EchoWorkflow:
    """One greedy request per item; `request` is the package's
    ModelRequest class."""

    def __init__(self, request, gconfig, max_new_tokens=6):
        self.request, self.gconfig, self.max_new = request, gconfig, max_new_tokens

    async def arun_episode(self, engine, data):
        resp = await engine.agenerate(self.request(
            rid=str(data["query_id"]), input_ids=list(data["ids"]),
            gconfig=self.gconfig(max_new_tokens=self.max_new, greedy=True)))
        ids = list(data["ids"]) + resp.output_tokens
        n_in = len(data["ids"])
        return {
            "input_ids": np.array([ids], np.int32),
            "attention_mask": np.ones((1, len(ids)), bool),
            "logprobs": np.array([[0.0] * n_in + resp.output_logprobs], np.float32),
            "versions": np.array([[-1] * n_in + resp.output_versions], np.int32),
        }


def _port_workflow(max_new_tokens=6):
    return _EchoWorkflow(ModelRequest, GenerationHyperparameters, max_new_tokens)


def _items(seed, n=6, vocab=97):
    rng = np.random.default_rng(seed)
    return [{"query_id": i, "ids": rng.integers(0, vocab, int(rng.integers(4, 12))).tolist()}
            for i in range(n)]


def test_colocated_rollout_train_alternation(trees):
    _, (t0, t1) = trees
    eng = _colocated(t0)
    data = _items(0)
    batch = eng.rollout_batch(data, workflow=_port_workflow())
    assert batch["input_ids"].shape[0] == 6
    assert int(batch["versions"].max()) == 0
    # train phase: serving memory released, then the in-memory handoff
    with eng.train_phase():
        assert eng.engine.cache is None and eng.engine.model is None
        new = _model(t1)  # "the train step"
    eng.publish_weights(new, version=1)
    assert eng.get_version() == 1 and eng.engine.cache is not None
    assert eng.engine.model is new  # served as handed over
    batch2 = eng.rollout_batch(data, workflow=_port_workflow())
    assert batch2["input_ids"].shape[0] == 6
    assert int(batch2["versions"].max()) == 1
    assert not np.array_equal(batch["input_ids"], batch2["input_ids"])  # new weights
    eng.destroy()


def test_colocated_abort_resume_contract(trees):
    """A request in flight when the train phase begins is aborted, then
    resumed with its accumulated tokens after the publish."""
    _, (t0, t1) = trees
    eng = _colocated(t0, n_slots=2)
    ids = np.random.default_rng(1).integers(0, 97, 5).tolist()
    max_new = 200

    async def _run():
        task = asyncio.create_task(eng.agenerate(ModelRequest(
            rid="r", input_ids=ids,
            gconfig=GenerationHyperparameters(max_new_tokens=max_new, greedy=True))))
        # wait (no fixed sleep) until the first decode chunk has landed
        deadline = time.monotonic() + 60
        while not any(r is not None and len(r.output_tokens) > 1
                      for r in eng.engine.slot_req):
            assert time.monotonic() < deadline and not task.done()
            await asyncio.sleep(0.001)
        with eng.train_phase():
            pass
        eng.publish_weights(_model(t1), version=5)
        return await task

    resp = asyncio.run(_run())
    assert len(resp.output_tokens) == max_new
    assert resp.stop_reason == "length"
    # the abort landed mid-generation: tokens of both versions, in order
    assert resp.output_versions[0] == 0 and resp.output_versions[-1] == 5
    assert resp.output_versions == sorted(resp.output_versions)
    assert set(resp.output_versions) == {0, 5}
    assert np.isfinite(resp.ttft) and resp.latency >= resp.ttft > 0
    eng.destroy()


@pytest.mark.parametrize("interrupt", [False, True], ids=["live", "interrupt"])
def test_request_during_a_publish_waits_for_the_swap(trees, interrupt):
    """A request that arrives while `update_weights_in_memory` swaps waits
    for the publish: nothing restarts serving under the swap, and every
    token of the request comes from the new weights."""
    _, (t0, t1) = trees
    eng = _colocated(t0, n_slots=2)
    eng.start_serving()
    name = "load_weights" if interrupt else "swap_weights_live"
    swap, auto_start = getattr(eng.engine, name), eng._auto_start
    refused = threading.Event()
    seen, box = {}, {}

    def watched_auto_start():
        serving = auto_start()
        if not serving:
            refused.set()
        return serving

    def client():
        box["resp"] = asyncio.run(eng.agenerate(ModelRequest(
            rid="late", input_ids=[1, 2, 3],
            gconfig=GenerationHyperparameters(max_new_tokens=5, greedy=True))))

    def swap_while_a_request_arrives(*args, **kwargs):
        box["client"] = threading.Thread(target=client)
        box["client"].start()
        seen["refused"] = refused.wait(timeout=60)  # agenerate asked to serve
        seen["stepper"] = eng._stepper is not None and eng._stepper.is_alive()
        seen["serving"], seen["active"] = eng._serving, eng.engine.active_count()
        return swap(*args, **kwargs)

    eng._auto_start = watched_auto_start
    setattr(eng.engine, name, swap_while_a_request_arrives)
    eng.update_weights_in_memory(_model(t1), version=3, interrupt=interrupt)
    box["client"].join(timeout=60)
    assert not box["client"].is_alive()
    assert seen == {"refused": True, "stepper": False, "serving": False, "active": 0}
    assert box["resp"].output_versions == [3] * 5 and box["resp"].stop_reason == "length"
    eng.destroy()


def test_resume_serving_same_weights(trees):
    _, (t0, _) = trees
    eng = _colocated(t0, n_slots=2)
    with eng.train_phase():
        pass
    with pytest.raises(RuntimeError, match="restage"):
        eng.resume_serving()  # the weights were dropped
    eng.destroy()

    # with drop_params=False the cache-only cycle works, on the same weights
    eng2 = _colocated(t0, n_slots=2)
    data = _items(2, n=1)
    want = eng2.rollout_batch(data, workflow=_port_workflow())
    with eng2.train_phase(drop_params=False):
        assert eng2.engine.cache is None and eng2.engine.model is not None
    eng2.resume_serving()
    got = eng2.rollout_batch(data, workflow=_port_workflow())
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    eng2.destroy()


def _jax_colocated(jcfg, tree):
    from areal_tpu.engine.colocated import ColocatedEngine as JaxColocated

    return JaxColocated(jcfg, params=tree, ragged_attn=True, kv_reuse=False,
                        share_prefix=False, **ENGINE)


def test_greedy_rollouts_match_jax_before_and_after_publish(trees):
    from areal_tpu.api.config import GenerationHyperparameters as JaxGen
    from areal_tpu.api.io_struct import ModelRequest as JaxRequest

    jcfg, (t0, t1) = trees
    jax_eng, eng = _jax_colocated(jcfg, t0), _colocated(t0)
    jwf, twf = _EchoWorkflow(JaxRequest, JaxGen, 10), _port_workflow(10)
    for version, tree in ((0, None), (1, t1)):
        if tree is not None:
            with jax_eng.train_phase():
                pass
            jax_eng.publish_weights(tree, version=version)
            with eng.train_phase():
                pass
            eng.publish_weights(_model(tree), version=version)
        data = _items(3 + version)
        want = jax_eng.rollout_batch(data, workflow=jwf)
        got = eng.rollout_batch(data, workflow=twf)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["versions"], want["versions"])
        assert int(got["versions"].max()) == version
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=ATOL, rtol=0)
    jax_eng.destroy()
    eng.destroy()


def test_swap_weights_live_between_steps_matches_jax(trees):
    """Hand-driven engines: one step under the first weights, a live swap,
    then steps to the end.  Requests keep their slots and KV; each token's
    version says which weights produced it."""
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    jcfg, (t0, t1) = trees
    jax_eng = JaxEngine(jcfg, params=t0, ragged_attn=True, kv_reuse=False,
                        share_prefix=False, decode_chunk=4, **ENGINE)
    eng = GenEngine(tiny_config(**KW), params=_model(t0), device="cpu", decode_chunk=4,
                    **ENGINE)
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, 97, n).tolist(), m) for n, m in ((6, 13), (11, 9), (4, 20))]
    runs = []
    for e, req_cls, swap in ((jax_eng, JaxRequest, lambda: jax_eng.swap_weights_live(t1, 7)),
                             (eng, GenRequest, lambda: eng.swap_weights_live(_model(t1), 7))):
        reqs = [req_cls(rid=str(i), input_ids=ids, max_new_tokens=m, temperature=0.0)
                for i, (ids, m) in enumerate(specs)]
        for r in reqs:
            e.submit(r)
        e.step()
        assert all(0 < len(r.output_tokens) < m for r, (_, m) in zip(reqs, specs))
        assert swap() == 7 and e.version == 7
        while e.step() or e.active_count():
            pass
        runs.append(reqs)
    for w, g in zip(*runs):
        assert g.output_tokens == w.output_tokens, g.rid
        assert g.output_versions == w.output_versions, g.rid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=ATOL, rtol=0)
        assert 0 in g.output_versions and 7 in g.output_versions
        assert g.first_token_ts > 0


def test_load_weights_in_memory_aborts_then_swaps(trees):
    _, (t0, t1) = trees
    eng = GenEngine(tiny_config(**KW), params=_model(t0), device="cpu", **ENGINE)
    req = GenRequest(rid="a", input_ids=[1, 2, 3], max_new_tokens=50, temperature=0.0)
    eng.submit(req)
    eng.step()
    new = _model(t1)
    assert eng.load_weights(model=new) == 1  # no version: the old one plus one
    assert req.stop_reason == "abort" and eng.model is new and eng.active_count() == 0
    with pytest.raises(ValueError, match="device"):
        eng.swap_weights_live(torch.nn.Linear(2, 2).to("meta"))
    with pytest.raises(ValueError, match="path or a model"):
        eng.load_weights()


def test_failed_decode_step_reaches_the_caller(trees):
    """A step that raises stops the stepper; the request in flight, and any
    submitted after, fail with the error instead of waiting forever."""
    _, (t0, _) = trees
    eng = _colocated(t0, n_slots=2)

    def broken(chunk=None):
        raise RuntimeError("kernel launch failed")

    eng.engine.step = broken
    req = ModelRequest(rid="x", input_ids=[1, 2, 3],
                       gconfig=GenerationHyperparameters(max_new_tokens=4, greedy=True))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="stepper failed") as info:
            asyncio.run(eng.agenerate(req))
        assert "kernel launch failed" in str(info.value.__cause__)
    with pytest.raises(RuntimeError, match="stepper failed"):
        eng.start_serving()
    eng.destroy()
    assert eng.engine.active_count() == 0


def test_launch_counts_are_exact_across_threads():
    """The decode stepper and the trainer both count launches; with a
    switch interval short enough to preempt a bare `+=`, no increment is
    lost."""
    from areal_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = wrapper.launches_tc = 0
    n_threads, n = 12, 3000

    def work():
        for i in range(n):
            _build.count_launch(wrapper, tensor_cores=i % 2 == 0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n and wrapper.launches_tc == n_threads * n // 2


# ---------------------------------------------------------------------------
# on the card: the decode stepper and the trainer on two threads
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_actor(device):
    """A 2-layer bf16 model whose packed rows and heads (T 256, hd 128) take
    the flash kernels; f32 masters, full remat."""
    from areal_tpu_torch.api.config import (
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
    )
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    cfg = tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512, num_heads=2,
                      num_kv_heads=1, qkv_bias=True, eos_token_id=None, dtype="bfloat16")
    actor = TorchPPOActor(PPOActorConfig(
        init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
        pack_length_quantum=256, max_pack_length=256, group_size=4, ppo_n_minibatches=1,
        adv_norm=NormConfig(mean_level="group", std_level="group"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
    ), model_config=cfg, device=device)
    actor.initialize(ft_spec=FinetuneSpec(1, 64, 8))
    return actor, cfg


def _train_batch():
    rng = np.random.default_rng(0)
    B, L, P = 8, 96, 16
    lens = rng.integers(40, L + 1, B)
    mask = np.arange(L)[None, :] < lens[:, None]
    batch = {
        "input_ids": rng.integers(0, 512, (B, L)).astype(np.int32) * mask,
        "attention_mask": mask,
        "loss_mask": (np.arange(L)[None, :] >= P) * mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": rng.integers(0, 2, B).astype(np.float32),
    }
    return batch


@pytest.mark.gpu
def test_decode_stepper_beside_train_batch_on_the_card(cuda_device):
    """The decode stepper runs while the trainer's `ppo_update` runs on the
    caller's thread.  The launch counters stay exact (no increment lost
    between the threads) and the update is bit-equal to the same update run
    alone."""
    from areal_tpu_torch.ops import flash_attention as fa
    from areal_tpu_torch.ops.ragged_decode import ragged_paged_attention

    def flash():
        return tuple(w.launches for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv))

    def update(actor):
        batch = _train_batch()
        batch["prox_logp"] = actor.compute_logp(batch)
        actor.compute_advantages(batch)
        before = flash()
        stats = actor.ppo_update(batch)
        torch.cuda.synchronize()
        return stats, np.subtract(flash(), before), _params_of(actor.model)

    alone_actor, cfg = _card_actor(cuda_device)
    want_stats, want_flash, want = update(alone_actor)
    assert want_flash[0] > 0 and want_flash[1] == want_flash[2] > 0

    actor, _ = _card_actor(cuda_device)
    eng = ColocatedEngine(cfg, params=actor.export_device_params(), n_slots=8,
                          max_seq_len=1024, prompt_bucket=128, decode_chunk=8,
                          device=cuda_device)
    rng = np.random.default_rng(1)
    reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, 512, 50).tolist(),
                       max_new_tokens=900, temperature=1.0) for i in range(8)]
    ragged_paged_attention.launches = 0
    steps0 = eng.engine.stats["decode_steps"]
    eng.start_serving()
    for r in reqs:
        eng.engine.submit(r)
    deadline = time.monotonic() + 120
    while eng.engine.stats["decode_steps"] == steps0:  # decoding is under way
        assert time.monotonic() < deadline
        time.sleep(0.001)
    got_stats, got_flash, got = update(actor)
    mid = eng.engine.stats["decode_steps"]
    eng.stop_serving()
    steps = eng.engine.stats["decode_steps"] - steps0
    assert mid > steps0 and any(not r.stop_reason for r in reqs)  # overlapped the update
    assert ragged_paged_attention.launches == cfg.num_layers * steps
    np.testing.assert_array_equal(got_flash, want_flash)
    for g, w in zip(got_stats, want_stats):
        for k in ("loss", "grad_norm", "importance_weight", "new_logp"):
            assert g[k] == w[k], k
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    eng.destroy()


def _params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}
