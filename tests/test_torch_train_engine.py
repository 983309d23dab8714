"""The torch port's train engine and PPO actor against the JAX package, and
the publish-and-reload loop on the CPU.

- The `__graft_entry__._dryrun_one` recipe (tiny config, f32, full remat,
  two micro-batches, group-normalised advantages, two PPO minibatches,
  packed multi-segment rows) runs on `JaxPPOActor` and on `TorchPPOActor`
  from the same params: proximal logprobs, advantages, per-minibatch loss
  and grad norm, and the params after the update agree.
- The optimizer against optax's chain over 3 steps with warmup and an
  active clip.
- `update_weights` writes `v{N}`; the engine's `load_weights` and the
  server's `/update_weights_from_disk` reload it; greedy streams then equal
  a fresh engine's built from that snapshot.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.engine.torch_train import AdamW, make_schedule
from areal_tpu_torch.gen import server
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Tolerances (f32 on both sides).  Logprobs: two layers of products in
# another order -> 1e-4.  Advantages: numpy on the same logprob inputs ->
# 1e-6.  Loss and grad norm: sums over the batch, 1e-4 relative.  Params
# after two Adam steps at lr 1e-3: Adam divides each gradient by its own
# running norm, so elements with tiny gradients move by up to ~lr on tiny
# differences; 1e-5 absolute bounds that at this lr.
LOGP_ATOL = 1e-4
ADV_ATOL = 1e-6
STAT_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _cfg_kw(m):
    return dict(
        init_from_scratch=True,
        dtype="float32", gradient_checkpointing=True, mb_spec=m.MicroBatchSpec(n_mbs=2),
        optimizer=m.OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        pack_length_quantum=16, group_size=4, ppo_n_minibatches=2,
        adv_norm=m.NormConfig(mean_level="group", std_level="group", group_size=4),
    )


def _batch(V):
    rng = np.random.default_rng(0)
    B, L, P = 8, 16, 4
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < np.asarray([16, 9, 12, 16, 5, 14, 16, 11])[:, None]
    loss_mask = np.pad(np.ones((B, L - P), np.float32), ((0, 0), (P, 0))) * mask
    return {
        "input_ids": ids * mask,
        "attention_mask": mask,
        "loss_mask": loss_mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": (ids[:, P] % 2 == 0).astype(np.float32),
    }


def _bridge(jax_params, cfg):
    import jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), cfg,
                           device="cpu", param_dtype="float32")


@pytest.fixture(scope="module")
def actors():
    from areal_tpu.api import config as jc
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.engine.ppo import JaxPPOActor
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    ja = JaxPPOActor(jc.PPOActorConfig(**_cfg_kw(jc), experiment_name="dryrun",
                                       trial_name="dryrun"), model_config=jax_tiny())
    ja.initialize(ft_spec=JaxSpec(1, 64, 8))
    ta = TorchPPOActor(tc.PPOActorConfig(**_cfg_kw(tc)), model_config=tiny_config(),
                       device="cpu")
    ta.initialize(ft_spec=FinetuneSpec(1, 64, 8))
    src = dict(_bridge(ja.params, tiny_config()).named_parameters())
    with torch.no_grad():
        for n, p in ta.model.named_parameters():
            p.copy_(src[n])
    return ja, ta


def test_dryrun_recipe_matches_jax(actors):
    ja, ta = actors
    bj, bt = _batch(512), _batch(512)
    bj["prox_logp"] = ja.compute_logp(bj)
    bt["prox_logp"] = ta.compute_logp(bt)
    np.testing.assert_allclose(bt["prox_logp"], bj["prox_logp"], atol=LOGP_ATOL, rtol=0)
    ja.compute_advantages(bj)
    ta.compute_advantages(bt)
    for k in ("advantages", "returns", "logprobs", "loss_mask"):
        np.testing.assert_allclose(bt[k], bj[k], atol=ADV_ATOL, rtol=0, err_msg=k)
    sj, st = ja.ppo_update(bj), ta.ppo_update(bt)
    assert len(sj) == len(st) == 2
    for a, b in zip(sj, st):
        for k in ("loss", "grad_norm", "entropy", "importance_weight", "new_logp"):
            assert abs(b[k] - a[k]) <= STAT_RTOL * max(abs(a[k]), 1e-3), (k, a[k], b[k])
        assert np.isfinite(b["step_time"]) and b["lr"] == pytest.approx(a["lr"])
    ref = dict(_bridge(ja.params, tiny_config()).named_parameters())
    for n, p in ta.model.named_parameters():
        assert (p - ref[n]).abs().max().item() < PARAM_ATOL, n


def test_optimizer_matches_optax_with_warmup_and_clip():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    shapes = {"model.layers.0.mlp.up_proj.weight": (6, 4), "model.layers.0.input_layernorm.weight": (4,),
              "model.norm.weight": (4,), "model.embed_tokens.weight": (10, 4)}
    init = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (3 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    oc = tc.OptimizerConfig(lr=1e-2, weight_decay=0.1, warmup_steps_proportion=0.25,
                            lr_scheduler_type="cosine", min_lr_ratio=0.1, gradient_clipping=1.0)
    total = 8
    # the JAX engine's chain (jax_train.py _build_optimizer), its decay mask
    # on the scan-stacked layout: per-layer leaves have one more axis there
    warmup = int(oc.warmup_steps_proportion * total)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, oc.lr, warmup),
         optax.cosine_decay_schedule(oc.lr, total - warmup, alpha=oc.min_lr_ratio)], [warmup])
    mask = {n: len(s) + n.startswith("model.layers.") >= 2 for n, s in shapes.items()}
    opt = optax.chain(optax.clip_by_global_norm(oc.gradient_clipping),
                      optax.adamw(sched, b1=oc.beta1, b2=oc.beta2, eps=oc.eps,
                                  weight_decay=oc.weight_decay, mask=mask))
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    state = opt.init(jp)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    adam = AdamW(list(params.items()), oc, make_schedule(oc, total))
    for step, g in enumerate(grads):
        upd, state = opt.update({n: jnp.asarray(v) for n, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        norm, lr = adam.step()
        assert norm.item() > oc.gradient_clipping  # the clip is active
        assert lr == pytest.approx(float(sched(step)), rel=1e-6)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), atol=1e-6,
                                       rtol=0, err_msg=f"step {step} {n}")


def _greedy(engine, n=3):
    rng = np.random.default_rng(7)
    reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, 512, 6 + i).tolist(),
                       max_new_tokens=6, temperature=0.0) for i in range(n)]
    engine.generate_blocking(reqs)
    return [r.output_tokens for r in reqs]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_publish_then_reload_on_engine_and_server(actors, tmp_path):
    _, ta = actors
    root = str(tmp_path / "weight_update")
    meta = WeightUpdateMeta(type="disk", path=root)
    for version in (1, 2, 3):
        ta.set_version(version)
        ta.update_weights(meta)
    assert sorted(os.listdir(root)) == ["v2", "v3"]  # the newest two kept, no temp dirs
    snap = os.path.join(root, "v3")
    saved = dict(safetensors_io.iter_safetensors(snap))
    for n, p in ta.model.state_dict().items():
        assert torch.equal(saved[n], p.to(torch.bfloat16)), n

    gen_cfg = tiny_config(eos_token_id=None)
    fresh = GenEngine(gen_cfg, model_path=snap, n_slots=4, max_seq_len=64, prompt_bucket=16,
                      kv_dtype="float32", device="cpu")
    want = _greedy(fresh)

    def stale():
        return GenEngine(gen_cfg, n_slots=4, max_seq_len=64, prompt_bucket=16,
                         kv_dtype="float32", seed=1, device="cpu")

    eng = stale()
    assert _greedy(eng) != want  # random weights: another policy
    assert eng.load_weights(path=root) == 3  # the newest snapshot, its version
    assert _greedy(eng) == want

    eng = stale()
    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(eng,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    try:
        port = box["httpd"].port
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/update_weights_from_disk", {"version": 2})
        assert err.value.code == 400  # no path: refused, nothing queued
        out = _post(port, "/update_weights_from_disk", {"path": root, "version": 2})
        assert out == {"ok": True, "version": 2}  # a pinned version loads exactly v2
        out = _post(port, "/update_weights_from_disk", {"path": root})
        assert out == {"ok": True, "version": 3}
        streams = []
        rng = np.random.default_rng(7)
        for i in range(3):
            body = {"input_ids": rng.integers(0, 512, 6 + i).tolist(),
                    "sampling_params": {"max_new_tokens": 6, "temperature": 0.0}}
            res = _post(port, "/generate", body)
            assert res["version"] == 3
            streams.append(res["output_tokens"])
        assert streams == want
    finally:
        box["httpd"].shutdown()
        t.join(30)


def test_failed_reload_keeps_the_served_weights(tmp_path):
    """A snapshot that does not fit the served model raises, and the engine
    goes on serving its old weights at its old version."""
    gen_cfg = tiny_config(eos_token_id=None)
    eng = GenEngine(gen_cfg, n_slots=4, max_seq_len=64, prompt_bucket=16,
                    kv_dtype="float32", seed=1, device="cpu")
    want, model, version = _greedy(eng), eng.model, eng.version
    save_hf_checkpoint(init_params(tiny_config(hidden_size=32), device="cpu"),
                       str(tmp_path / "v1"))
    with pytest.raises(ValueError, match="shape"):
        eng.load_weights(str(tmp_path))
    assert eng.model is model and eng.version == version
    assert _greedy(eng) == want
