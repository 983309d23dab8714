"""The port's generation server (`areal_tpu_torch/gen/server.py`) as a
process of its own, started by the port's launch helper, against the JAX
package's `GenServer` on the same weights.

- The unchanged JAX client (`RemoteJaxEngine`) drives the port's server:
  generation, a GRPO rollout batch, pause/continue and a disk reload.
- Greedy streams from the port's server, driven by the port's client,
  equal the JAX server's on the same params (carried over by
  `models/convert.py`), before and after transfer publishes from the
  port's trainer with a live and with an aborting commit (both servers at
  the engine's defaults, so both reuse a prompt's retained prefix across a
  publish); the trainer's
  chunks go to both servers, and the JAX server then serves exactly the
  trainer's bf16 cast.  Tokens must be equal; logprobs agree to 1e-4 (f32
  forwards in another op order, as in test_torch_engine.py).
- The transfer protocol's refusals and idempotent commit retry, and
  `/metrics`.
- A server whose decode step fails answers 500, and both clients raise
  `TrajectoryLostError` after `failover_retries` (bounded by a timeout,
  so a resubmit loop fails instead of hanging).
- A burst of 64 clients connecting at once is served without resets.
- `gpu`: the server process on the card, a transfer publish, and streams
  bit-equal to a `GenEngine` on the published weights in this process.
"""

import asyncio
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import GenServerConfig
from areal_tpu_torch.launcher.local import LocalLauncher, find_free_port
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.models.model_config import tiny_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
SLOTS, SEQ, PAGE = 4, 256, 16
CHUNK = 8  # decode steps per dispatch: the port server's default
PROMPTS = [np.random.default_rng(i).integers(0, 97, 5 + 7 * i).tolist() for i in range(3)]


def _jax_tree(seed):
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    tree = jax.tree_util.tree_map(np.asarray, jax_init(jax_tiny(**KW), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 10)
    for k in ("bq", "bk", "bv"):
        tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(
            tree["layers"]["attn"][k].shape)).astype(np.float32)
    return tree


def _jax_server(tree):
    """The JAX GenServer over aiohttp on a thread -> (engine, server, addr, stop)."""
    from aiohttp import web

    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.server import GenServer as JaxServer
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    # the engine's admission defaults (prefix reuse, group fan-out), which
    # both servers run: a prompt seen before a publish reuses its retained
    # old-weight K/V on either server
    engine = JaxEngine(jax_tiny(**KW), params=tree, ragged_attn=True, decode_chunk=CHUNK,
                       n_slots=SLOTS, max_seq_len=SEQ, prompt_bucket=PAGE, kv_dtype="float32")
    server = JaxServer(engine)
    server.start()
    port = find_free_port()
    loop = asyncio.new_event_loop()
    up = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(server.app())
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        up.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert up.wait(30)

    def stop():
        server.shutdown.set()
        server.worker.join(timeout=10)
        loop.call_soon_threadsafe(loop.stop)

    return engine, server, f"127.0.0.1:{port}", stop


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote_server")
    tree = _jax_tree(0)
    ckpt = str(root / "ckpt")
    save_hf_checkpoint(params_from_jax(tree, tiny_config(**KW), "cpu"), ckpt,
                       save_dtype="float32")
    launcher = LocalLauncher(str(root / "logs"))
    # one intra-op thread: the tiny server needs no more, and the test
    # workers beside it keep their cores
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        port_addr = launcher.start_gen_servers(
            GenServerConfig(model_path=ckpt, dtype="float32", max_seqs=SLOTS,
                            max_context_len=SEQ, page_size=PAGE, random_seed=0),
            device="cpu", timeout=180)[0]
    jengine, jserver, jax_addr, stop = _jax_server(tree)
    try:
        yield types.SimpleNamespace(root=root, ckpt=ckpt, tree=tree, port_addr=port_addr,
                                    jax_addr=jax_addr, jengine=jengine, jserver=jserver)
    finally:
        stop()
        launcher.stop_all()


def _http(addr, path, body=None, headers=None, data=None):
    """-> (status, JSON body); HTTP errors return their status too."""
    if data is None and body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(f"http://{addr}{path}", data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _client(impl, addr, **cfg):
    if impl == "jax":
        from areal_tpu.api.config import InferenceEngineConfig
        from areal_tpu.engine.jax_remote import RemoteJaxEngine as Engine
    else:
        from areal_tpu_torch.api.config import InferenceEngineConfig
        from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine as Engine
    eng = Engine(InferenceEngineConfig(**dict(dict(
        consumer_batch_size=2, max_concurrent_rollouts=8, request_timeout=60), **cfg)))
    eng.initialize(addr=addr)
    return eng


def _greedy(impl, addr, max_new_tokens=12):
    """Greedy (tokens, logprobs) of PROMPTS through one package's client."""
    if impl == "jax":
        from areal_tpu.api.config import GenerationHyperparameters as Gen
        from areal_tpu.api.io_struct import ModelRequest as Req
    else:
        from areal_tpu_torch.api.config import GenerationHyperparameters as Gen
        from areal_tpu_torch.api.io_struct import ModelRequest as Req
    eng = _client(impl, addr)
    try:
        out = []
        for i, ids in enumerate(PROMPTS):
            r = asyncio.run(eng.agenerate(Req(rid=f"g{i}", input_ids=list(ids), gconfig=Gen(
                max_new_tokens=max_new_tokens, greedy=True))))
            out.append((r.output_tokens, np.asarray(r.output_logprobs), r.output_versions))
        return out
    finally:
        eng.destroy()


def _assert_streams_equal(got, want):
    for (tg, lg, vg), (tw, lw, vw) in zip(got, want):
        assert tg == tw
        assert vg == vw
        np.testing.assert_allclose(lg, lw, atol=ATOL, rtol=0)


def test_jax_client_drives_the_port_server(fleet):
    from areal_tpu.api.config import GenerationHyperparameters as JaxGen
    from areal_tpu.api.io_struct import WeightUpdateMeta as JaxMeta
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    from areal_tpu_torch.scripts.bench_e2e_grpo import _reward_any_even

    # the JAX client gets the port client's streams from the port server
    _assert_streams_equal(_greedy("jax", fleet.port_addr), _greedy("torch", fleet.port_addr))
    eng = _client("jax", fleet.port_addr)
    try:
        wf = JaxRLVR(reward_fn=_reward_any_even,
                     gconfig=JaxGen(n_samples=2, max_new_tokens=6))
        batch = eng.rollout_batch([{"input_ids": p} for p in PROMPTS[:2]], workflow=wf)
        assert batch["input_ids"].shape[0] == 4
        assert (batch["loss_mask"].sum(-1) == 6).all()
        eng.pause_generation()
        assert _http(fleet.port_addr, "/health")[1]["status"] == "paused"
        eng.continue_generation()
        assert _http(fleet.port_addr, "/health")[1]["status"] == "ok"
        # a disk reload of the same weights, as a trainer's snapshot v0
        save_hf_checkpoint(params_from_jax(fleet.tree, tiny_config(**KW), "cpu"),
                           str(fleet.root / "snap" / "v0"), save_dtype="float32")
        eng.update_weights(JaxMeta(type="disk", path=str(fleet.root / "snap")))
        assert _http(fleet.port_addr, "/health")[1]["version"] == 0
    finally:
        eng.destroy()


def _actor(ckpt):
    from areal_tpu_torch.api.config import OptimizerConfig, PPOActorConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    actor = TorchPPOActor(PPOActorConfig(path=ckpt, dtype="float32", param_dtype="float32",
                                         gradient_checkpointing=False,
                                         optimizer=OptimizerConfig()), device="cpu")
    actor.initialize(ft_spec=FinetuneSpec(1, 16, 4))
    return actor


def _jax_served(jengine):
    """The JAX server's weights as HF-named f32 tensors."""
    import jax

    from areal_tpu_torch.models.convert import jax_tree_to_hf

    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jengine.params)
    return dict(jax_tree_to_hf(tree, tiny_config(**KW)))


def test_streams_match_the_jax_server_across_transfer_publishes(fleet, monkeypatch):
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta

    _assert_streams_equal(_greedy("torch", fleet.port_addr), _greedy("torch", fleet.jax_addr))
    actor = _actor(fleet.ckpt)
    monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", f"{fleet.port_addr},{fleet.jax_addr}")
    gen = torch.Generator().manual_seed(0)
    for version, live in ((1, True), (2, False)):
        with torch.no_grad():
            for p in actor.model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        actor.set_version(version)
        meta = WeightUpdateMeta.from_transfer(chunk_mb=1, live_commit=live)
        actor.stage_weights(meta)
        # staged on both servers, swapped on neither
        m = _http(fleet.port_addr, "/metrics")[1]
        assert m["staged"] and m["version"] == version - 1
        assert fleet.jengine.has_standby and fleet.jengine.version == version - 1
        actor.update_weights(meta)
        assert _http(fleet.port_addr, "/metrics")[1]["version"] == version
        assert fleet.jengine.version == version
        # the port trainer's bytes, assembled by the JAX server
        served = _jax_served(fleet.jengine)
        for name, p in actor.model.named_parameters():
            assert torch.equal(served[name], p.detach().to(torch.bfloat16).float()), name
        got = _greedy("torch", fleet.port_addr)
        _assert_streams_equal(got, _greedy("torch", fleet.jax_addr))
        assert all(v == [version] * len(v) for _, _, v in got)


def test_transfer_protocol_refusals_and_metrics(fleet):
    import base64

    addr = fleet.port_addr
    assert _http(addr, "/update_weights_chunk", {"prepare": True, "version": 9})[0] == 409
    assert _http(addr, "/update_weights_chunk", {"commit": True, "version": 9})[0] == 409
    # a commit retried after its response was lost: that version is live
    version = _http(addr, "/metrics")[1]["version"]
    status, body = _http(addr, "/update_weights_chunk", {"commit": True, "version": version})
    assert status == 200 and body["version"] == version
    # the JSON form of a chunk is accepted, and a later prepare assembles it
    # (here it is incomplete, so the assembly refuses and nothing is staged)
    raw = torch.zeros(4, dtype=torch.bfloat16).view(torch.uint8).numpy().tobytes()
    status, _ = _http(addr, "/update_weights_chunk", {
        "name": "model.norm.weight", "dtype": "bfloat16", "shape": [4], "nbytes": len(raw),
        "offset": 0, "data_b64": base64.b64encode(raw).decode()})
    assert status == 200
    assert _http(addr, "/update_weights_chunk", {"prepare": True})[0] == 500
    m = _http(addr, "/metrics")[1]
    assert {"decode_steps", "decode_calls", "tokens_generated", "active", "version",
            "last_pause_s", "staged", "ragged_dispatches", "ragged_attended_pages",
            "ragged_kernel_launches", "ragged_verify_launches"} <= set(m)
    assert m["decode_steps"] > 0 and m["tokens_generated"] > 0 and not m["staged"]
    # the CPU runs the plain version
    assert m["ragged_kernel_launches"] == m["ragged_verify_launches"] == 0


@pytest.mark.parametrize("impl", ["torch", "jax"])
def test_failed_decode_step_answers_500_and_loses_the_trajectory(impl):
    from areal_tpu_torch.gen import server
    from areal_tpu_torch.gen.engine import GenEngine
    from areal_tpu_torch.models.transformer import init_params

    if impl == "jax":
        from areal_tpu.api.config import GenerationHyperparameters as Gen
        from areal_tpu.api.io_struct import ModelRequest as Req
        from areal_tpu.core.executor import TrajectoryLostError as Lost
    else:
        from areal_tpu_torch.api.config import GenerationHyperparameters as Gen
        from areal_tpu_torch.api.io_struct import ModelRequest as Req
        from areal_tpu_torch.core.executor import TrajectoryLostError as Lost

    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=SLOTS, max_seq_len=SEQ,
                       prompt_bucket=PAGE, kv_dtype="float32", device="cpu")
    calls = {"n": 0}
    submit_batch = engine.submit_batch

    def counted_submit(reqs):
        calls["n"] += len(reqs)
        submit_batch(reqs)

    def broken_step(*a, **kw):
        engine._admit()
        if engine.active_count() == 0:
            return 0
        raise RuntimeError("injected decode failure")

    engine.submit_batch = counted_submit
    engine.step = broken_step
    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    addr = f"127.0.0.1:{box['httpd'].port}"
    try:
        status, body = _http(addr, "/generate", {"input_ids": [1, 2, 3],
                                                 "sampling_params": {"max_new_tokens": 4}})
        assert status == 500 and "decode step failed" in body["error"]
        eng = _client(impl, addr, request_retries=1, failover_retries=2)
        try:
            before = calls["n"]
            with pytest.raises(Lost):
                asyncio.run(asyncio.wait_for(eng.agenerate(Req(
                    rid="x", input_ids=[1, 2, 3], gconfig=Gen(max_new_tokens=4))), timeout=60))
            assert calls["n"] - before == 3  # the first try and 2 failovers
        finally:
            eng.destroy()
    finally:
        box["httpd"].shutdown()
        t.join(30)


def test_a_burst_of_clients_is_served_without_resets():
    """64 clients connect at once (a GRPO rollout opens one connection per
    sample): every /generate is answered.  With socketserver's default
    listen backlog of 5 about half of them were reset."""
    from areal_tpu_torch.gen import server
    from areal_tpu_torch.gen.engine import GenEngine
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.utils.http import request_with_retry

    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=SLOTS, max_seq_len=SEQ,
                       prompt_bucket=PAGE, kv_dtype="float32", device="cpu")
    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    addr = f"127.0.0.1:{box['httpd'].port}"
    n = 64
    barrier, errors, done = threading.Barrier(n), [], []

    def client():
        barrier.wait()
        try:
            r = request_with_retry(addr, "/generate", {"input_ids": [1, 2, 3], "sampling_params": {
                "max_new_tokens": 2}}, max_retries=1, timeout=120, idempotent=False)
            done.append(len(r["output_tokens"]))
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:3]
        assert done == [2] * n
    finally:
        box["httpd"].shutdown()
        t.join(30)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_server_process_on_the_card_serves_the_published_weights(cuda_device, tmp_path,
                                                                 monkeypatch):
    """A bf16 server process on the card, one transfer publish from a
    trainer here (f32 masters), then greedy streams and logprobs from the
    server bit-equal to a GenEngine here on the trainer's bf16 export."""
    from areal_tpu_torch.api.config import OptimizerConfig, PPOActorConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.engine.ppo import TorchPPOActor
    from areal_tpu_torch.gen.engine import GenEngine, GenRequest
    from areal_tpu_torch.models.transformer import init_params

    cfg = tiny_config(vocab_size=512, hidden_size=256, num_heads=2, num_kv_heads=1,
                      head_dim=128, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                      eos_token_id=None, dtype="bfloat16")
    ckpt = str(tmp_path / "ckpt")
    save_hf_checkpoint(init_params(cfg, 0, "cuda", param_dtype="float32"), ckpt,
                       save_dtype="bfloat16")
    with LocalLauncher(str(tmp_path / "logs")) as launcher:
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=ckpt, dtype="bfloat16", max_seqs=SLOTS, max_context_len=SEQ,
            page_size=128, random_seed=0), timeout=300)[0]
        actor = TorchPPOActor(PPOActorConfig(path=ckpt, dtype="bfloat16",
                                             optimizer=OptimizerConfig()), model_config=cfg)
        actor.initialize(ft_spec=FinetuneSpec(1, 16, 4))
        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            for p in actor.model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
        actor.set_version(1)
        actor.update_weights(WeightUpdateMeta.from_transfer(chunk_mb=1))
        local = GenEngine(cfg, params=actor.export_device_params(), n_slots=SLOTS,
                          max_seq_len=SEQ, prompt_bucket=128, kv_dtype="bfloat16", seed=0)
        for i, ids in enumerate(PROMPTS):
            status, r = _http(addr, "/generate", {"rid": f"c{i}", "input_ids": ids,
                                                  "sampling_params": {"max_new_tokens": 16,
                                                                      "temperature": 0.0}})
            req = GenRequest(rid=f"c{i}", input_ids=ids, max_new_tokens=16, temperature=0.0)
            local.generate_blocking([req])
            assert status == 200 and r["version"] == 1
            assert r["output_tokens"] == req.output_tokens
            assert r["output_logprobs"] == req.output_logprobs
