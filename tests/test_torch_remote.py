"""The port's remote client (`areal_tpu_torch/core/remote.py`,
`engine/torch_remote.py`) against `tests/fake_server.py`, beside the JAX
package's `RemoteJaxEngine`.

The behaviours of `tests/test_remote_engine.py` run for both clients in one
parametrised test each: basic generation, the length cap, interruption
resumes with per-token versions, chunked generation, update_weights and
the version, failover to a surviving server, `TrajectoryLostError` after
the failover budget (and the executor settling it), rollout_batch,
prepare_batch under the staleness gate, should_accept, and the payload
against the server contract.  Then both clients must return equal
responses on the same fake servers, and the port's client must really
hold `max_concurrent_rollouts` requests in flight together.  The fake
server's answers are exact, so every comparison is exact.  Last, a server
the launch helper started exits when its caller is killed.
"""

import asyncio
import os
import subprocess
import sys
import textwrap
import threading
import time
import types

import pytest

from areal_tpu_torch.scripts.bench_e2e_grpo import _reward_any_even

from tests.fake_server import FakeGenServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMPLS = ("jax", "torch")
COMPLETION = list(range(100, 110))


def _pkg(impl: str):
    """The classes a client test needs, from one package."""
    if impl == "jax":
        from areal_tpu.api import config, io_struct
        from areal_tpu.core.executor import TrajectoryLostError
        from areal_tpu.engine.jax_remote import JaxBackend as Backend
        from areal_tpu.engine.jax_remote import RemoteJaxEngine as Engine
        from areal_tpu.utils.dataloader import StatefulDataLoader
        from areal_tpu.workflow.rlvr import RLVRWorkflow
    else:
        from areal_tpu_torch.api import config, io_struct
        from areal_tpu_torch.core.executor import TrajectoryLostError
        from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine as Engine
        from areal_tpu_torch.engine.torch_remote import TorchBackend as Backend
        from areal_tpu_torch.utils.dataloader import StatefulDataLoader
        from areal_tpu_torch.workflow.rlvr import RLVRWorkflow
    return types.SimpleNamespace(
        Engine=Engine, Backend=Backend, Config=config.InferenceEngineConfig,
        Gen=config.GenerationHyperparameters, Req=io_struct.ModelRequest,
        Meta=io_struct.WeightUpdateMeta, Lost=TrajectoryLostError,
        Loader=StatefulDataLoader, RLVR=RLVRWorkflow)


def _engine(pkg, addr, **cfg_kwargs):
    cfg = dict(consumer_batch_size=2, max_concurrent_rollouts=16, request_timeout=10)
    cfg.update(cfg_kwargs)
    eng = pkg.Engine(pkg.Config(**cfg))
    eng.initialize(addr=addr)
    return eng


def _agen(eng, req):
    return asyncio.run(eng.agenerate(req))


@pytest.fixture
def server():
    s = FakeGenServer(completion=list(COMPLETION), chunk_size=1024)
    addr = s.start()
    yield s, addr
    s.stop()


def _generate(pkg, addr, **gen):
    eng = _engine(pkg, addr)
    try:
        return _agen(eng, pkg.Req(rid="r0", input_ids=[7, 8],
                                  gconfig=pkg.Gen(**dict(dict(max_new_tokens=64), **gen))))
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_basic_generation(server, impl):
    s, addr = server
    resp = _generate(_pkg(impl), addr, max_new_tokens=32)
    assert resp.output_tokens == COMPLETION
    assert resp.stop_reason == "stop"
    assert resp.output_versions == [0] * 10
    assert len(resp.output_logprobs) == 10
    assert resp.input_tokens == [7, 8]


@pytest.mark.parametrize("impl", IMPLS)
def test_length_cap(server, impl):
    s, addr = server
    resp = _generate(_pkg(impl), addr, max_new_tokens=4)
    assert resp.output_tokens == [100, 101, 102, 103]
    assert resp.stop_reason == "length"


@pytest.mark.parametrize("impl", IMPLS)
def test_interruption_resumes_and_tracks_versions(server, impl):
    """An abort mid-generation: the client resends the accumulated tokens,
    and the tokens after it carry the new version."""
    s, addr = server
    s.abort_once = True
    resp = _generate(_pkg(impl), addr)
    assert resp.output_tokens == COMPLETION
    assert resp.stop_reason == "stop"
    assert resp.output_versions[0] == 0 and resp.output_versions[-1] == 1
    assert len(set(resp.output_versions)) == 2
    assert len(s.requests) >= 2
    assert s.requests[-1]["input_ids"][:2] == [7, 8]
    assert 100 in s.requests[-1]["input_ids"]
    # the resubmission shrinks the budget by what was generated
    done = len(s.requests[-1]["input_ids"]) - 2
    assert s.requests[-1]["sampling_params"]["max_new_tokens"] == 64 - done


@pytest.mark.parametrize("impl", IMPLS)
def test_chunked_generation(server, impl):
    s, addr = server
    s.chunk_size = 3  # three tokens per call, "abort" after each chunk
    resp = _generate(_pkg(impl), addr, max_new_tokens=100)
    assert resp.output_tokens == COMPLETION
    assert len(s.requests) == 4  # ceil(10 / 3)


@pytest.mark.parametrize("impl", IMPLS)
def test_update_weights_and_version(server, impl):
    s, addr = server
    pkg = _pkg(impl)
    eng = _engine(pkg, addr)
    try:
        eng.pause_generation()
        assert s.paused
        eng.update_weights(pkg.Meta(type="disk", path="fake_ckpt"))
        eng.set_version(eng.get_version() + 1)
        eng.continue_generation()
        assert not s.paused
        assert s.weight_updates == [{"path": "fake_ckpt"}]
        assert eng.get_version() == 1 and s.version == 1
        # a transfer publish is the trainer's: the client sends nothing
        eng.update_weights(pkg.Meta(type="transfer"))
        assert len(s.weight_updates) == 1
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_failover_resubmits_to_surviving_server(impl):
    """One of two backends dies mid chunked generation: the client
    resubmits the accumulated tokens to the survivor and the trajectory
    completes."""
    pkg = _pkg(impl)
    s0 = FakeGenServer(completion=list(COMPLETION), chunk_size=3)
    s1 = FakeGenServer(completion=list(COMPLETION), chunk_size=3)
    s0.delay_s = 0.05  # keep chunks in flight long enough to die mid-run
    addrs = [s0.start(), s1.start()]
    eng = _engine(pkg, addrs, request_retries=2)

    def _assassin():
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not s0.requests:
            time.sleep(0.005)
        s0.stop()

    killer = threading.Thread(target=_assassin)
    killer.start()
    try:
        # round_robin places the first rid on s0
        resp = _agen(eng, pkg.Req(rid="victim", input_ids=[1, 2],
                                  gconfig=pkg.Gen(max_new_tokens=64)))
        killer.join(timeout=10)
        assert resp.output_tokens == COMPLETION
        assert resp.stop_reason == "stop"
        assert s1.requests
        assert s1.requests[-1]["input_ids"][:2] == [1, 2]
        assert 100 in s1.requests[-1]["input_ids"]
    finally:
        eng.destroy()
        s1.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_trajectory_lost_after_failover_budget(impl):
    """Every server dead and the failover budget spent: agenerate raises
    TrajectoryLostError, not a transport error."""
    pkg = _pkg(impl)
    s = FakeGenServer(completion=[100])
    addr = s.start()
    s.stop()  # dead before the first request: connection refused
    eng = _engine(pkg, addr, request_retries=1, failover_retries=2)
    try:
        with pytest.raises(pkg.Lost):
            _agen(eng, pkg.Req(rid="doomed", input_ids=[1], gconfig=pkg.Gen(max_new_tokens=4)))
        # the executor settles a lost trajectory and carries on
        wf = pkg.RLVR(reward_fn=_reward_any_even, gconfig=pkg.Gen(max_new_tokens=4))
        eng.submit({"input_ids": [1]}, workflow=wf)
        deadline = time.monotonic() + 30
        while eng.executor.lost_trajectories == 0 and time.monotonic() < deadline:
            with pytest.raises(TimeoutError):
                eng.wait(1, timeout=0.2)
        assert eng.executor.lost_trajectories == 1
        st = eng.executor.staleness_manager.get_stats()
        assert (st.submitted, st.accepted, st.rejected, st.running) == (1, 0, 1, 0)
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_rollout_batch_end_to_end(server, impl):
    s, addr = server
    pkg = _pkg(impl)
    eng = _engine(pkg, addr)
    try:
        wf = pkg.RLVR(reward_fn=_reward_any_even,
                      gconfig=pkg.Gen(max_new_tokens=16, n_samples=2))
        batch = eng.rollout_batch([{"input_ids": [1, 2]}, {"input_ids": [3, 4, 5]}],
                                  workflow=wf)
        assert batch["input_ids"].shape[0] == 4  # 2 prompts x 2 samples
        assert batch["rewards"].tolist() == [1.0] * 4
        assert batch["attention_mask"].shape == batch["loss_mask"].shape
        lens = batch["attention_mask"].sum(-1)
        for i in range(4):
            assert batch["loss_mask"][i, :int(lens[i])].sum() == 10
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_prepare_batch_async(server, impl):
    s, addr = server
    pkg = _pkg(impl)
    eng = _engine(pkg, addr, max_head_offpolicyness=2)
    try:
        wf = pkg.RLVR(reward_fn=_reward_any_even, gconfig=pkg.Gen(max_new_tokens=8))
        dl = pkg.Loader([{"input_ids": [i]} for i in range(32)], batch_size=2)
        b1 = eng.prepare_batch(dl, workflow=wf)
        b2 = eng.prepare_batch(dl, workflow=wf)
        assert b1["input_ids"].shape[0] == b2["input_ids"].shape[0] == 2
        # the staleness gate bounds submissions: (eta + version + 1) * batch
        assert eng.executor.staleness_manager.get_stats().submitted <= 6
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_should_accept_filter(server, impl):
    s, addr = server
    pkg = _pkg(impl)
    eng = _engine(pkg, addr)
    try:
        wf = pkg.RLVR(reward_fn=_reward_any_even, gconfig=pkg.Gen(max_new_tokens=4))
        calls = {"n": 0}

        def accept_second_half(traj):
            calls["n"] += 1
            return calls["n"] > 2

        for i in (1, 2, 3):
            eng.submit({"input_ids": [i]}, workflow=wf, should_accept=accept_second_half)
        assert eng.wait(1, timeout=10)["input_ids"].shape[0] == 1
    finally:
        eng.destroy()


@pytest.mark.parametrize("impl", IMPLS)
def test_generation_payload_matches_server_contract(impl):
    """The client ships exactly the sampling keys the servers read, and
    both backends build the same wire body."""
    pkg = _pkg(impl)
    req = pkg.Req(rid="contract-0", input_ids=[1, 2, 3],
                  gconfig=pkg.Gen(max_new_tokens=4, greedy=True, stop_token_ids=[5]))
    http = pkg.Backend().build_generation_request(req)
    assert http.endpoint == "/generate"
    assert set(http.payload["sampling_params"]) == {
        "max_new_tokens", "min_new_tokens", "temperature", "top_p", "top_k",
        "stop_token_ids"}
    ref = _pkg("jax").Backend().build_generation_request(
        _pkg("jax").Req(rid="contract-0", input_ids=[1, 2, 3], gconfig=_pkg("jax").Gen(
            max_new_tokens=4, greedy=True, stop_token_ids=[5])))
    assert http.payload == ref.payload


def test_vlm_request_raises():
    from areal_tpu_torch.api.io_struct import ModelRequest
    from areal_tpu_torch.engine.torch_remote import TorchBackend

    with pytest.raises(NotImplementedError):
        TorchBackend().build_generation_request(ModelRequest(input_ids=[1], pixel_values=[0]))


@pytest.mark.parametrize("case", ["basic", "length", "interrupt", "chunked"])
def test_both_clients_return_equal_responses(case):
    out = {}
    for impl in IMPLS:
        s = FakeGenServer(completion=list(COMPLETION), chunk_size=3 if case == "chunked" else 1024)
        s.abort_once = case == "interrupt"
        addr = s.start()
        try:
            r = _generate(_pkg(impl), addr, max_new_tokens=4 if case == "length" else 64)
            out[impl] = ((r.input_tokens, r.output_tokens, r.output_logprobs,
                          r.output_versions, r.stop_reason), s.requests)
        finally:
            s.stop()
    assert out["torch"] == out["jax"]


class _CountingServer(FakeGenServer):
    """Holds each /generate call until `want` calls are held at once (or
    10 s pass), and records the most it held."""

    def __init__(self, want, **kw):
        super().__init__(**kw)
        self.want = want
        self.now = self.peak = 0

    async def _generate(self, request):
        self.now += 1
        self.peak = max(self.peak, self.now)
        deadline = time.monotonic() + 10
        while self.peak < self.want and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        try:
            return await super()._generate(request)
        finally:
            self.now -= 1


def test_max_concurrent_rollouts_are_in_flight_together():
    """40 rollouts, above asyncio's default pool of min(32, cpus + 4)
    threads: the server holds all 40 requests at once."""
    from areal_tpu_torch.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    n = 40
    s = _CountingServer(n, completion=[100, 101])
    addr = s.start()
    eng = RemoteTorchEngine(InferenceEngineConfig(
        consumer_batch_size=n, max_concurrent_rollouts=n, request_timeout=30))
    eng.initialize(addr=addr)
    try:
        wf = RLVRWorkflow(reward_fn=_reward_any_even,
                          gconfig=GenerationHyperparameters(max_new_tokens=2))
        batch = eng.rollout_batch([{"input_ids": [i]} for i in range(n)], workflow=wf)
        assert batch["input_ids"].shape[0] == n
        assert s.peak == n
    finally:
        eng.destroy()
        s.stop()


def _alive(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_launched_server_exits_when_its_caller_is_killed(tmp_path):
    """A caller killed before `stop_all` leaves no server behind: the
    launch helper starts servers with --exit-with-parent."""
    code = textwrap.dedent(f"""
        import sys
        from areal_tpu_torch.api.config import GenServerConfig
        from areal_tpu_torch.launcher.local import LocalLauncher
        launcher = LocalLauncher({str(tmp_path)!r})
        launcher.start_gen_servers(GenServerConfig(dtype="float32", max_seqs=2,
                                                   max_context_len=128),
                                   device="cpu", timeout=120)
        print(launcher.procs[0].pid, flush=True)
        sys.stdin.read()
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    caller = subprocess.Popen([sys.executable, "-c", code], cwd=repo, text=True,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        pid = int(caller.stdout.readline())
        assert _alive(pid)
    finally:
        caller.kill()
        caller.wait(30)
    deadline = time.monotonic() + 30
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not _alive(pid)
