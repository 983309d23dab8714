"""The port's router (`areal_tpu_torch/gen/router.py`) and health checker
(`gen/health.py`) on the CPU.

- Parity: the port's `Router` and `areal_tpu.gen.router.Router` driven by
  one sequence over the same fake backends (`tests/fake_server.py`):
  sequential /generate calls with rids and group ids under each policy,
  then the gate (allocate, finish, set_version, a TTL-expired lease).  The
  same backend for every request; the same status, lease and capacity for
  every gate call.
- The reference's router behaviours (tests/test_router.py) against the
  port's router: policies and affinity, least_tokens, the gate, a manual
  update flushing the fleet, the checkpoint watcher, the transfer-mode
  version sources, two port clients sharing one budget, lease TTL expiry,
  cached health with the breaker, drain, and the disaggregated legs (the
  two-leg merge, an empty role pool served colocated, a failed import
  continued on the prefill server, a request finished in leg 1, group
  affinity to one prefill server, the decode pick by occupancy).
- The breaker alone: open after the threshold with one `on_death`; a
  half-open backend at a stale version force-reloaded before it closes.
- The client's gate (`FleetStalenessGate`, the executor's `fleet_gate`):
  an episode that raises returns its lease; an unreachable router
  degrades the gate to a no-op, and a lease granted before still goes
  back.
- The slice: two port servers (tiny f32 weights carried over from a JAX
  `GenEngine`'s params) behind the port's router, all registered through
  name_resolve; the port's client finds the router there, and the JAX
  client goes through it too.  Greedy streams equal the JAX engine's
  (tokens exact, logprobs within 1e-4) before and after an
  /update_weights through the router from an HF checkpoint both packages
  load; every server then reports the new version and the tokens carry it.
- Disaggregated: a prefill and a decode port server behind the router;
  each merged stream equals the two-leg split on one engine.
- `gpu`: two server processes on the card behind the router process; a
  disk publish that the watcher picks up, then both servers' greedy
  streams bit-equal to a `GenEngine` on the published weights.

Probe intervals are at most 0.1 s and no test sleeps over a second.
"""

import asyncio
import concurrent.futures
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import health as port_health
from areal_tpu_torch.gen.router import Router, RouterConfig, RouterHTTPServer
from areal_tpu_torch.utils import name_resolve, names
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _fake(**kw):
    """tests/fake_server.py's aiohttp backend, imported when a test makes
    one: the card's machine, which runs this file's `gpu` test, has no
    aiohttp."""
    from tests.fake_server import FakeGenServer

    return FakeGenServer(**kw)


class PortRouterHarness:
    """The port's router on a thread, as its `serve` runs it."""

    def __init__(self, router: Router):
        self.router = router
        self.httpd = None
        self._thread = None

    def start(self) -> str:
        self.router.start()
        self.httpd = RouterHTTPServer(self.router, "127.0.0.1", 0)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return f"127.0.0.1:{self.httpd.port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)
        self.router.stop()


def _post(addr, endpoint, payload, expect_status=200):
    req = urllib.request.Request(f"http://{addr}{endpoint}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = json.loads(e.read() or b"{}")
        assert e.code == expect_status, (e.code, body)
        return e.code, body


def _get(addr, endpoint):
    with urllib.request.urlopen(f"http://{addr}{endpoint}", timeout=30) as resp:
        return json.loads(resp.read())


def _wait(cond, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


@pytest.fixture()
def fleet():
    servers = [_fake(completion=list(range(100, 104))) for _ in range(3)]
    addrs = [s.start() for s in servers]
    yield servers, addrs
    for s in servers:
        s.stop()


def _routed(cfg, addrs, servers, port=True):
    """A router (the port's or the JAX package's) on a thread -> (addr, stop)."""
    if port:
        h = PortRouterHarness(Router(cfg, addresses=addrs))
    else:
        from areal_tpu.gen.router import Router as JaxRouter
        from areal_tpu.gen.router import RouterConfig as JaxConfig
        from tests.test_router import RouterHarness

        h = RouterHarness(JaxRouter(JaxConfig(**vars(cfg)), addresses=addrs))
    return h.start(), h


# ---------------------------------------------------------------------------
# parity with the JAX router
# ---------------------------------------------------------------------------

# (rid, group_id) of each sequential /generate: fresh rids, repeats, groups
# whose members carry their own rids, and a repeat after other traffic
PLACEMENTS = [("r0", ""), ("r1", ""), ("r2", ""), ("r0", ""), ("g0-0", "g0"), ("g0-1", "g0"),
              ("r3", ""), ("g1-0", "g1"), ("g0-2", "g0"), ("r4", ""), ("g1-1", "g1"),
              ("r1", ""), ("r5", "")]


def _placements(raddr, servers):
    """The backend index that served each of PLACEMENTS, in order."""
    out = []
    for i, (rid, group) in enumerate(PLACEMENTS):
        before = [len(s.requests) for s in servers]
        body = {"rid": rid, "input_ids": list(range(1 + 3 * (i % 4))),
                "sampling_params": {"max_new_tokens": 4}}
        if group:
            body.update(group_id=group, group_n=3)
        status, resp = _post(raddr, "/generate", body)
        assert status == 200 and resp["output_tokens"]
        grew = [j for j, s in enumerate(servers) if len(s.requests) > before[j]]
        assert len(grew) == 1
        out.append(grew[0])
    return out


def _age(router, seconds=60.0):
    """Move every lease of a router (the port's or the JAX one) `seconds`
    into the past: its TTL expiry without a sleep."""
    router._running = {k: t - seconds for k, t in router._running.items()}


def _gate_sequence(raddr, router_version, age_leases):
    """(status, lease granted, capacity after) of each gate call."""
    out = []

    def record(status, resp):
        cap = _get(raddr, "/metrics")["capacity"]
        out.append((status, bool(resp.get("alloc_id")), cap, resp.get("version")))
        return resp

    leases = []
    for _ in range(5):  # (1 + 0 + 1) x 2 = 4 admissions at version 0
        status, resp = _post(raddr, "/allocate_request", {"qid": "q"}, expect_status=409)
        leases.append(record(status, resp).get("alloc_id"))
    record(*_post(raddr, "/finish_request", {"alloc_id": leases[0], "accepted": True}))
    record(*_post(raddr, "/finish_request", {"alloc_id": leases[1], "accepted": False}))
    record(*_post(raddr, "/allocate_request", {"qid": "q"}, expect_status=409))
    record(*_post(raddr, "/set_version", {"version": 1}))
    assert router_version() == 1
    late = record(*_post(raddr, "/allocate_request", {"qid": "q"}))["alloc_id"]
    age_leases()  # past alloc_ttl: every lease so far is reclaimed
    record(*_post(raddr, "/finish_request", {"alloc_id": late, "accepted": True}))
    for _ in range(2):
        record(*_post(raddr, "/allocate_request", {"qid": "q"}))
    record(*_post(raddr, "/finish_request", {"accepted": True}))  # no lease id: the oldest
    return out


@pytest.mark.parametrize("policy", ["round_robin", "least_requests", "least_tokens"])
def test_placement_and_gate_match_the_jax_router(fleet, policy):
    servers, addrs = fleet
    got = {}
    for port in (False, True):
        for s in servers:
            s.requests.clear()
        cfg = RouterConfig(schedule_policy=policy, train_batch_size=2,
                           max_head_offpolicyness=1, alloc_ttl=30.0,
                           health_check_interval=0, version_poll_interval=0)
        raddr, h = _routed(cfg, addrs, servers, port=port)
        try:
            got[port] = (_placements(raddr, servers),
                         _gate_sequence(raddr, lambda: h.router.version,
                                        lambda: _age(h.router)))
            got[port] += (_get(raddr, "/metrics")["requests_routed"],)
        finally:
            h.stop()
    assert got[True] == got[False]
    placed = got[True][0]
    # a repeated rid and every member of a group stay on one backend
    for key in ("r0", "r1", "g0", "g1"):
        where = {placed[i] for i, (rid, g) in enumerate(PLACEMENTS) if key in (rid, g)}
        assert len(where) == 1, (key, where)
    statuses = [s for s, *_ in got[True][1]]
    assert statuses[:5] == [200, 200, 200, 200, 409]


# ---------------------------------------------------------------------------
# the reference's router behaviours, against the port's router
# ---------------------------------------------------------------------------

def test_routing_policies_and_affinity(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(schedule_policy="round_robin"), addrs, servers)
    try:
        for i in range(6):
            status, out = _post(raddr, "/generate", {
                "rid": f"r{i}", "input_ids": [1, 2, 3], "sampling_params": {"max_new_tokens": 16}})
            assert status == 200 and out["output_tokens"]
        counts = [len(s.requests) for s in servers]
        assert counts == [2, 2, 2], counts
        for _ in range(3):
            _post(raddr, "/generate", {"rid": "sticky", "input_ids": [5],
                                       "sampling_params": {"max_new_tokens": 16}})
        counts2 = [len(s.requests) - c for s, c in zip(servers, counts)]
        assert sorted(counts2) == [0, 0, 3], counts2
        metrics = _get(raddr, "/metrics")
        assert sum(metrics["requests_routed"].values()) == 9
        assert all(v == 0 for v in metrics["tokens_inflight"].values())
    finally:
        h.stop()


def test_least_tokens_balances_heterogeneous_load():
    servers = [_fake(completion=[7], chunk_size=1) for _ in range(2)]
    addrs = [s.start() for s in servers]
    for s in servers:
        s.delay_s = 2.0  # requests stay in flight, so their load is seen
    raddr, h = _routed(RouterConfig(schedule_policy="least_tokens"), addrs, servers)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=12)
    try:
        def gen(rid, n_tokens):
            return _post(raddr, "/generate", {"rid": rid, "input_ids": list(range(n_tokens)),
                                              "sampling_params": {"max_new_tokens": 1}})

        futs = [pool.submit(gen, "giant", 1000)]
        assert _wait(lambda: sum(len(s.requests) for s in servers) >= 1, 5, 0.01)
        futs += [pool.submit(gen, f"small-{i}", 10) for i in range(10)]
        for f in futs:
            status, out = f.result(timeout=30)
            assert status == 200 and out["output_tokens"]
        giant = next(i for i, s in enumerate(servers)
                     if any(len(r["input_ids"]) == 1000 for r in s.requests))
        # small requests avoid the token-loaded backend (a bound: on a loaded
        # machine a straggler may route after the giant finished)
        assert len(servers[1 - giant].requests) >= 8
        assert all(v == 0 for v in _get(raddr, "/metrics")["tokens_inflight"].values())
    finally:
        pool.shutdown(wait=True)
        h.stop()
        for s in servers:
            s.stop()


def test_global_staleness_gate(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(train_batch_size=2, max_head_offpolicyness=0,
                                    schedule_policy="round_robin"), addrs, servers)
    try:
        s1, r1 = _post(raddr, "/allocate_request", {"qid": "a"})
        s2, r2 = _post(raddr, "/allocate_request", {"qid": "b"})
        assert s1 == s2 == 200 and not r1["staled"] and not r2["staled"]
        s3, r3 = _post(raddr, "/allocate_request", {"qid": "c"}, expect_status=409)
        assert s3 == 409 and r3["staled"]
        _post(raddr, "/finish_request", {"qid": "a", "accepted": False})
        assert _post(raddr, "/allocate_request", {"qid": "c"})[0] == 200
        _post(raddr, "/finish_request", {"qid": "b", "accepted": True})
        assert _post(raddr, "/allocate_request", {"qid": "d"}, expect_status=409)[0] == 409
    finally:
        h.stop()


def test_manual_weight_update_flushes_fleet(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(), addrs, servers)
    try:
        status, out = _post(raddr, "/update_weights", {"path": "/dev/null/v7", "version": 7})
        assert status == 200 and out["version"] == 7
        for s in servers:
            assert [u["path"] for u in s.weight_updates] == ["/dev/null/v7"]
            assert s.paused is False  # resumed after the flush
        assert _get(raddr, "/health")["version"] == 7
        m = _get(raddr, "/metrics")
        assert m["n_flushes"] == 1 and m["last_flush_s"] > 0
        h.router.config.train_batch_size = 1  # (0 + 7 + 1) x 1 admissions
        for i in range(8):
            assert _post(raddr, "/allocate_request", {"qid": f"q{i}"})[0] == 200
        assert _post(raddr, "/allocate_request", {"qid": "over"}, expect_status=409)[0] == 409
    finally:
        h.stop()


def test_checkpoint_watcher_picks_up_trainer_publishes(fleet, tmp_path):
    servers, addrs = fleet
    cfg = RouterConfig(experiment_name="rtest-port", trial_name="t0",
                       weights_path=str(tmp_path), poll_interval=0.05)
    raddr, h = _routed(cfg, addrs, servers)
    key = names.update_weights_from_disk("rtest-port", "t0", 3)
    try:
        name_resolve.add(key, "123", replace=True)  # the trainer's disk publish key
        assert _wait(lambda: h.router.version >= 3)
        assert h.router.version == 3
        for s in servers:
            assert s.weight_updates and s.weight_updates[-1]["path"].endswith("/v3")
    finally:
        h.stop()
        name_resolve.delete(key)


def test_transfer_mode_version_sources_unwedge_gate(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(train_batch_size=1, max_head_offpolicyness=0,
                                    version_poll_interval=0.05), addrs, servers)
    try:
        s, r = _post(raddr, "/allocate_request", {"qid": "a"})
        assert s == 200
        _post(raddr, "/finish_request", {"alloc_id": r["alloc_id"], "accepted": True})
        assert _post(raddr, "/allocate_request", {"qid": "b"}, expect_status=409)[0] == 409
        # the trainer's /set_version after a transfer commit
        s, out = _post(raddr, "/set_version", {"version": 1})
        assert s == 200 and out["version"] == 1
        assert _post(raddr, "/allocate_request", {"qid": "b"})[0] == 200
        # the backends' served version, polled
        for srv in servers:
            srv.version = 5
        assert _wait(lambda: h.router.version >= 5)
        assert h.router.version == 5
    finally:
        h.stop()


def test_fleet_gate_two_clients_share_one_budget(fleet, monkeypatch):
    """Two port clients, each with a permissive local staleness limit,
    against a router that admits 4 at version 1: exactly 4 episodes run
    fleet-wide until an update raises the version."""
    from areal_tpu_torch.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import ModelRequest
    from areal_tpu_torch.api.workflow import RolloutWorkflow
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine

    servers, addrs = fleet
    router = Router(RouterConfig(train_batch_size=2, max_head_offpolicyness=0,
                                 schedule_policy="round_robin"), addresses=addrs)
    router.version = 1  # (0 + 1 + 1) x 2 = 4 admissions
    h = PortRouterHarness(router)
    raddr = h.start()
    monkeypatch.setenv("AREAL_GEN_ROUTER_ADDR", raddr)

    class _W(RolloutWorkflow):
        async def arun_episode(self, engine, data):
            resp = await engine.agenerate(ModelRequest(
                rid=str(data["query_id"]), input_ids=[1, 2, 3],
                gconfig=GenerationHyperparameters(max_new_tokens=8)))
            ids = [1, 2, 3] + resp.output_tokens
            return {"input_ids": np.array([ids], np.int32),
                    "attention_mask": np.ones((1, len(ids)), bool)}

    clients = []
    for i in range(2):
        c = RemoteTorchEngine(InferenceEngineConfig(
            experiment_name="fg", trial_name=f"c{i}", consumer_batch_size=4,
            max_concurrent_rollouts=16, max_head_offpolicyness=100, request_timeout=10))
        c.initialize(addr=raddr)  # generation goes through the router too
        assert c.executor.fleet_gate is not None
        c.executor.fleet_gate.poll_interval = 0.1
        clients.append(c)
    results = {}

    def run(idx):
        results[idx] = clients[idx].rollout_batch(
            [{"query_id": f"{idx}-{j}"} for j in range(4)], workflow=_W())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        assert _wait(lambda: _get(raddr, "/metrics")["accepted"] >= 4)
        time.sleep(0.5)  # the window an overshoot would need
        m = _get(raddr, "/metrics")
        assert m["accepted"] + m["running"] <= 4 and m["accepted"] == 4
        assert sum(c.executor.fleet_gate.n_staled for c in clients) > 0
        # version 3: (0 + 3 + 1) x 2 = 8, everything drains
        _post(raddr, "/update_weights", {"path": "/dev/null/v3", "version": 3})
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert results[0]["input_ids"].shape[0] == results[1]["input_ids"].shape[0] == 4
        m = _get(raddr, "/metrics")
        assert m["accepted"] == 8 and m["running"] == 0
    finally:
        for c in clients:
            c.destroy()
        h.stop()


def test_fleet_gate_returns_leases_on_errors_and_degrades(fleet, monkeypatch):
    """An episode that raises still returns its lease; a gate whose router
    is unreachable degrades to a no-op after `max_failures`, and a lease
    granted before that still goes back."""
    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.api.workflow import RolloutWorkflow
    from areal_tpu_torch.core.remote import FleetStalenessGate
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.utils.network import find_free_port

    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(train_batch_size=4, max_head_offpolicyness=0), addrs,
                       servers)
    monkeypatch.setenv("AREAL_GEN_ROUTER_ADDR", raddr)

    class _Boom(RolloutWorkflow):
        async def arun_episode(self, engine, data):
            raise ValueError("a workflow bug")

    c = RemoteTorchEngine(InferenceEngineConfig(consumer_batch_size=2, request_timeout=10))
    c.initialize(addr=raddr)
    try:
        with pytest.raises(RuntimeError, match="rollout task failed"):
            c.rollout_batch([{"query_id": "x"}], workflow=_Boom())
        assert _wait(lambda: _get(raddr, "/metrics")["running"] == 0)
        m = _get(raddr, "/metrics")
        assert m["accepted"] == 0 and m["capacity"] == 4

        gate = c.executor.fleet_gate
        lease = asyncio.run(gate.allocate("q"))
        assert lease and _get(raddr, "/metrics")["running"] == 1
        dead = FleetStalenessGate(f"127.0.0.1:{find_free_port()}", c._pool,
                                  poll_interval=0.01, max_failures=3)
        assert asyncio.run(dead.allocate("q")) is None and dead._disabled
        gate._disabled = True  # degraded: allocate is a no-op, finish is not
        assert asyncio.run(gate.allocate("q")) is None
        asyncio.run(gate.finish(lease, accepted=True))
        m = _get(raddr, "/metrics")
        assert m["running"] == 0 and m["accepted"] == 1
    finally:
        c.destroy()
        h.stop()


def test_lease_ttl_expiry_replaces_and_rejects_late_finish(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(train_batch_size=1, max_head_offpolicyness=0,
                                    alloc_ttl=30.0), addrs, servers)
    try:
        s, r1 = _post(raddr, "/allocate_request", {"qid": "a"})
        assert s == 200 and r1["alloc_id"]
        assert _post(raddr, "/allocate_request", {"qid": "b"}, expect_status=409)[0] == 409
        _age(h.router)  # client "a" stalls past the TTL
        s, r2 = _post(raddr, "/allocate_request", {"qid": "b"})
        assert s == 200, "an expired lease must be re-placeable"
        s, out = _post(raddr, "/finish_request", {"alloc_id": r1["alloc_id"], "accepted": True})
        assert s == 200 and out == {"ok": False, "expired": True}
        assert _get(raddr, "/metrics")["accepted"] == 0
        s, out = _post(raddr, "/finish_request", {"alloc_id": r2["alloc_id"], "accepted": True})
        assert s == 200 and out["ok"]
        assert _get(raddr, "/metrics")["accepted"] == 1
    finally:
        h.stop()


def test_health_cached_with_freshness_and_breaker_detection():
    from areal_tpu_torch.utils.telemetry import parse_prometheus_text

    servers = [_fake(completion=[100, 101]) for _ in range(2)]
    addrs = [s.start() for s in servers]
    raddr, h = _routed(RouterConfig(health_check_interval=0.1, health_failure_threshold=2,
                                    health_probe_timeout=0.5), addrs, servers)
    try:
        health = _get(raddr, "/health")
        assert health["status"] == "ok" and set(health["servers"]) == set(addrs)
        assert all(s["state"] == "closed" for s in health["servers"].values())
        assert health["freshness_s"] is not None
        servers[0].stop()

        def degraded():
            try:
                _get(raddr, "/health")
                return False
            except urllib.error.HTTPError:
                return True

        assert _wait(degraded, 10, 0.05)
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _get(raddr, "/health")
        assert exc_info.value.code == 503
        health = json.loads(exc_info.value.read())
        assert health["status"] == "degraded"
        assert health["servers"][addrs[0]]["state"] == "open"
        assert health["servers"][addrs[1]]["state"] == "closed"
        assert health["freshness_s"] < 5.0
        for i in range(4):  # new placements avoid the open backend
            s, out = _post(raddr, "/generate", {"rid": f"post-death-{i}", "input_ids": [1],
                                                "sampling_params": {"max_new_tokens": 4}})
            assert s == 200 and out["output_tokens"]
        assert len(servers[0].requests) == 0
        assert _get(raddr, "/metrics")["backend_states"][addrs[0]]["state"] == "open"
        with urllib.request.urlopen(f"http://{raddr}/metrics?format=prometheus",
                                    timeout=30) as resp:
            text = resp.read().decode()
        series = parse_prometheus_text(text)
        assert series["areal_router_backend_state"][f'{{server="{addrs[0]}"}}'] == 2
        assert series["areal_router_backend_state"][f'{{server="{addrs[1]}"}}'] == 0
        with open(os.path.join(os.path.dirname(__file__), "data", "metrics_schema.json")) as f:
            pinned = set(json.load(f)["router"])
        assert set(series) <= pinned
        assert {n for n in pinned if n.startswith("areal_router_")} <= set(series)
    finally:
        h.stop()
        servers[1].stop()


def test_drain_excludes_placement_but_keeps_fanout(fleet):
    servers, addrs = fleet
    raddr, h = _routed(RouterConfig(schedule_policy="round_robin", health_check_interval=0),
                       addrs, servers)
    try:
        assert _post(raddr, "/drain", {"addr": addrs[0]})[0] == 200
        assert _post(raddr, "/drain", {"addr": "10.0.0.1:1"}, expect_status=404)[0] == 404
        for i in range(6):
            s, out = _post(raddr, "/generate", {"rid": f"r{i}", "input_ids": [1],
                                                "sampling_params": {"max_new_tokens": 4}})
            assert s == 200 and out["output_tokens"]
        assert [len(s.requests) for s in servers] == [0, 3, 3]
        assert _post(raddr, "/update_weights", {"path": "/dev/null/v1", "version": 1})[0] == 200
        assert all(len(s.weight_updates) == 1 for s in servers)
        assert _post(raddr, "/undrain", {"addr": addrs[0]})[0] == 200
        _post(raddr, "/generate", {"rid": "back", "input_ids": [1],
                                   "sampling_params": {"max_new_tokens": 4}})
        assert len(servers[0].requests) == 1
    finally:
        h.stop()


# ---------------------------------------------------------------------------
# disaggregated prefill/decode serving (tests/test_router.py's cases)
# ---------------------------------------------------------------------------

def _disagg_fleet(roles, completion=None):
    servers = [_fake(completion=list(completion or range(100, 108)), role=r) for r in roles]
    return servers, [s.start() for s in servers]


@pytest.fixture()
def disagg(request):
    """A fake fleet of the given roles behind a disaggregating router ->
    (servers, addrs, router addr); everything stops after the test."""
    made = []

    def make(roles, completion=None, **cfg):
        servers, addrs = _disagg_fleet(roles, completion)
        made.append(servers)
        h = PortRouterHarness(Router(RouterConfig(disagg=True, **cfg), addresses=addrs))
        made.append(h)
        return servers, addrs, h.start()

    yield make
    for m in reversed(made):
        if isinstance(m, PortRouterHarness):
            m.stop()
        else:
            for s in m:
                s.stop()


def test_disagg_two_leg_handoff_merges_stream(disagg):
    """Leg 1 (one token) on the prefill server, /kv_export -> /kv_import,
    leg 2 on ONE decode server with the pinned stream id; the merged
    response carries the whole stream."""
    servers, addrs, raddr = disagg(["prefill", "decode", "decode"])
    status, out = _post(raddr, "/generate", {"rid": "d0", "input_ids": [1, 2, 3], "stream_id": 77,
                                             "sampling_params": {"max_new_tokens": 8}})
    assert status == 200
    assert out["output_tokens"] == list(range(100, 108))
    assert len(out["output_logprobs"]) == 8 and out["handoff"] is True
    prefill, d1, d2 = servers
    assert len(prefill.requests) == 1
    assert prefill.requests[0]["sampling_params"]["max_new_tokens"] == 1
    assert prefill.requests[0]["stream_id"] == 77
    assert [e["input_ids"] for e in prefill.kv_exports] == [[1, 2, 3, 100]]
    leg2 = [r for s in (d1, d2) for r in s.requests]
    assert len(leg2) == 1
    assert leg2[0]["input_ids"] == [1, 2, 3, 100] and leg2[0]["stream_id"] == 77
    assert leg2[0]["sampling_params"]["max_new_tokens"] == 7
    assert sum(len(s.kv_imports) for s in (d1, d2)) == 1
    m = _get(raddr, "/metrics")
    assert m["handoffs"] == 1 and m["handoff_fallbacks"] == 0
    assert m["handoff_bytes"] == 64 * 4 and m["handoff_seconds"] > 0
    assert m["roles"][addrs[0]] == "prefill"


def test_disagg_empty_role_pool_falls_back_colocated(disagg):
    """`both` servers stay out of the role pools: with no prefill/decode
    split the router serves the request colocated in one leg."""
    servers, _, raddr = disagg(["both", "both"])
    status, out = _post(raddr, "/generate", {"rid": "c0", "input_ids": [1, 2],
                                             "sampling_params": {"max_new_tokens": 8}})
    assert status == 200 and out["output_tokens"] == list(range(100, 108))
    assert "handoff" not in out
    reqs = [r for s in servers for r in s.requests]
    assert len(reqs) == 1 and reqs[0]["sampling_params"]["max_new_tokens"] == 8
    assert not any(s.kv_exports or s.kv_imports for s in servers)
    assert _get(raddr, "/metrics")["handoffs"] == 0


def test_disagg_import_failure_continues_on_prefill(disagg):
    """A refused import loses nothing: leg 2 runs on the prefill server
    itself (exact under the counter-keyed sampler) and counts a
    fallback."""
    from areal_tpu.utils.faults import Fault, FaultPlan

    servers, _, raddr = disagg(["prefill", "decode"])
    servers[1].fault_plan = FaultPlan({("/kv_import", 0): Fault("http_500")})
    status, out = _post(raddr, "/generate", {"rid": "f0", "input_ids": [4, 5, 6],
                                             "sampling_params": {"max_new_tokens": 8}})
    assert status == 200 and out["output_tokens"] == list(range(100, 108))
    assert out["handoff"] is False
    prefill, decode = servers
    assert len(prefill.requests) == 2 and not decode.requests  # leg 1 and the tail
    m = _get(raddr, "/metrics")
    assert m["handoffs"] == 0 and m["handoff_fallbacks"] == 1


def test_disagg_finished_in_leg1_skips_transfer(disagg):
    """A stop inside leg 1 (a one-token completion): the leg-1 answer is
    returned and nothing moves."""
    servers, _, raddr = disagg(["prefill", "decode"], completion=[42])
    status, out = _post(raddr, "/generate", {"rid": "e0", "input_ids": [9],
                                             "sampling_params": {"max_new_tokens": 8}})
    assert status == 200 and out["output_tokens"] == [42] and out["stop_reason"] == "stop"
    assert not servers[0].kv_exports and not servers[1].kv_imports
    assert not servers[1].requests


def test_disagg_group_affinity_sticks_to_one_prefill(disagg):
    """A group's members land on ONE prefill server (the fan-out shares a
    prefix inside one engine only)."""
    servers, _, raddr = disagg(["prefill", "prefill", "decode"])
    for i in range(4):
        status, _ = _post(raddr, "/generate", {"rid": f"g0-{i}", "group_id": "g0",
                                               "input_ids": [1, 2],
                                               "sampling_params": {"max_new_tokens": 8}})
        assert status == 200
    assert sorted(len(s.requests) for s in servers[:2]) == [0, 4]


def test_disagg_decode_pick_prefers_low_occupancy(disagg):
    """The decode leg goes to the server of lowest polled tier occupancy."""
    def occupied(servers):
        servers[1].tier_occupancy, servers[1].tier_slots = [8], [8]  # full
        servers[2].tier_occupancy, servers[2].tier_slots = [0], [8]  # idle

    servers, addrs = _disagg_fleet(["prefill", "decode", "decode"])
    occupied(servers)
    h = PortRouterHarness(Router(RouterConfig(disagg=True, occupancy_poll_interval=0.1),
                                 addresses=addrs))
    raddr = h.start()
    try:
        assert _wait(lambda: len(h.router._decode_occ) == 2, timeout=5)
        for i in range(3):
            status, _ = _post(raddr, "/generate", {"rid": f"o{i}", "input_ids": [1, 2, 3],
                                                   "sampling_params": {"max_new_tokens": 8}})
            assert status == 200
        assert len(servers[2].requests) == 3 and not servers[1].requests
    finally:
        h.stop()
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# the breaker
# ---------------------------------------------------------------------------

def test_breaker_opens_after_the_threshold_and_calls_on_death_once():
    alive = {"a": True, "b": True}
    deaths = []

    def probe(addr):
        if not alive[addr]:
            raise ConnectionRefusedError(addr)
        return {"status": "ok", "version": 0}

    hc = port_health.BackendHealthChecker(["a", "b"], probe, failure_threshold=3,
                                          interval=0, on_death=deaths.append)
    hc.probe_now()
    assert hc.placeable_cache == ("a", "b")
    alive["a"] = False
    for _ in range(2):
        hc.probe_now()
    assert hc.snapshot()["a"]["state"] == "closed" and not deaths
    hc.probe_now()  # the third failure in a row
    assert hc.snapshot()["a"]["state"] == "open" and deaths == ["a"]
    assert hc.placeable_cache == ("b",) and hc.alive_cache == ("b",)
    for _ in range(3):  # failures while open call on_death no more
        hc.probe_now()
        hc.report_failure("a", "refused")
    assert deaths == ["a"]
    hc.report_success("a")  # only the probe and the rejoin check close it
    assert hc.snapshot()["a"]["state"] == "open"
    alive["a"] = True
    hc.probe_now()  # no verify_rejoin: half_open -> closed at once
    assert hc.snapshot()["a"]["state"] == "closed" and hc.placeable_cache == ("a", "b")
    assert port_health.STATE_CODES == {"closed": 0, "half_open": 1, "open": 2, "draining": 3}


def test_half_open_backend_at_a_stale_version_is_reloaded_before_it_closes(tmp_path):
    """A backend restarted at version 0 after a disk publish of version 3:
    the probe finds it half-open, the router reloads it from the last
    publish pinned to the fleet's version, and only then closes it.  A
    reload that fails keeps it open."""
    servers = [_fake(completion=[100, 101]) for _ in range(2)]
    addrs = [s.start() for s in servers]
    port = servers[1].port
    raddr, h = _routed(RouterConfig(health_check_interval=0.05, health_failure_threshold=2,
                                    health_probe_timeout=0.5), addrs, servers)
    restarted = None
    try:
        _post(raddr, "/update_weights", {"path": str(tmp_path / "v3"), "version": 3})
        servers[1].stop()
        assert _wait(lambda: _get(raddr, "/metrics")["backend_states"][addrs[1]]["state"]
                     == "open")
        restarted = _fake(completion=[100, 101], port=port)
        restarted.start()
        assert _wait(lambda: _get(raddr, "/metrics")["backend_states"][addrs[1]]["state"]
                     == "closed")
        # the forced reload, pinned to the fleet's version, came before any
        # placement
        assert restarted.weight_updates == [{"path": str(tmp_path / "v3"), "version": 3}]
        assert restarted.version == 3 and restarted.requests == []
        m = _get(raddr, "/metrics")
        assert m["version"] == 3 and m["backend_states"][addrs[1]]["version"] in (0, 3)
    finally:
        h.stop()
        servers[0].stop()
        if restarted is not None:
            restarted.stop()


def test_failed_rejoin_reload_keeps_the_backend_open():
    calls = []

    def verify(addr, health):
        calls.append(health["version"])
        return False

    hc = port_health.BackendHealthChecker(["a"], lambda a: {"version": 0}, failure_threshold=1,
                                          interval=0, verify_rejoin=verify)
    hc.report_failure("a", "dead")
    assert hc.snapshot()["a"]["state"] == "open"
    hc.probe_now()
    assert calls == [0] and hc.snapshot()["a"]["state"] == "open"
    assert hc.snapshot()["a"]["error"] == "rejoin verification failed"
    assert hc.placeable_cache == ()


# ---------------------------------------------------------------------------
# the slice: two port servers behind the port's router
# ---------------------------------------------------------------------------

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
SLOTS, SEQ, PAGE = 4, 256, 16
ATOL = 1e-4
EXP, TRIAL = "router-slice", "t0"


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


def _in_thread(main, argv):
    """Run a `main(argv, on_ready)` on a thread -> its httpd once it listens."""
    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=main, args=(argv,), kwargs=dict(on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(120)
    return box["httpd"], t


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, int(n)).tolist() for n in rng.integers(5, 16, 3)]


def _greedy_port_client(router_addr, prompts, n_new=10):
    from areal_tpu_torch.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import ModelRequest
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine

    eng = RemoteTorchEngine(InferenceEngineConfig(experiment_name=EXP, trial_name=TRIAL,
                                                  request_timeout=60))
    eng.initialize(addr=router_addr)
    try:
        # the router, found through name_resolve, gates this client's episodes
        assert eng.executor.fleet_gate is not None
        assert eng.executor.fleet_gate.router_addr == router_addr
        return [asyncio.run(eng.agenerate(ModelRequest(
            rid=f"p{i}", input_ids=list(p),
            gconfig=GenerationHyperparameters(max_new_tokens=n_new, greedy=True))))
            for i, p in enumerate(prompts)]
    finally:
        eng.destroy()


def _greedy_jax_client(router_addr, prompts, n_new=10):
    from areal_tpu.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu.api.io_struct import ModelRequest
    from areal_tpu.engine.jax_remote import RemoteJaxEngine

    eng = RemoteJaxEngine(InferenceEngineConfig(request_timeout=60))
    eng.initialize(addr=router_addr)
    try:
        return [asyncio.run(eng.agenerate(ModelRequest(
            rid=f"j{i}", input_ids=list(p),
            gconfig=GenerationHyperparameters(max_new_tokens=n_new, greedy=True))))
            for i, p in enumerate(prompts)]
    finally:
        eng.destroy()


def _jax_greedy(jax_eng, prompts, n_new=10):
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    return jax_eng.generate_blocking([JaxRequest(rid=f"x{i}", input_ids=list(p),
                                                 max_new_tokens=n_new, temperature=0.0)
                                      for i, p in enumerate(prompts)])


def _assert_match(got, want, version):
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=ATOL, rtol=0)
        assert g.output_versions == [version] * len(g.output_tokens)


@pytest.fixture(scope="module")
def slice_fleet(tmp_path_factory):
    from areal_tpu_torch.gen import router as router_mod
    from areal_tpu_torch.gen import server as server_mod
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.models.hf import save_hf_checkpoint
    from areal_tpu_torch.models.model_config import tiny_config

    root = tmp_path_factory.mktemp("router_slice")
    # one intra-op thread for the two in-process servers: the tiny model
    # needs no more, and the test workers beside this one keep their cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tree = _jax_tree(0)
    ckpt = str(root / "ckpt")
    save_hf_checkpoint(params_from_jax(tree, tiny_config(**KW), "cpu"), ckpt,
                       save_dtype="float32")
    name_resolve.clear_subtree(names.trial_root(EXP, TRIAL))
    servers = [_in_thread(server_mod.main, [
        "--model-path", ckpt, "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--n-slots", str(SLOTS), "--max-seq-len", str(SEQ), "--page-size", str(PAGE),
        "--experiment-name", EXP, "--trial-name", TRIAL, "--server-idx", str(i)])
        for i in range(2)]
    router, rthread = _in_thread(router_mod.main, [
        "--experiment-name", EXP, "--trial-name", TRIAL, "--host", "127.0.0.1",
        "--schedule-policy", "round_robin", "--train-batch-size", "4",
        "--max-head-offpolicyness", "8", "--health-check-interval", "0.1"])
    try:
        yield types.SimpleNamespace(root=root, tree=tree, servers=servers, router=router)
    finally:
        router.shutdown()
        rthread.join(30)
        for httpd, t in servers:
            httpd.shutdown()
            t.join(30)
        name_resolve.clear_subtree(names.trial_root(EXP, TRIAL))
        torch.set_num_threads(threads)


def test_two_port_servers_behind_the_router_match_the_jax_engine(slice_fleet):
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.models.hf import save_hf_checkpoint
    from areal_tpu_torch.models.model_config import tiny_config

    f = slice_fleet
    server_addrs = sorted(f"127.0.0.1:{h.port}" for h, _ in f.servers)
    # every process found the others through name_resolve
    router_addr = name_resolve.get(names.gen_router(EXP, TRIAL))
    assert router_addr == f"127.0.0.1:{f.router.port}"
    assert sorted(name_resolve.get_subtree(names.gen_servers(EXP, TRIAL))) == server_addrs
    assert sorted(f.router.router.addresses) == server_addrs

    jax_eng = JaxEngine(jax_tiny(**KW), params=f.tree, ragged_attn=True, kv_reuse=False,
                        share_prefix=False, n_slots=SLOTS, max_seq_len=SEQ,
                        prompt_bucket=PAGE, kv_dtype="float32")
    before = _prompts(1)
    want = _jax_greedy(jax_eng, before)
    _assert_match(_greedy_port_client(router_addr, before), want, 0)
    _assert_match(_greedy_jax_client(router_addr, before), want, 0)
    routed = _get(router_addr, "/metrics")["requests_routed"]
    assert sorted(routed) == server_addrs and all(n > 0 for n in routed.values())

    # a publish through the router, from an HF checkpoint both packages
    # load (in bf16, as a trainer writes it: the JAX engine reads
    # snapshots in bf16, the port's f32 server holds the same values)
    tree2 = _jax_tree(5)
    pub = f.root / "publish"
    save_hf_checkpoint(params_from_jax(tree2, tiny_config(**KW), "cpu"), str(pub / "v1"),
                       save_dtype="bfloat16")
    status, out = _post(router_addr, "/update_weights", {"path": str(pub / "v1"), "version": 1})
    assert status == 200 and out["version"] == 1
    for a in server_addrs:
        assert _get(a, "/health")["version"] == 1
    assert _get(router_addr, "/health")["version"] == 1
    jax_eng.load_weights(path=str(pub / "v1"), version=1)
    after = _prompts(2)
    want = _jax_greedy(jax_eng, after)
    _assert_match(_greedy_port_client(router_addr, after), want, 1)
    _assert_match(_greedy_jax_client(router_addr, after), want, 1)


def test_rollouts_through_the_router_balance_the_gate_ledger(slice_fleet):
    """A GRPO rollout batch of the port's client through the router: each
    group on one server, every lease returned, accepted counted."""
    from areal_tpu_torch.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.scripts.bench_e2e_grpo import _reward_any_even
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    router_addr = f"127.0.0.1:{slice_fleet.router.port}"
    m0 = _get(router_addr, "/metrics")
    eng = RemoteTorchEngine(InferenceEngineConfig(
        experiment_name=EXP, trial_name=TRIAL, consumer_batch_size=4,
        max_concurrent_rollouts=8, request_timeout=60))
    eng.initialize(addr=router_addr)
    try:
        wf = RLVRWorkflow(reward_fn=_reward_any_even,
                          gconfig=GenerationHyperparameters(n_samples=2, max_new_tokens=6))
        batch = eng.rollout_batch([{"input_ids": p} for p in _prompts(3)[:2]], workflow=wf)
        assert batch["input_ids"].shape[0] == 4
    finally:
        eng.destroy()
    m1 = _get(router_addr, "/metrics")
    assert m1["running"] == 0 and m1["accepted"] - m0["accepted"] == 2
    assert sum(m1["requests_routed"].values()) - sum(m0["requests_routed"].values()) == 4


def test_prefill_and_decode_port_servers_behind_the_router_give_one_servers_stream(tmp_path):
    """A prefill and a decode port server (tiny f32, CPU) behind the
    disaggregating router: every request hands off (the decode server
    imports its prefix and swaps it in), and each merged stream, tokens
    and logprobs, is the two-leg split on one engine of the same weights;
    its tokens are also the one-shot stream's."""
    from areal_tpu_torch.gen import server as server_mod
    from areal_tpu_torch.gen.engine import GenEngine, GenRequest
    from areal_tpu_torch.models.hf import save_hf_checkpoint
    from areal_tpu_torch.models.model_config import tiny_config
    from areal_tpu_torch.models.transformer import init_params

    cfg = tiny_config(**KW)
    ckpt = str(tmp_path / "ckpt")
    save_hf_checkpoint(init_params(cfg, 3, "cpu"), ckpt, save_dtype="float32")
    args = ["--model-path", ckpt, "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
            "--n-slots", str(SLOTS), "--max-seq-len", str(SEQ), "--page-size", str(PAGE)]
    servers = [_in_thread(server_mod.main, args + ["--role", role])
               for role in ("prefill", "decode")]
    addrs = [f"127.0.0.1:{h.port}" for h, _ in servers]
    h = PortRouterHarness(Router(RouterConfig(disagg=True, occupancy_poll_interval=0.1),
                                 addresses=addrs))
    raddr = h.start()
    engine = dict(n_slots=SLOTS, max_seq_len=SEQ, prompt_bucket=PAGE, kv_dtype="float32",
                  device="cpu")
    split = GenEngine(cfg, model_path=ckpt, **engine)
    rng = np.random.default_rng(7)
    try:
        assert _get(raddr, "/metrics")["roles"] == dict(zip(addrs, ("prefill", "decode")))
        for i in range(3):
            ids = rng.integers(0, 97, int(rng.integers(20, 40))).tolist()
            temp = 0.0 if i % 2 == 0 else 1.0
            sp = {"max_new_tokens": 8, "min_new_tokens": 8, "temperature": temp, "top_p": 0.9}
            status, out = _post(raddr, "/generate", {"rid": f"d{i}", "input_ids": ids,
                                                     "stream_id": 500 + i, "sampling_params": sp})
            assert status == 200 and out["handoff"] is True and out["stream_id"] == 500 + i

            def req(rid, prompt, n):
                return GenRequest(rid=rid, input_ids=list(prompt), max_new_tokens=n,
                                  min_new_tokens=n, temperature=temp, top_p=0.9,
                                  stream_id=500 + i)
            leg1 = split.generate_blocking([req("l1", ids, 1)])[0]
            leg2 = split.generate_blocking([req("l2", ids + leg1.output_tokens, 7)])[0]
            assert out["output_tokens"] == leg1.output_tokens + leg2.output_tokens
            assert out["output_logprobs"] == leg1.output_logprobs + leg2.output_logprobs
            one = GenEngine(cfg, model_path=ckpt, **engine).generate_blocking(
                [req("one", ids, 8)])[0]
            assert out["output_tokens"] == one.output_tokens
        m = _get(raddr, "/metrics")
        assert (m["handoffs"], m["handoff_fallbacks"]) == (3, 0)
        pre, dec = (_get(a, "/metrics") for a in addrs)
        assert (pre["role"], dec["role"]) == ("prefill", "decode")
        assert pre["kv_handoff_exports"] == 3 and dec["kv_handoff_imports"] == 3
        assert dec["prefix_cache_host_swaps"] == 3 and pre["decode_steps"] == 0
        assert pre["kv_handoff_bytes"] == dec["kv_handoff_bytes"] == m["handoff_bytes"]
    finally:
        h.stop()
        for httpd, t in servers:
            httpd.shutdown()
            t.join(30)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_server_processes_behind_the_router_process_on_the_card(cuda_device, tmp_path,
                                                                    monkeypatch):
    """Two bf16 server processes on the card behind the router process,
    all found through name_resolve on NFS: a disk publish from a trainer
    here is flushed in by the router's watcher, then both servers' greedy
    streams and logprobs are bit-equal to a GenEngine on the published
    weights."""
    import subprocess
    import sys

    from areal_tpu_torch.api.config import GenServerConfig, OptimizerConfig, PPOActorConfig
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.engine.ppo import TorchPPOActor
    from areal_tpu_torch.gen.engine import GenEngine, GenRequest
    from areal_tpu_torch.launcher.local import LocalLauncher, servers_for_allocation
    from areal_tpu_torch.models.hf import save_hf_checkpoint
    from areal_tpu_torch.models.model_config import tiny_config
    from areal_tpu_torch.models.transformer import init_params

    spec = f"nfs:{tmp_path / 'nr'}"
    monkeypatch.setenv("AREAL_NAME_RESOLVE", spec)
    saved = name_resolve.DEFAULT_REPOSITORY
    name_resolve.reconfigure_from_env()
    cfg = tiny_config(vocab_size=512, hidden_size=256, num_heads=2, num_kv_heads=1,
                      head_dim=128, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                      eos_token_id=None, dtype="bfloat16")
    ckpt = str(tmp_path / "ckpt")
    meta = WeightUpdateMeta.from_disk("gpu-router", "t0", str(tmp_path), name="publish")
    save_hf_checkpoint(init_params(cfg, 0, "cuda", param_dtype="float32"), ckpt,
                       save_dtype="bfloat16")
    router_proc = None
    try:
        with LocalLauncher(str(tmp_path / "logs")) as launcher:
            addrs = launcher.start_gen_servers(
                GenServerConfig(model_path=ckpt, dtype="bfloat16", max_seqs=SLOTS,
                                max_context_len=SEQ, page_size=128, random_seed=0),
                servers_for_allocation("jax:d2+d1"), timeout=300,
                experiment_name="gpu-router", trial_name="t0")
            monkeypatch.delenv("AREAL_LLM_SERVER_ADDRS")
            router_proc = subprocess.Popen(
                [sys.executable, "-m", "areal_tpu_torch.gen.router", "--experiment-name",
                 "gpu-router", "--trial-name", "t0", "--host", "127.0.0.1",
                 "--weights-path", meta.path, "--poll-interval", "0.2", "--exit-with-parent"],
                env=dict(os.environ, AREAL_NAME_RESOLVE=spec))
            router_addr = name_resolve.wait(names.gen_router("gpu-router", "t0"), timeout=120)
            actor = TorchPPOActor(PPOActorConfig(path=ckpt, dtype="bfloat16",
                                                 optimizer=OptimizerConfig()), model_config=cfg)
            actor.initialize(ft_spec=FinetuneSpec(1, 16, 4))
            gen = torch.Generator(device="cuda").manual_seed(1)
            with torch.no_grad():
                for p in actor.model.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
            actor.set_version(1)
            actor.update_weights(meta)
            assert _wait(lambda: all(_get(a, "/health")["version"] == 1 for a in addrs), 120, 0.2)
            assert _get(router_addr, "/health")["version"] == 1
            local = GenEngine(cfg, params=actor.export_device_params(), n_slots=SLOTS,
                              max_seq_len=SEQ, prompt_bucket=128, kv_dtype="bfloat16", seed=0)
            for i, ids in enumerate(_prompts(4)):
                req = GenRequest(rid=f"c{i}", input_ids=ids, max_new_tokens=16, temperature=0.0)
                local.generate_blocking([req])
                for a in addrs:
                    status, r = _post(a, "/generate", {"rid": f"c{i}", "input_ids": ids,
                                                       "sampling_params": {
                                                           "max_new_tokens": 16,
                                                           "temperature": 0.0}})
                    assert status == 200 and r["version"] == 1
                    assert r["output_tokens"] == req.output_tokens
                    assert r["output_logprobs"] == req.output_logprobs
    finally:
        if router_proc is not None:
            router_proc.kill()
            router_proc.wait()
        name_resolve.DEFAULT_REPOSITORY = saved
