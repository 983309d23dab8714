"""The port's telemetry (`areal_tpu_torch/utils/telemetry.py`) on the CPU:
the behaviours of the JAX package's `tests/test_telemetry.py` on the
port's copy (registry, histograms, event log, JSONL and Chrome-trace
dumps, the staleness export, the trainer's endpoint), the copy's
exposition against the JAX module's on the same operations, and the
port's generation server: Prometheus beside the legacy JSON, counters that
never decrease, the speculative-decoding series and `spec_verify` events,
the trace id joining client and server events, and every served name
pinned in `tests/data/metrics_schema.json`.
"""

import asyncio
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import server
from areal_tpu_torch.gen.engine import GenEngine
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.telemetry import (
    EventLog,
    Histogram,
    Registry,
    parse_prometheus_text,
    trace_key,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "data", "metrics_schema.json")
KW = dict(vocab_size=89, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
SPEC_SERIES = ("areal_gen_spec_drafted_total", "areal_gen_spec_accepted_total",
               "areal_gen_verify_calls_total", "areal_gen_spec_acceptance_rate")


@pytest.fixture()
def enabled():
    """Telemetry on for one test; the flag and the event log restored after."""
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    telemetry.EVENTS.clear()
    yield
    telemetry.set_enabled(was)
    telemetry.EVENTS.clear()


def _type_lines(text: str):
    """{metric name: kind} from the '# TYPE' lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            out[name] = kind
    return out


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        return resp.read().decode()


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_trace_key_stable_nonnegative_int64():
    k1 = trace_key("traj-0")
    assert k1 == trace_key("traj-0")
    assert k1 != trace_key("traj-1")
    assert 0 <= k1 < 2**63 and int(np.int64(k1)) == k1


def _registry_ops(reg):
    reg.counter("reqs_total", "requests").inc(3)
    reg.counter("reqs_total").inc(2, server="a")
    reg.gauge("depth", "queue depth").set(7)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg.render_prometheus()


def test_registry_render_parse_roundtrip():
    text = _registry_ops(Registry("t1"))
    parsed = parse_prometheus_text(text)
    assert parsed["areal_t1_reqs_total"][""] == 3
    assert parsed["areal_t1_reqs_total"]['{server="a"}'] == 2
    assert parsed["areal_t1_depth"][""] == 7
    b = parsed["areal_t1_lat_seconds_bucket"]
    assert (b['{le="0.1"}'], b['{le="1"}'], b['{le="+Inf"}']) == (1, 2, 3)
    assert parsed["areal_t1_lat_seconds_count"][""] == 3
    assert parsed["areal_t1_lat_seconds_sum"][""] == pytest.approx(5.55)
    assert _type_lines(text) == {"areal_t1_depth": "gauge",
                                 "areal_t1_lat_seconds": "histogram",
                                 "areal_t1_reqs_total": "counter"}


def test_exposition_matches_the_jax_module():
    """The same operations on the port's copy and on the JAX package's
    module render the same text and parse to the same dict."""
    from areal_tpu.utils import telemetry as jax_telemetry

    mine = _registry_ops(Registry("parity"))
    theirs = _registry_ops(jax_telemetry.Registry("parity"))
    assert mine == theirs
    assert parse_prometheus_text(mine) == jax_telemetry.parse_prometheus_text(theirs)


def test_registry_get_or_create_and_kind_conflict():
    reg = Registry("t2")
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    assert reg.counter("areal_custom_total").name == "areal_custom_total"


def test_collector_errors_do_not_fail_scrape():
    reg = Registry("t3")
    reg.add_collector(lambda: 1 / 0)
    reg.add_collector(lambda: reg.gauge("fine").set(1))
    assert "areal_t3_fine 1" in reg.render_prometheus()
    assert reg.collector_errors == 1


def test_histogram_staleness_buckets():
    h = Histogram("s", "", buckets=telemetry.STALENESS_BUCKETS)
    for v in (0, 0, 1, 5, 100):
        h.observe(v)
    samples = {(s, lab.get("le")): v for s, lab, v in h.samples()}
    assert samples[("_bucket", "0")] == 2
    assert samples[("_bucket", "1")] == 3
    assert samples[("_bucket", "6")] == 4
    assert samples[("_bucket", "+Inf")] == 5
    assert samples[("_count", None)] == 5


def test_event_log_disabled_is_noop():
    was = telemetry.is_enabled()
    telemetry.set_enabled(False)
    try:
        log = EventLog(capacity=4)
        log.emit("submit", trace_id="t")
        assert len(log) == 0
    finally:
        telemetry.set_enabled(was)


def test_event_log_bounded_with_dropped_count(enabled):
    log = EventLog(capacity=4)
    for i in range(7):
        log.emit("e", trace_id=f"t{i}", idx=i)
    assert len(log) == 4 and log.dropped == 3
    evs = log.snapshot()
    assert [e["idx"] for e in evs] == [3, 4, 5, 6]
    assert all(e["trace_key"] == trace_key(e["trace_id"]) for e in evs)


def test_event_log_jsonl_and_chrome_trace(enabled, tmp_path):
    log = EventLog(capacity=64)
    log.emit("rollout_submit", trace_id="tr-1", input_len=8)
    log.emit("decode_chunk", tier=0, latency_s=0.25, trace_ids=["tr-1"])
    log.emit("gen_done", trace_id="tr-1", latency_s=1.0)
    jl = tmp_path / "events.jsonl"
    assert log.dump_jsonl(str(jl)) == 3
    lines = [json.loads(ln) for ln in jl.read_text().splitlines()]
    assert [e["event"] for e in lines] == ["rollout_submit", "decode_chunk", "gen_done"]
    by_name = {}
    for ev in log.to_chrome_trace()["traceEvents"]:
        by_name.setdefault(ev["name"], []).append(ev)
    assert by_name["process_name"][0]["ph"] == "M"
    assert by_name["rollout_submit"][0]["ph"] == "i"
    done = by_name["gen_done"][0]
    assert done["ph"] == "X" and done["dur"] == pytest.approx(1e6)
    assert done["tid"] == trace_key("tr-1") % (2**31)
    ct = tmp_path / "trace.json"
    assert log.dump_chrome_trace(str(ct)) == 3
    json.loads(ct.read_text())


def test_dump_jsonl_meta_trailer_records_drops(enabled, tmp_path):
    log = EventLog(capacity=2)
    log.emit("e", trace_id="t0")
    jl = tmp_path / "lossless.jsonl"
    assert log.dump_jsonl(str(jl)) == 1
    assert "telemetry_meta" not in jl.read_text()
    for i in range(5):
        log.emit("e", trace_id=f"t{i}")
    jl2 = tmp_path / "lossy.jsonl"
    n = log.dump_jsonl(str(jl2))
    lines = [json.loads(ln) for ln in jl2.read_text().splitlines()]
    assert n == len(lines) == 3 and lines[-1]["event"] == "telemetry_meta"
    assert lines[-1]["dropped_events"] == log.dropped == 4 and lines[-1]["capacity"] == 2


def test_events_carry_paired_clocks_and_pid(enabled):
    telemetry.emit("rollout_submit", trace_id="clk-1", input_len=4)
    telemetry.emit("gen_done", trace_id="clk-1", latency_s=0.1)
    evs = [e for e in telemetry.EVENTS.snapshot() if e.get("trace_id") == "clk-1"]
    assert len(evs) == 2
    assert all(e["pid"] == os.getpid() and e["mono"] > 0 and e["ts"] > 0 for e in evs)
    assert evs[1]["mono"] >= evs[0]["mono"]


def test_events_dropped_total_on_both_surfaces():
    name = "areal_telemetry_events_dropped_total"
    before = telemetry.EVENTS.dropped
    try:
        telemetry.EVENTS.dropped = before + 7
        for reg in (telemetry.GEN, telemetry.TRAIN):
            assert reg.snapshot()[name] == before + 7
            assert parse_prometheus_text(reg.render_prometheus())[name][""] == before + 7
    finally:
        telemetry.EVENTS.dropped = before


def test_train_counters_registered_eagerly():
    text = telemetry.TRAIN.render_prometheus()
    for name in ("areal_train_publish_partial_failures_total",
                 "areal_client_resubmissions_total", "areal_train_recover_total"):
        assert name in text
    assert telemetry.PUBLISH_PARTIAL_FAILURES is telemetry.TRAIN.counter(
        "publish_partial_failures_total")


def test_staleness_capacity_formula_and_metrics_export():
    from areal_tpu_torch.core.staleness import StalenessManager

    bs, eta = 4, 2
    m = StalenessManager(max_concurrent_rollouts=64, consumer_batch_size=bs,
                         max_staleness=eta)
    reg = Registry("stale_t")
    m.register_metrics(reg)
    version = 0
    rng = np.random.default_rng(0)
    for step in range(200):
        if m.get_capacity(version) > 0:
            m.on_rollout_submitted()
        elif m.get_stats().running:
            (m.on_rollout_accepted if rng.integers(2) else m.on_rollout_rejected)()
        else:
            version += 1  # the trainer consumed a batch
        st = m.get_stats()
        assert st.accepted + st.running <= (eta + version + 1) * bs, (step, st, version)
    snap = reg.snapshot()
    st = m.get_stats()
    assert snap["areal_stale_t_rollout_submitted"] == st.submitted
    assert snap["areal_stale_t_rollout_running"] == st.running
    assert snap["areal_stale_t_rollout_accepted"] == st.accepted
    assert snap["areal_stale_t_rollout_rejected"] == st.rejected


def test_trainer_metrics_endpoint():
    reg = Registry("train_ep")
    reg.counter("steps_total", "steps").inc(3)
    reg.histogram("staleness_at_consumption", "s",
                  buckets=telemetry.STALENESS_BUCKETS).observe(1)
    srv, port = telemetry.start_metrics_server(reg)
    try:
        parsed = parse_prometheus_text(_scrape(f"http://127.0.0.1:{port}/metrics"))
        assert parsed["areal_train_ep_steps_total"][""] == 3
        assert parsed["areal_train_ep_staleness_at_consumption_count"][""] == 1
        snap = json.loads(_scrape(f"http://127.0.0.1:{port}/metrics?format=json"))
        assert snap["areal_train_ep_steps_total"] == 3
        assert json.loads(_scrape(f"http://127.0.0.1:{port}/health"))["status"] == "ok"
    finally:
        srv.shutdown()


def test_train_batch_strips_trace_keys_and_observes_staleness(enabled):
    """`trace_keys` never reaches packing; each row's staleness at
    consumption lands in the histogram and a `train_consume` event."""
    from areal_tpu_torch.engine.torch_train import TorchTrainEngine

    eng = TorchTrainEngine.__new__(TorchTrainEngine)
    eng._version = 5
    batch = {"versions": np.array([[-1, 3, 4], [-1, -1, 5], [-1, -1, -1]]),
             "trace_keys": np.array([11, 12, 13], np.int64)}
    before = telemetry.STALENESS_AT_CONSUMPTION.samples()
    out = eng._consume_telemetry(batch)
    assert "trace_keys" not in out and "versions" in out
    evs = [e for e in telemetry.EVENTS.snapshot() if e["event"] == "train_consume"]
    assert [(e["trace_key"], e["staleness"]) for e in evs] == [(11, 1), (12, 0)]
    count = {s: v for s, lab, v in telemetry.STALENESS_AT_CONSUMPTION.samples()
             if s == "_count"}["_count"]
    prior = {s: v for s, lab, v in before if s == "_count"}.get("_count", 0.0)
    assert count == prior + 2


def test_ppo_update_observes_staleness_at_consumption(enabled):
    """The GRPO path: `ppo_update` narrows the batch to the loss keys before
    `train_batch`, so consumption is recorded before that narrowing, once
    a row, with the row's trace key."""
    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    actor = TorchPPOActor(tc.PPOActorConfig(
        init_from_scratch=True, dtype="float32", pack_length_quantum=16, group_size=2,
        ppo_n_minibatches=1, optimizer=tc.OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
    ), model_config=tiny_config(), device="cpu")
    actor.initialize(ft_spec=FinetuneSpec(1, 4, 4))
    actor.set_version(3)
    rng = np.random.default_rng(0)
    B, L, P = 4, 12, 4
    mask = np.ones((B, L), bool)
    versions = np.full((B, L), -1, np.int32)
    versions[:, P:] = np.array([2, 3, 1, 3])[:, None]
    batch = {
        "input_ids": rng.integers(0, tiny_config().vocab_size, (B, L)).astype(np.int32),
        "attention_mask": mask,
        "loss_mask": (np.arange(L)[None, :] >= P) * mask,
        "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32),
        "rewards": np.array([0.0, 1.0, 1.0, 0.0], np.float32),
        "versions": versions,
        "trace_keys": np.array([21, 22, 23, 24], np.int64),
    }
    actor.compute_advantages(batch)

    def count():
        return {s: v for s, lab, v in telemetry.STALENESS_AT_CONSUMPTION.samples()
                if s == "_count"}.get("_count", 0.0)

    before = count()
    actor.ppo_update(batch)
    assert count() == before + B
    evs = [e for e in telemetry.EVENTS.snapshot() if e["event"] == "train_consume"]
    assert [(e["trace_key"], e["staleness"]) for e in evs] == [(21, 1), (22, 0), (23, 2),
                                                              (24, 0)]


# ---------------------------------------------------------------------------
# the port's generation server
# ---------------------------------------------------------------------------


def _boot(engine):
    """serve(engine) on a thread -> (httpd, stop)."""
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)

    def stop():
        box["httpd"].shutdown()
        t.join(30)

    return box["httpd"], stop


def _generate(port, rid, ids=(5, 6, 7), n_new=4):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"rid": rid, "input_ids": list(ids),
                         "sampling_params": {"max_new_tokens": n_new,
                                             "temperature": 0.0}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def gen_server():
    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=4, max_seq_len=96,
                       prompt_bucket=16, kv_dtype="float32", device="cpu")
    httpd, stop = _boot(engine)
    yield engine, httpd.port
    stop()


def test_gen_server_prometheus_and_json_coexist(gen_server):
    _, port = gen_server
    _generate(port, "m-0")
    legacy = json.loads(_scrape(f"http://127.0.0.1:{port}/metrics"))
    assert "decode_steps" in legacy and "prefill_tokens" in legacy
    text = _scrape(f"http://127.0.0.1:{port}/metrics?format=prometheus")
    parsed = parse_prometheus_text(text)
    assert parsed["areal_gen_prefill_tokens_total"][""] == legacy["prefill_tokens"] > 0
    assert parsed["areal_gen_decode_steps_total"][""] == legacy["decode_steps"]
    assert "areal_gen_pause_window_seconds" in _type_lines(text)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                 headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.read().decode().startswith("# ")


def test_gen_server_counters_never_decrease(gen_server):
    _, port = gen_server
    url = f"http://127.0.0.1:{port}/metrics?format=prometheus"
    before = parse_prometheus_text(_scrape(url))
    for i in range(3):
        _generate(port, f"mono-{i}")
    after = parse_prometheus_text(_scrape(url))
    checked = 0
    for name, series in before.items():
        if name.endswith("_total"):
            for labels, v in series.items():
                assert after[name][labels] >= v, (name, labels)
                checked += 1
    assert checked > 5
    assert (after["areal_gen_tokens_generated_total"][""]
            > before["areal_gen_tokens_generated_total"][""])


def test_gen_server_stop_removes_its_collector():
    """Each server adds one collector to the process's `gen` registry and
    its `stop` takes it out again, so servers run one after another leave
    none behind."""
    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=2, max_seq_len=32,
                       prompt_bucket=16, kv_dtype="float32", device="cpu")
    before = len(telemetry.GEN._collectors)
    for _ in range(2):
        gen = server.GenServer(engine)
        assert len(telemetry.GEN._collectors) == before + 1
        gen.start()
        gen.stop()
        gen.stop()  # a second stop is a no-op
        assert len(telemetry.GEN._collectors) == before


def test_trainer_serves_train_registry():
    """The example trainer's `/metrics` (`serve_train_metrics`, started when
    telemetry is on) serves the `train` registry, and stops."""
    from areal_tpu_torch.examples.math.gsm8k_grpo import serve_train_metrics

    telemetry.STALENESS_AT_CONSUMPTION.observe(1)
    port, close = serve_train_metrics()
    url = f"http://127.0.0.1:{port}/metrics"
    try:
        parsed = parse_prometheus_text(_scrape(url))
        assert parsed["areal_train_staleness_at_consumption_count"][""] >= 1
        assert "areal_telemetry_events_dropped_total" in parsed
    finally:
        close()
    with pytest.raises(OSError):
        _scrape(url)


def test_served_names_are_pinned(gen_server):
    """Every name the port's gen surface and its train registry serve is
    pinned in tests/data/metrics_schema.json (C9's contract, checked on
    what the port actually constructs), and the speculative series are
    among them."""
    with open(SCHEMA_PATH) as f:
        schema = json.load(f)
    _, port = gen_server
    gen = _type_lines(_scrape(f"http://127.0.0.1:{port}/metrics?format=prometheus"))
    train = _type_lines(telemetry.TRAIN.render_prometheus())
    assert set(gen) <= set(schema["gen"]), sorted(set(gen) - set(schema["gen"]))
    assert set(train) <= set(schema["train"]), sorted(set(train) - set(schema["train"]))
    assert set(SPEC_SERIES) <= set(gen)


def test_gen_server_spec_decode_telemetry(enabled):
    """Spec decoding on a periodic prompt through the port's server: the
    engine drafts and verifies, the four pinned series (with a per-tier
    rate) and the JSON keys report it, and each verify leaves a
    `spec_verify` event.  Cyclic weights (zero attention output
    projections: the next greedy token is a function of the current one)
    make the stream repeat, so drafting is certain."""
    cfg = tiny_config(**KW)
    params = init_params(cfg, 0, "cpu")
    with torch.no_grad():
        for layer in params.model.layers:
            layer.self_attn.o_proj.weight.zero_()
    engine = GenEngine(cfg, params=params, n_slots=4, max_seq_len=96, prompt_bucket=16,
                       kv_dtype="float32", device="cpu", spec_decode=True, spec_draft_len=3)
    httpd, stop = _boot(engine)
    try:
        out = _generate(httpd.port, "spec-tel-0", ids=[5, 6, 7] * 4, n_new=12)
        assert len(out["output_tokens"]) == 12
        assert engine.stats["spec_drafted"] > 0 and engine.stats["verify_calls"] > 0
        parsed = parse_prometheus_text(
            _scrape(f"http://127.0.0.1:{httpd.port}/metrics?format=prometheus"))
        for name in SPEC_SERIES:
            assert name in parsed, name
        assert parsed["areal_gen_spec_drafted_total"][""] == engine.stats["spec_drafted"]
        assert parsed["areal_gen_verify_calls_total"][""] == engine.stats["verify_calls"]
        rate = parsed["areal_gen_spec_acceptance_rate"]
        assert "" in rate and '{tier="0"}' in rate
        legacy = json.loads(_scrape(f"http://127.0.0.1:{httpd.port}/metrics"))
        assert legacy["spec_drafted"] == engine.stats["spec_drafted"]
        assert legacy["verify_calls"] == engine.stats["verify_calls"]
        assert 0.0 <= legacy["spec_acceptance_rate"] <= 1.0
        evs = [e for e in telemetry.EVENTS.snapshot() if e["event"] == "spec_verify"]
        assert evs and evs[0]["drafted"] >= 1
        assert "latency_s" in evs[0] and evs[0]["tier"] == 0 and evs[0]["draft_len"] == 3
    finally:
        stop()


def test_trace_id_rides_the_wire_and_events_join(gen_server, enabled):
    """The port's remote client on the port's server: client events
    (rollout_submit, gen_done) and server events (admission, prefill,
    decode_chunk) share the request's trace id."""
    from areal_tpu_torch.api.config import GenerationHyperparameters, InferenceEngineConfig
    from areal_tpu_torch.api.io_struct import ModelRequest
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine

    _, port = gen_server
    client = RemoteTorchEngine(InferenceEngineConfig(
        consumer_batch_size=2, max_concurrent_rollouts=8, request_timeout=30,
        max_head_offpolicyness=100))
    client.initialize(addr=f"127.0.0.1:{port}")
    try:
        resp = asyncio.run(client.agenerate(ModelRequest(
            rid="wire-1", trace_id="wire-1", input_ids=[5, 6, 7],
            gconfig=GenerationHyperparameters(max_new_tokens=4, greedy=True))))
        assert len(resp.output_tokens) == 4
    finally:
        client.destroy()
    evs = telemetry.EVENTS.snapshot()
    names = [e["event"] for e in evs if e.get("trace_id") == "wire-1"]
    for name in ("rollout_submit", "gen_done", "admission", "prefill"):
        assert name in names, name
    prefill = next(e for e in evs if e.get("trace_id") == "wire-1" and e["event"] == "prefill")
    assert prefill["cold_tokens"] + prefill["inherited_tokens"] == prefill["total_tokens"] == 3
    assert any("wire-1" in e.get("trace_ids", ()) for e in evs if e["event"] == "decode_chunk")


def test_weight_swap_records_the_pause(enabled):
    cfg = tiny_config(**KW)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=2, max_seq_len=64,
                       prompt_bucket=16, kv_dtype="float32", device="cpu")
    count = lambda: sum(v for s, _, v in telemetry.PAUSE_WINDOW.samples()  # noqa: E731
                        if s == "_count")
    before = count()
    engine.swap_weights_live(init_params(cfg, 1, "cpu"))
    engine.load_weights(model=init_params(cfg, 2, "cpu"))
    assert count() == before + 2
    pauses = [e for e in telemetry.EVENTS.snapshot() if e["event"] == "pause"]
    assert [(e["kind"], e["version_before"], e["version_after"]) for e in pauses] == [
        ("swap_live", 0, 1), ("reload_abort", 1, 2)]
