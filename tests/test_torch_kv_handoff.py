"""The disaggregated KV handoff in the port (`GenEngine.export_request_kv`
and `import_request_kv`, the wire format of `gen/kv_pool.py`).

- Against JAX: a wire entry the JAX package encodes, from its engine's
  f32 export and from a bf16 array (`ml_dtypes`), decodes in the port
  byte for byte under the same dtype tag; the JAX engine's export,
  imported by the port, continues to the JAX engine's own tokens, and so
  does a handoff between two port engines (logprobs within 1e-4).
- Torch against torch (the behaviours of `tests/test_kv_handoff.py`): the
  wire round trip, an unknown prefix, an import without a host tier, the
  continuation after leg 1 of 1 and 3 tokens against the same two-leg
  split on one engine (greedy and sampled: tokens and logprobs equal), an
  engine-allocated stream written back, and a page-floored partial hit.
- An entry the importer's cache cannot take (another dtype, depth or head
  dim, a block past its `max_seq_len`) is refused at the import, and the
  requests in flight stream on as if it had never come.
- The server's routes: `/kv_export` 404 with nothing resident, `/kv_import`
  400 on a malformed or mismatched entry and 409 without a host tier, the role on
  `/health` and `/metrics`, and an export -> import between two servers.

The control is the same two-leg split on one engine, not a one-shot run:
leg 2's first token comes from a suffix prefill there too, so the
transfer is what is compared, not decode against prefill arithmetic.
"""

import threading

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import kv_pool
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
ENGINE = dict(n_slots=2, max_seq_len=128, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)
HOST = dict(host_offload=True, host_cache_mb=8, host_min_tokens=8)
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    return jax.tree_util.tree_map(np.asarray, jax_init(jax_tiny(**KW), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(tree):
    return params_from_jax(tree, tiny_config(**KW), "cpu")


def _engine(params, **kw):
    return GenEngine(params.cfg, params=params, device="cpu", **dict(ENGINE, **kw))


def _leg(eng, ids, n, stream_id, temp, request=GenRequest):
    r = request(rid=f"leg-{stream_id}-{len(ids)}", input_ids=list(ids), max_new_tokens=n,
                temperature=temp, top_p=0.9, stream_id=stream_id)
    eng.generate_blocking([r])
    return r


def _bytes(t) -> bytes:
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def test_handoff_across_the_two_packages(tree, params):
    """One JAX engine: its f32 export decodes in the port byte for byte and,
    imported by a port engine, continues to the JAX engine's own tail; a
    port-to-port handoff gives the same tokens; a bf16 entry the JAX wire
    encoder writes decodes byte for byte too."""
    import jax.numpy as jnp

    from areal_tpu.gen import kv_pool as ref
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    prompt = np.random.default_rng(42).integers(0, 97, 27).tolist()
    jax_eng = JaxEngine(jax_tiny(**KW), params=tree, ragged_attn=True, **ENGINE)
    j1 = _leg(jax_eng, prompt, 1, 91, 0.0, JaxRequest)
    full = prompt + j1.output_tokens
    jax_doc = ref.wire_encode_entry(jax_eng.export_request_kv(full))
    j2 = _leg(jax_eng, full, 7, 91, 0.0, JaxRequest)  # the JAX engine's own tail

    entry = kv_pool.wire_decode_entry(jax_doc)
    assert kv_pool.wire_encode_entry(entry) == jax_doc  # same tags, bytes, metadata
    for k, doc in jax_doc["kv"].items():
        assert entry["kv"][k].dtype == torch.float32 and doc["dtype"] == "float32"
    dst = _engine(params, **HOST)
    assert dst.import_request_kv(entry)
    p2 = _leg(dst, full, 7, 91, 0.0)
    assert p2.cache_hit_tokens == len(prompt) and dst.stats["prefix_cache_host_swaps"] == 1
    assert p2.output_tokens == j2.output_tokens
    np.testing.assert_allclose(p2.output_logprobs, j2.output_logprobs, atol=JAX_ATOL, rtol=0)

    src, dst2 = _engine(params), _engine(params, **HOST)
    a1 = _leg(src, prompt, 1, 91, 0.0)
    assert a1.output_tokens == j1.output_tokens
    doc = kv_pool.wire_encode_entry(src.export_request_kv(full))
    assert doc["nbytes"] == jax_doc["nbytes"] and doc["tokens"] == jax_doc["tokens"]
    assert dst2.import_request_kv(kv_pool.wire_decode_entry(doc))
    assert _leg(dst2, full, 7, 91, 0.0).output_tokens == j2.output_tokens

    kv16 = {k: np.asarray(jnp.asarray(np.asarray(doc_kv)).astype(jnp.bfloat16))
            for k, doc_kv in jax_eng.export_request_kv(full)["kv"].items()}
    doc16 = ref.wire_encode_entry(dict(jax_eng.export_request_kv(full), kv=kv16))
    got16 = kv_pool.wire_decode_entry(doc16)
    for k, a in kv16.items():
        assert doc16["kv"][k]["dtype"] == "bfloat16"
        assert got16["kv"][k].dtype == torch.bfloat16
        assert tuple(got16["kv"][k].shape) == a.shape and _bytes(got16["kv"][k]) == a.tobytes()
    assert kv_pool.wire_encode_entry(got16) == doc16


# ---------------------------------------------------------------------------
# torch against torch
# ---------------------------------------------------------------------------

def test_wire_round_trip_is_bit_exact(params):
    eng = _engine(params)
    prompt = np.random.default_rng(40).integers(0, 97, 24).tolist()
    r = _leg(eng, prompt, 1, 7, 0.0)
    entry = eng.export_request_kv(prompt + r.output_tokens)
    assert entry is not None and eng.stats["kv_handoff_exports"] == 1
    assert eng.stats["kv_handoff_bytes"] == sum(v.numel() * 4 for v in entry["kv"].values())
    doc = kv_pool.wire_encode_entry(entry)
    back = kv_pool.wire_decode_entry(doc)
    assert list(back["tokens"]) == list(entry["tokens"])
    assert (back["valid_len"], back["version"], back["block"]) == (
        entry["valid_len"], entry["version"], entry["block"])
    for k, a in entry["kv"].items():
        assert back["kv"][k].dtype == a.dtype and back["kv"][k].shape == a.shape
        assert _bytes(back["kv"][k]) == _bytes(a)


def test_export_of_an_unknown_prefix_is_none(params):
    eng = _engine(params)
    assert eng.export_request_kv([11, 13, 17, 19] * 8) is None
    assert eng.stats["kv_handoff_failures"] == 1


def test_import_without_a_host_tier_is_refused(params):
    src = _engine(params)
    prompt = np.random.default_rng(41).integers(0, 97, 20).tolist()
    r = _leg(src, prompt, 1, 5, 0.0)
    dst = _engine(params)
    assert dst.import_request_kv(src.export_request_kv(prompt + r.output_tokens)) is False
    assert dst.stats["kv_handoff_failures"] == 1 and dst.stats["kv_handoff_imports"] == 0


def _mismatched(entry, fault):
    """`entry` (f32, from an engine like the importer) made unfit for the
    importer's cache in one way."""
    kv = dict(entry["kv"])
    if fault == "dtype":
        kv = {k: v.to(torch.bfloat16) for k, v in kv.items()}
    elif fault == "depth":
        kv = {k: v[:-1] for k, v in kv.items()}
    elif fault == "head_dim":
        kv = {k: v[..., :-1] for k, v in kv.items()}
    else:  # "block": an exporter with a longer --max-seq-len
        pad = ENGINE["max_seq_len"] + 16 - entry["block"]
        kv = {k: torch.cat([v, v.new_zeros((v.shape[0], pad) + v.shape[2:])], dim=1)
              for k, v in kv.items()}
        entry = dict(entry, block=ENGINE["max_seq_len"] + 16)
    return dict(entry, kv=kv)


@pytest.mark.parametrize("fault", ["dtype", "depth", "head_dim", "block"])
def test_a_mismatched_import_is_refused_and_leaves_the_engine_serving(params, fault):
    """An entry the cache cannot take is refused at the import (a failure
    counted, nothing installed); the requests in flight and a later request
    over the entry's tokens then stream as on an engine that never saw it."""
    prompt = np.random.default_rng(47).integers(0, 97, 26).tolist()
    src = _engine(params)
    r = _leg(src, prompt, 1, 21, 0.0)
    bad = _mismatched(src.export_request_kv(prompt + r.output_tokens), fault)
    rng = np.random.default_rng(48)
    others = [rng.integers(0, 97, 20).tolist() for _ in range(2)]

    def run(eng, entry):
        flight = [GenRequest(rid=f"f{i}", input_ids=ids, max_new_tokens=12, temperature=1.0,
                             top_p=0.9, stream_id=30 + i) for i, ids in enumerate(others)]
        for q in flight:
            eng.submit(q)
        eng.step(chunk=2)
        if entry is not None:
            with pytest.raises(ValueError, match="refused"):
                eng.import_request_kv(entry)
        later = GenRequest(rid="later", input_ids=prompt + r.output_tokens, max_new_tokens=6,
                           temperature=0.0, stream_id=21)
        eng.submit(later)
        while any(not q.stop_reason for q in flight + [later]):
            eng.step(chunk=2)
        return [(q.stop_reason, q.output_tokens, q.output_logprobs) for q in flight + [later]]

    eng, ref = _engine(params, **HOST), _engine(params, **HOST)
    assert run(eng, bad) == run(ref, None)
    assert eng.stats["kv_handoff_failures"] == 1 and eng.stats["kv_handoff_imports"] == 0
    # nothing landed: the host tier and every other counter as on `ref`
    assert dict(eng.stats, kv_handoff_failures=0) == ref.stats
    assert len(eng.pool.host) == len(ref.pool.host)


def test_the_import_route_refuses_a_mismatched_entry_while_serving(params):
    """`/kv_import` answers 400 for an entry of another dtype; a request the
    server was decoding meanwhile finishes as on a server that never saw it."""
    from areal_tpu_torch.gen.server import GenServer

    prompt = np.random.default_rng(49).integers(0, 97, 24).tolist()
    src = _engine(params)
    r = _leg(src, prompt, 1, 23, 0.0)
    doc = kv_pool.wire_encode_entry(_mismatched(
        src.export_request_kv(prompt + r.output_tokens), "dtype"))
    body = {"rid": "g", "input_ids": np.random.default_rng(50).integers(0, 97, 20).tolist(),
            "sampling_params": {"max_new_tokens": 40, "temperature": 1.0}, "stream_id": 31}
    outs = []
    for with_import in (True, False):
        srv = GenServer(_engine(params, **HOST), role="decode")
        srv.start()
        try:
            box = {}
            t = threading.Thread(target=lambda: box.update(out=srv.generate_many([body])[0]),
                                 daemon=True)
            t.start()
            if with_import:
                status, err = srv.kv_import(doc)
                assert status == 400 and "refused" in err["error"]
                assert srv.metrics()["kv_handoff_failures"] == 1
            t.join(60)
            outs.append((box["out"]["output_tokens"], box["out"]["output_logprobs"]))
        finally:
            srv.stop()
    assert outs[0] == outs[1] and len(outs[0][0]) == 40


@pytest.mark.parametrize("leg1_n,temp", [(1, 0.0), (1, 1.0), (3, 1.0)])
def test_handoff_continuation_equals_the_split_on_one_engine(params, leg1_n, temp):
    prompt = np.random.default_rng(42 + leg1_n).integers(0, 97, 27).tolist()
    total, sid = 8, 90 + leg1_n
    ctl = _engine(params)
    c1 = _leg(ctl, prompt, leg1_n, sid, temp)
    assert len(c1.output_tokens) == leg1_n
    c2 = _leg(ctl, prompt + c1.output_tokens, total - leg1_n, sid, temp)
    assert c2.cache_hit_tokens > 0

    ea, eb = _engine(params), _engine(params, **HOST)
    a1 = _leg(ea, prompt, leg1_n, sid, temp)
    assert (a1.output_tokens, a1.output_logprobs) == (c1.output_tokens, c1.output_logprobs)
    full = prompt + a1.output_tokens
    doc = kv_pool.wire_encode_entry(ea.export_request_kv(full))
    assert eb.import_request_kv(kv_pool.wire_decode_entry(doc))
    assert eb.stats["kv_handoff_imports"] == 1
    b2 = _leg(eb, full, total - leg1_n, sid, temp)
    assert b2.cache_hit_tokens == c2.cache_hit_tokens
    assert eb.stats["prefix_cache_host_swaps"] == 1
    assert (b2.output_tokens, b2.output_logprobs) == (c2.output_tokens, c2.output_logprobs)


def test_an_allocated_stream_is_written_back_and_continues(params):
    prompt = np.random.default_rng(44).integers(0, 97, 21).tolist()
    solo = GenRequest(rid="solo", input_ids=list(prompt), max_new_tokens=6, temperature=1.0,
                      top_p=0.9)
    _engine(params).generate_blocking([solo])
    assert solo.stream_id > 0
    ea, eb = _engine(params), _engine(params, **HOST)
    a1 = GenRequest(rid="a1", input_ids=list(prompt), max_new_tokens=1, temperature=1.0,
                    top_p=0.9)
    ea.generate_blocking([a1])
    assert a1.stream_id == solo.stream_id
    full = prompt + a1.output_tokens
    assert eb.import_request_kv(ea.export_request_kv(full))
    b2 = _leg(eb, full, 5, a1.stream_id, 1.0)
    assert a1.output_tokens + b2.output_tokens == solo.output_tokens


def test_partial_hit_is_page_floored(params):
    """A request whose donor slot a longer match claimed inherits the donor's
    prefix down to a page (37 -> 32 tokens on the 16-token grid), counted
    as a partial hit, and streams as a cold run does."""
    base = np.random.default_rng(45).integers(0, 97, 37).tolist()
    eng = _engine(params, n_slots=4)
    r0 = _leg(eng, base, 4, 11, 0.0)
    transcript = base + r0.output_tokens
    w1 = GenRequest(rid="w1", input_ids=transcript + [1], max_new_tokens=4, temperature=0.0,
                    stream_id=12, group_id="gw", group_n=2)
    w2 = GenRequest(rid="w2", input_ids=transcript + [2], max_new_tokens=4, temperature=0.0,
                    stream_id=14, group_id="gw", group_n=2)
    loser = GenRequest(rid="l", input_ids=base + [7, 8, 9], max_new_tokens=4, temperature=0.0,
                       stream_id=13)
    eng.generate_blocking([w1, w2, loser])
    assert eng.stats["prefix_cache_partial_hits"] == 1 and loser.cache_hit_tokens == 32
    cold = _engine(params, n_slots=4)
    ref = _leg(cold, base + [7, 8, 9], 4, 13, 0.0)
    assert loser.output_tokens == ref.output_tokens
    assert cold.stats["prefix_cache_partial_hits"] == 0
    eng.pool.check_page_table()


def test_server_handoff_routes(params):
    from areal_tpu_torch.gen.server import GenServer

    with pytest.raises(ValueError, match="role"):
        GenServer(_engine(params), role="router")
    src, dst = GenServer(_engine(params), role="prefill"), GenServer(_engine(params), role="both")
    host = GenServer(_engine(params, **HOST), role="decode")
    for g in (src, dst, host):
        g.start()
    try:
        prompt = np.random.default_rng(46).integers(0, 97, 30).tolist()
        assert src.kv_export({"input_ids": prompt})[0] == 404
        out = src.generate_many([{"rid": "p", "input_ids": prompt,
                                  "sampling_params": {"max_new_tokens": 1}}])[0]
        status, doc = src.kv_export({"input_ids": prompt + out["output_tokens"]})
        assert status == 200 and doc["valid_len"] == len(prompt)
        assert dst.kv_import({"tokens": []})[0] == 400
        assert dst.kv_import(doc)[0] == 409
        assert host.kv_import(doc) == (200, {"ok": True, "valid_len": len(prompt)})
        assert src.health()[1]["role"] == "prefill" and host.metrics()["role"] == "decode"
        assert host.metrics()["kv_handoff_imports"] == 1
        assert src.metrics()["kv_handoff_exports"] == 1
        assert dst.metrics()["kv_handoff_failures"] == 1
    finally:
        for g in (src, dst, host):
            g.stop()
