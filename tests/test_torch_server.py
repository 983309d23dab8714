"""The torch port's HTTP server (standard library) on the CPU, in a thread.

/generate and /generate_batch answer with every key the `generate`
contract of areal_tpu/analysis/wire_contracts.json marks required, the
request keys the JAX server reads are honoured, and pause/continue park
and resume the decode loop.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import server
from areal_tpu_torch.gen.engine import GenEngine
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _required(direction):
    with open(os.path.join(REPO, "areal_tpu", "analysis", "wire_contracts.json")) as f:
        spec = json.load(f)["endpoints"]["generate"][direction]
    return {k for k, v in spec.items() if v.get("required")}


def _call(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def live():
    cfg = tiny_config(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                      eos_token_id=None)
    engine = GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=4, max_seq_len=128,
                       prompt_bucket=16, kv_dtype="float32", device="cpu")
    ready = threading.Event()
    box = {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    yield box["httpd"]
    box["httpd"].shutdown()
    t.join(30)
    assert not t.is_alive()
    assert not box["httpd"].gen.worker.is_alive()


def _body(rid, n=9, **sp):
    ids = np.random.default_rng(len(rid)).integers(0, 97, n).tolist()
    return {"rid": rid, "input_ids": ids, "sampling_params": dict(max_new_tokens=5, **sp)}


def test_generate_answers_the_wire_contract(live):
    status, out = _call(live.port, "/generate",
                        dict(_body("a", temperature=0.0), trace_id="tr-1"))
    assert status == 200
    assert _required("response") <= set(out)
    assert len(out["output_tokens"]) == len(out["output_logprobs"]) == 5
    assert out["output_versions"] == [0] * 5 and out["stop_reason"] == "length"
    assert out["trace_id"] == "tr-1" and out["stream_id"] > 0
    assert all(lp <= 0 for lp in out["output_logprobs"])
    assert {"input_ids", "sampling_params"} == _required("request")


def test_generate_batch_and_request_keys(live):
    bodies = [_body("b0", temperature=0.0), _body("b1", temperature=1.0, top_p=0.9),
              dict(_body("b2"), stream_id=41),
              _body("b3", temperature=0.0, min_new_tokens=3, stop_token_ids=list(range(97)))]
    status, out = _call(live.port, "/generate_batch", {"requests": bodies})
    assert status == 200 and len(out["results"]) == 4
    for r in out["results"]:
        assert _required("response") <= set(r)
    assert out["results"][2]["stream_id"] == 41
    assert out["results"][3]["stop_reason"] == "stop"
    assert len(out["results"][3]["output_tokens"]) == 3
    # the same greedy request answers the same stream
    again = _call(live.port, "/generate", _body("b0", temperature=0.0))[1]
    assert again["output_tokens"] == out["results"][0]["output_tokens"]


def test_pause_parks_generation_until_continue(live):
    assert _call(live.port, "/pause_generation", {})[1] == {"ok": True}
    assert _call(live.port, "/health")[1]["status"] == "paused"
    box = {}
    t = threading.Thread(target=lambda: box.update(out=_call(
        live.port, "/generate", _body("p", temperature=0.0))[1]))
    t.start()
    t.join(0.5)
    assert t.is_alive() and "out" not in box  # parked, not dropped
    assert _call(live.port, "/continue_generation", {})[1] == {"ok": True}
    t.join(60)
    assert not t.is_alive() and len(box["out"]["output_tokens"]) == 5
    health = _call(live.port, "/health")[1]
    assert health["status"] == "ok" and health["active"] == 0


def test_bad_requests(live):
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(live.port, "/generate_batch", {"requests": []})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(live.port, "/nope", {})
    assert e.value.code == 404


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--n-slots", "2", "--max-seq-len", "64"])
