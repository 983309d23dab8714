"""The engine's staged weight swap (`GenEngine.stage_params`,
`staged_version`, `has_standby`, `commit_staged`) and the server's
transfer publish through it (`/update_weights_chunk` prepare and commit).

- The behaviours of `tests/test_gen_engine.py`'s standby case: a strict
  live swap clears the retained prefixes and drops an older standby, so a
  later commit can never roll the version back; a strictly newer standby
  survives an older publish and commits.
- A live commit keeps in-flight requests decoding (their per-token
  versions record the swap), an aborting one finishes them; each records
  its pause kind.  Staging from another thread while the engine steps.
- A standby that does not fit: `stage_params` answers False and the server
  says `"staged": false`, shows 0 on `areal_gen_staged_standby`, and its
  commit places the kept host copy.  The version-mismatch 409 keeps the
  standby; a retried commit of the live version answers 200.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import server
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.telemetry import parse_prometheus_text
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
ENGINE = dict(n_slots=4, max_seq_len=128, prompt_bucket=16, kv_dtype="float32",
              reuse_min_tokens=4)


def _params(seed):
    return init_params(tiny_config(**KW), seed, "cpu")


def _engine(seed=0, **kw):
    params = _params(seed)
    return GenEngine(params.cfg, params=params, device="cpu", **dict(ENGINE, **kw))


def _host(model):
    """HF-named host tensors, as a transfer publish assembles them."""
    return {n: p.detach().clone() for n, p in model.state_dict().items()}


def _reqs(n, new=12, seed=1):
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=f"r{i}", input_ids=rng.integers(0, 97, 10).tolist(),
                       max_new_tokens=new, temperature=0.0) for i in range(n)]


def _weights_equal(model, host):
    return all(torch.equal(p, host[n]) for n, p in model.state_dict().items())


def test_a_standby_never_rolls_the_version_back():
    eng = _engine(retain_kv_on_reload=False)
    eng.generate_blocking(_reqs(1, new=4))
    assert eng.retained_len.any()
    assert eng.stage_params(_params(7), version=1) and eng.has_standby
    assert eng.staged_version == 1
    eng.swap_weights_live(_params(8), version=2)
    assert not eng.retained_len.any()  # strict mode: no prefix survives
    assert not eng.has_standby and eng.staged_version is None and eng.version == 2
    with pytest.raises(RuntimeError):
        eng.commit_staged()
    # a strictly newer standby survives an older publish (staged v6 while a
    # v5 disk publish lands) and commits
    newer = _params(9)
    assert eng.stage_params(newer, version=6)
    eng.load_weights(model=_params(8), version=5)
    assert eng.has_standby and eng.staged_version == 6
    assert eng.commit_staged() == 6 and eng.model is newer and not eng.has_standby


@pytest.mark.parametrize("live", [True, False], ids=["live", "abort"])
def test_commit_live_keeps_requests_and_abort_finishes_them(live):
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    telemetry.EVENTS.clear()
    try:
        eng = _engine()
        reqs = _reqs(3)
        for r in reqs:
            eng.submit(r)
        eng.step(chunk=2)
        host = _host(_params(3))
        assert eng.stage_params(host, version=4)  # host tensors: placed on the device
        assert eng.model is not None and not _weights_equal(eng.model, host)
        eng.step(chunk=2)  # decoding goes on beside the standby
        assert eng.commit_staged(live=live) == 4
        assert _weights_equal(eng.model, host) and not eng.has_standby
        while any(not r.stop_reason for r in reqs):
            eng.step()
        pauses = [e for e in telemetry.EVENTS.snapshot() if e["event"] == "pause"]
    finally:
        telemetry.set_enabled(was)
        telemetry.EVENTS.clear()
    assert [(e["kind"], e["version_before"], e["version_after"]) for e in pauses] == [
        ("commit_live" if live else "commit_abort", 0, 4)]
    for r in reqs:
        if live:
            assert r.stop_reason == "length" and len(r.output_tokens) == 12
            assert r.output_versions[0] == 0 and r.output_versions[-1] == 4
            assert r.output_versions == sorted(r.output_versions)
        else:
            assert r.stop_reason == "abort" and set(r.output_versions) == {0}


def test_staging_on_another_thread_while_the_engine_steps():
    eng = _engine()
    reqs = _reqs(4, new=60)
    for r in reqs:
        eng.submit(r)
    eng.step(chunk=1)
    box = {}
    staged_model = _params(5)
    t = threading.Thread(target=lambda: box.update(ok=eng.stage_params(staged_model, 1)))
    t.start()
    while t.is_alive():
        eng.step(chunk=1)
    t.join()
    assert box["ok"] and eng.staged_version == 1
    assert eng.commit_staged(live=True) == 1 and eng.model is staged_model
    while any(not r.stop_reason for r in reqs):
        eng.step()
    assert all(len(r.output_tokens) == 60 for r in reqs)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _boot(engine):
    ready, box = threading.Event(), {}

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    t = threading.Thread(target=server.serve, args=(engine,),
                         kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    t.start()
    assert ready.wait(60)
    return box["httpd"], t


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.read()


def _push(port, model):
    """Every weight as one JSON chunk (the transfer publish's JSON form)."""
    for name, p in model.state_dict().items():
        raw = p.detach().contiguous().view(torch.uint8).numpy().tobytes()
        assert _post(port, "/update_weights_chunk", {
            "name": name, "dtype": str(p.dtype).split(".")[-1], "shape": list(p.shape),
            "nbytes": len(raw), "offset": 0,
            "data_b64": base64.b64encode(raw).decode()})[0] == 200


def _staged_gauge(port):
    text = _get(port, "/metrics?format=prometheus").decode()
    return parse_prometheus_text(text)["areal_gen_staged_standby"][""]


@pytest.mark.parametrize("fits", [True, False], ids=["staged", "unstaged"])
def test_server_prepare_and_commit_through_the_engine(fits, monkeypatch):
    eng = _engine()
    httpd, t = _boot(eng)
    port = httpd.port
    try:
        if not fits:
            def no_room(params):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
            monkeypatch.setattr(eng, "place_params", no_room)
        new = _params(11)
        _push(port, new)
        status, out = _post(port, "/update_weights_chunk", {"prepare": True, "version": 3})
        assert status == 200 and out == {"ok": True, "staged": fits}
        m = json.loads(_get(port, "/metrics"))
        assert m["staged"] is fits and m["version"] == 0 and _staged_gauge(port) == float(fits)
        # a commit of another version is refused and keeps what is staged
        assert _post(port, "/update_weights_chunk", {"commit": True, "version": 4})[0] == 409
        assert eng.has_standby is fits
        monkeypatch.undo()  # the unstaged commit places the kept host copy
        status, out = _post(port, "/update_weights_chunk", {"commit": True, "version": 3,
                                                           "live": True})
        assert status == 200 and out["version"] == 3
        assert eng.version == 3 and not eng.has_standby and _staged_gauge(port) == 0.0
        assert _weights_equal(eng.model, _host(new))
        # the retry of a commit whose answer was lost: that version is live
        assert _post(port, "/update_weights_chunk", {"commit": True, "version": 3}) == (
            200, {"ok": True, "version": 3})
        status, out = _post(port, "/generate", {"rid": "g", "input_ids": [1, 2, 3],
                                                "sampling_params": {"max_new_tokens": 3}})
        assert status == 200 and out["output_versions"] == [3, 3, 3]
    finally:
        httpd.shutdown()
        t.join(30)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the standby is built on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_staging_on_the_card_lands_the_host_bytes(cuda_device):
    """Host tensors staged on the card while the engine decodes land
    bit-equal."""
    cfg = tiny_config(**KW).replace(dtype="bfloat16")
    params = init_params(cfg, 0, "cuda")
    eng = GenEngine(cfg, params=params, **dict(ENGINE, kv_dtype="bfloat16"))
    reqs = _reqs(4, new=40)
    for r in reqs:
        eng.submit(r)
    eng.step(chunk=2)
    host = {n: t.cpu() for n, t in _host(init_params(cfg, 4, "cpu")).items()}
    assert eng.stage_params(host, version=1)
    while any(not r.stop_reason for r in reqs):
        eng.step()
    assert eng.commit_staged(live=True) == 1
    assert all(torch.equal(p.cpu(), host[n]) for n, p in eng.model.state_dict().items())
