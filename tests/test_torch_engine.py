"""The torch port's generation engine — the whole serving slice — against
the JAX package's `GenEngine(ragged_attn=True)`, and the port's own
invariants.

Both engines get the same weights (the JAX tree through the port's weight
bridge) and the same requests, in f32 on the CPU.  Greedy streams must be
equal and logprobs agree to 1e-4 (f32 forward in another op order, see
test_torch_model.py).  Sampled streams are checked torch against torch:
a request's stream does not depend on what it is batched with.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import build_model, init_params

ATOL = 1e-4
KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)
ENGINE = dict(n_slots=4, max_seq_len=256, prompt_bucket=16, kv_dtype="float32", seed=3)
# (prompt length, max_new_tokens, extra request fields)
SPECS = [
    (10, 6, {}),
    (24, 30, {}),
    (7, 12, {"stop_token_ids": list(range(0, 97, 2)), "min_new_tokens": 3}),
    (40, 9, {}),
    (5, 20, {}),
    (33, 1, {}),
]


def _requests(cls, temperature=0.0, top_p=1.0, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(rid=f"r{i}", input_ids=rng.integers(0, 97, n).tolist(), max_new_tokens=m,
                temperature=temperature, top_p=top_p, **extra)
            for i, (n, m, extra) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def weights():
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**KW)
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for k in ("bq", "bk", "bv"):
        tree["layers"]["attn"][k] = (0.5 * rng.standard_normal(
            tree["layers"]["attn"][k].shape)).astype(np.float32)
    cfg = tiny_config(**KW)
    return jcfg, tree, cfg


def _port_engine(weights, **kw):
    _, tree, cfg = weights
    return GenEngine(cfg, params=params_from_jax(tree, cfg, "cpu"), device="cpu",
                     **dict(ENGINE, **kw))


def test_greedy_streams_match_jax_engine(weights):
    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.engine import GenRequest as JaxRequest

    jcfg, tree, _ = weights
    jax_eng = JaxEngine(jcfg, params=tree, ragged_attn=True, kv_reuse=False,
                        share_prefix=False, **ENGINE)
    want = jax_eng.generate_blocking(_requests(JaxRequest))
    eng = _port_engine(weights)
    got = eng.generate_blocking(_requests(GenRequest))
    assert jax_eng._ragged_ok and jax_eng.stats["ragged_dispatches"] > 0
    for w, g in zip(want, got):
        assert g.output_tokens == w.output_tokens, g.rid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=ATOL, rtol=0)
        assert g.stop_reason == w.stop_reason, g.rid
    assert got[2].stop_reason == "stop" and len(got[5].output_tokens) == 1
    assert eng.stats["ragged_dispatches"] == eng.stats["decode_calls"] > 0
    assert eng.stats["decode_steps"] == eng.stats["decode_calls"] * eng.decode_chunk
    assert eng.stats["ragged_attended_pages"] > 0
    assert eng.stats["prefill_calls"] >= 1


def test_sampled_stream_does_not_depend_on_batching(weights):
    """Counter-keyed sampling: a request decoded alone and in a full grid
    (another slot, other neighbours, different prefill batch) emits the
    same tokens when its stream id is pinned."""
    eng = _port_engine(weights)
    crowd = _requests(GenRequest, temperature=1.0, top_p=0.9)
    crowd[1].stream_id = 77
    eng.generate_blocking(crowd)
    alone = _requests(GenRequest, temperature=1.0, top_p=0.9)[1]
    alone.stream_id = 77
    _port_engine(weights).generate_blocking([alone])
    assert alone.output_tokens == crowd[1].output_tokens
    np.testing.assert_allclose(alone.output_logprobs, crowd[1].output_logprobs, atol=1e-6)
    assert len({tuple(r.output_tokens) for r in crowd}) == len(crowd)


def test_abort_all_finishes_queued_and_running(weights):
    eng = _port_engine(weights, n_slots=2)
    reqs = _requests(GenRequest)
    done = []
    for r in reqs:
        r.on_done = done.append
        eng.submit(r)
    eng.step()  # two admitted and decoding, the rest queued
    n_running = sum(r is not None for r in eng.slot_req)
    assert n_running >= 1
    left = sum(not r.stop_reason for r in reqs)
    assert eng.abort_all() == left
    assert all(r.stop_reason for r in reqs) and len(done) == len(reqs)
    assert eng.active_count() == 0 and eng.step() == 0


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenEngine(tiny_config(**KW), n_slots=2, max_seq_len=64)


def test_oversized_window_raises_at_init():
    """The engine checks the ragged kernel's gate once, at init, and raises.
    The kernel splits the key window into fixed chunks, so no window outgrows
    a block's shared memory; what can is a kv head's query rows at a wide
    head dim (256 q heads over one kv head at hd 256), even at a 65536 window."""
    cfg = tiny_config(**KW, num_heads=256, num_kv_heads=1, head_dim=256)
    with pytest.raises(ValueError, match="shared memory"):
        GenEngine(cfg, params=init_params(cfg, 0, "cpu"), n_slots=2, max_seq_len=1 << 16,
                  device="cpu")


def test_prompt_too_long_finishes_with_length(weights):
    eng = _port_engine(weights)
    r = GenRequest(rid="long", input_ids=[1] * 300, max_new_tokens=4)
    eng.submit(r)
    assert r.stop_reason == "length" and not r.output_tokens


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: decode attention there is the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_engine_matches_cpu_engine(cuda_device):
    """Greedy streams on the card (CUDA kernel) equal the CPU's (plain
    version), logprobs to 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config(**KW)
    cpu_model = init_params(cfg, 5, "cpu")
    gpu_model = build_model(cfg, cuda_device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda_device)):
        eng = GenEngine(cfg, params=model, device=dev, **ENGINE)
        outs.append(eng.generate_blocking(_requests(GenRequest)))
    for a, b in zip(*outs):
        assert a.output_tokens == b.output_tokens
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs, atol=ATOL)
