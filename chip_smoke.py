#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`areal_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name
2. build    nvcc builds every kernel of the serving and training paths from
            the sources in this checkout, one nvcc per source, all at once
            (-Xptxas -v report printed)
3. kernels  each kernel against its plain PyTorch version.  Ragged decode at
            the serving shapes (Qwen2.5-1.5B decode: B=16, T=1, Hq=12,
            Hkv=2, hd=128, bf16, page 128, K in {128, 2048}; T=4 at K=512;
            softcap 30 at K=128; one f32 case; the appended cache bit for
            bit).  Flash forward, dq and dk/dv at Qwen2.5's training heads
            (Hq=12, Hkv=2, hd=128, bf16): T=2048 packed with 3 segments and
            tail padding, T=1024 one segment, window 256, softcap 30, and f32
            at T=256; two dk/dv runs equal bit for bit
4. engine   a tiny f32 model served by the port's engine on the card and on
            the CPU: greedy streams equal, logprobs within 1e-4
5. serve    random seeded bf16 Qwen2.5-1.5B weights at full width (28
            layers), written as an HF checkpoint by the port's writer, served
            through `areal_tpu_torch.gen.server.main` over HTTP: 8 /generate
            and one /generate_batch of 4, 64 tokens each, half greedy; the
            kernel's launch count must equal 28 x the engine's decode steps
6. timings  ragged kernel, plain version and torch SDPA on the serving
            shapes (CUDA events), the kernel's bound, decode tokens/s
7. train    the PPO actor on the serve phase's checkpoint at full width (f32
            masters, bf16 compute, full remat) beside a server of the same
            checkpoint: 8 prompts x group 4 rolled out over HTTP (256 new
            tokens each), the trainer's logprobs against the server's,
            advantages, 3 PPO updates (loss, grad norm, tokens/s, MFU), the
            policy moving along the advantages, exact flash launch counts,
            and the new weights published to the server and read back
8. flash timings  on the train phase's packed rows (bf16, T=1024, Hq=12,
            Hkv=2, hd=128): each flash kernel against its plain version,
            then the kernel, its plain version and torch SDPA (the forward,
            and forward + backward) timed, with each bound

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.
"""

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.gen import server as gen_server
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.models.model_config import qwen25_1p5b, tiny_config
from areal_tpu_torch.models.transformer import build_model, init_params
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops.ragged_decode import (
    _copied_end,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
BF16_ATOL = BF16_RTOL = 2e-2  # see check_kernel
SERVE_LAYERS = 28


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name} done in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------


def ragged_case(seed, *, B=16, T=1, Hq=12, Hkv=2, hd=128, K=2048, M=2048,
                page=128, dtype=torch.bfloat16, lengths=None, dev="cuda"):
    """Inputs of one ragged call: permuted page-table rows, lengths with 0
    and K - T, one dropped write position (index M)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    S = B + 1

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    if lengths is None:
        lengths = torch.randint(0, K - T + 1, (B,), generator=g)
        lengths[0], lengths[1] = 0, K - T
    pos = lengths.to(torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)[None, :]
    mask = torch.arange(K)[None, None, :] <= pos[:, :, None]
    widx = pos.clone()
    widx[2, -1] = M  # a dropped write (idle slot / short draft padding)
    return dict(
        q=randn(B, T, Hq, hd), k_new=randn(B, T, Hkv, hd), v_new=randn(B, T, Hkv, hd),
        ck=randn(S, M, Hkv, hd), cv=randn(S, M, Hkv, hd),
        rows=torch.randperm(S, generator=g)[:B].to(torch.int32).to(dev),
        lengths=lengths.to(torch.int32).to(dev), widx=widx.to(dev), mask=mask.to(dev),
        key_window=K, page_size=page,
    )


def _run(fn, case, softcap=None):
    args = dict(case, ck=case["ck"].clone(), cv=case["cv"].clone())
    return fn(**args, logit_softcap=softcap)


def check_kernel():
    """Kernel against plain version.  bf16 tolerance: both round the f32
    scores and the probabilities to bf16, after f32 sums taken in another
    order (warp shuffles against cuBLAS), so an element can land one bf16
    step apart; a few such steps stay well inside 2e-2 at these magnitudes.
    f32: 1e-5.  The appended cache must be equal bit for bit."""
    cases = [
        ("T=1 K=128", dict(K=128), None),
        ("T=1 K=2048", dict(K=2048), None),
        ("T=4 K=512", dict(T=4, K=512), None),
        ("softcap 30 K=128", dict(K=128), 30.0),
        ("f32 T=1 K=256", dict(K=256, dtype=torch.float32), None),
    ]
    worst = 0.0
    for i, (name, kw, softcap) in enumerate(cases):
        case = ragged_case(100 + i, **kw)
        got, want = _run(ragged_paged_attention, case, softcap), _run(
            ragged_paged_attention_plain, case, softcap)
        torch.cuda.synchronize()
        f32 = case["q"].dtype == torch.float32
        atol, rtol = (1e-5, 1e-5) if f32 else (BF16_ATOL, BF16_RTOL)
        err = (got[0].float() - want[0].float()).abs()
        bad = err > atol + rtol * want[0].float().abs()
        max_err = float(err.max())
        if not f32:
            worst = max(worst, max_err)
        cache_ok = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        print(f"  {name}: max|out - plain| = {max_err:.3e} "
              f"(atol {atol}, rtol {rtol}), {int(bad.sum())} outside, "
              f"cache equal: {cache_ok}")
        if bad.any() or not cache_ok or not torch.isfinite(got[0]).all():
            raise AssertionError(f"ragged kernel disagrees with its plain version: {name}")
    return worst


def packed_segments(T, seg_lens):
    """int32 [1, T] segment ids: contiguous segments of `seg_lens`, the
    rest tail padding (-1)."""
    seg = torch.full((1, T), -1, dtype=torch.int32)
    start = 0
    for s, n in enumerate(seg_lens):
        seg[0, start:start + n] = s
        start += n
    return seg


def flash_case(seed, seg, *, Hq=12, Hkv=2, hd=128, dtype=torch.bfloat16, dev="cuda"):
    """Pre-scaled q_s, k, v and an output cotangent for packed rows `seg`."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, T = seg.shape

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    qs = fa.scale_query(randn(B, T, Hq, hd))
    return qs, randn(B, T, Hkv, hd), randn(B, T, Hkv, hd), randn(B, T, Hq, hd), seg.to(dev)


def compare_flash(name, qs, k, v, dout, sg, window=None, softcap=None):
    """Flash forward, dq and dk/dv against their plain versions on the
    valid rows of one input.  bf16: both round the f32 results once to bf16
    after f32 sums in another order (an online softmax over 64-key tiles
    against one pass), so an element can land a bf16 step or two apart:
    2e-2, like the ragged check (out: absolute plus relative; gradients:
    relative to the largest element).  f32: 1e-5 on out, 1e-4 relative to
    the largest element on gradients.  Two dk/dv runs must be equal bit for
    bit (no atomics).  Returns |kernel - plain| of out, dq and dk/dv."""
    out, lse = fa.flash_fwd(qs, k, v, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, window, softcap)
    p_out, p_lse = fa.flash_fwd_plain(qs, k, v, sg, window, softcap)
    p_dq = fa.flash_bwd_dq_plain(qs, k, v, sg, dout, p_lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, p_lse, di, window, softcap)
    torch.cuda.synchronize()
    f32 = qs.dtype == torch.float32
    valid = sg >= 0  # [B, T]
    err = (out.float() - p_out.float()).abs()[valid]
    atol, rtol = (1e-5, 1e-5) if f32 else (BF16_ATOL, BF16_RTOL)
    bad = int((err > atol + rtol * p_out.float().abs()[valid]).sum())
    grad_tol = 1e-4 if f32 else BF16_RTOL
    rels, abss = [], []
    for a, b in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        diff = (a.float() - b.float()).abs()
        rels.append(float(diff.max() / b.float().abs().max()))
        abss.append(float(diff.max()))
    rerun_equal = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    print(f"  {name}: max|out - plain| = {float(err.max()):.3e} ({bad} outside atol "
          f"{atol} rtol {rtol}); dq, dk, dv max|diff|/max = "
          f"{rels[0]:.2e}, {rels[1]:.2e}, {rels[2]:.2e} (tol {grad_tol}); "
          f"dk/dv reruns equal: {rerun_equal}")
    finite = all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
    if bad or max(rels) > grad_tol or not rerun_equal or not finite:
        raise AssertionError(f"flash kernels disagree with their plain versions: {name}")
    return {"flash_fwd": float(err.max()), "flash_bwd_dq": abss[0],
            "flash_bwd_dkv": max(abss[1], abss[2])}


def check_flash():
    """`compare_flash` on single packed rows at Qwen2.5's heads: several
    segments with tail padding, one segment, a window, a softcap, and f32.
    Returns the worst bf16 |kernel - plain| per kernel."""
    cases = [
        ("T=2048, 3 segments + padding", packed_segments(2048, [700, 900, 300]), {}),
        ("T=1024, one segment", packed_segments(1024, [1024]), {}),
        ("T=1024, window 256", packed_segments(1024, [600, 380]), dict(window=256)),
        ("T=1024, softcap 30", packed_segments(1024, [600, 380]), dict(softcap=30.0)),
        ("f32 T=256", packed_segments(256, [100, 140]), dict(dtype=torch.float32)),
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for i, (name, seg, kw) in enumerate(cases):
        dtype = kw.get("dtype", torch.bfloat16)
        qs, k, v, dout, sg = flash_case(200 + i, seg, dtype=dtype)
        errs = compare_flash(name, qs, k, v, dout, sg, kw.get("window"), kw.get("softcap"))
        if dtype != torch.float32:
            worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


# ---------------------------------------------------------------------------
# engine on the card against the engine on the CPU (small input)
# ---------------------------------------------------------------------------


def check_engine():
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    cfg = tiny_config(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                      eos_token_id=None)
    cpu_model = init_params(cfg, seed=5, device="cpu")
    gpu_model = build_model(cfg, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())

    def run(model, device):
        eng = GenEngine(cfg, params=model, n_slots=4, max_seq_len=256, prompt_bucket=16,
                        kv_dtype="float32", seed=3, device=device)
        rng = np.random.default_rng(11)
        reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, 97, n).tolist(),
                           max_new_tokens=m, temperature=0.0)
                for i, (n, m) in enumerate([(10, 6), (24, 30), (7, 12), (40, 9), (5, 20)])]
        eng.generate_blocking(reqs)
        return reqs

    for a, b in zip(run(cpu_model, "cpu"), run(gpu_model, "cuda")):
        dlp = float(np.abs(np.subtract(a.output_logprobs, b.output_logprobs)).max())
        if a.output_tokens != b.output_tokens or dlp > 1e-4:
            raise AssertionError(f"request {a.rid}: card and CPU engines disagree "
                                 f"(tokens equal {a.output_tokens == b.output_tokens}, "
                                 f"max |dlogprob| {dlp:.2e})")
    print("  greedy streams equal on card and CPU, logprobs within 1e-4")


# ---------------------------------------------------------------------------
# serving at full width
# ---------------------------------------------------------------------------


def post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def running_server(argv):
    """`areal_tpu_torch.gen.server.main(argv)` on a thread; yields the HTTP
    server and stops it (and its worker) on exit."""
    ready = threading.Event()
    holder = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    def run_server():
        try:
            gen_server.main(argv, on_ready=on_ready)
        except BaseException as e:  # surfaced to the main thread below
            holder["error"] = e
            ready.set()

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    ready.wait(900)
    if "httpd" not in holder:
        raise RuntimeError(f"server did not start: {holder.get('error')!r}")
    try:
        yield holder["httpd"]
    finally:
        holder["httpd"].shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")


def serve_qwen(ckpt_dir):
    """Drive the port's server over HTTP; returns (engine, launches,
    decode steps, wall seconds, tokens)."""
    cfg = qwen25_1p5b()
    model = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    save_hf_checkpoint(model, ckpt_dir)
    del model
    torch.cuda.empty_cache()
    print(f"  checkpoint written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots", "16",
                         "--max-seq-len", "2048"]) as httpd:
        engine = httpd.gen.engine
        print(f"  server up (checkpoint loaded) in {time.perf_counter() - t0:.1f} s "
              f"on port {httpd.port}")
        rng = np.random.default_rng(0)
        bodies = []
        for i in range(12):
            greedy = i % 2 == 0
            sp = dict(max_new_tokens=64, min_new_tokens=64,
                      temperature=0.0 if greedy else 1.0, top_p=1.0 if greedy else 0.9)
            ids = rng.integers(0, cfg.vocab_size, int(rng.integers(64, 901))).tolist()
            bodies.append(dict(rid=f"r{i}", input_ids=ids, sampling_params=sp))
        bodies[2]["input_ids"] = list(bodies[0]["input_ids"])  # identical greedy pair
        ragged_paged_attention.launches = 0
        steps0 = engine.stats["decode_steps"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(9) as pool:
            singles = [pool.submit(post, httpd.port, "/generate", b) for b in bodies[:8]]
            batch = pool.submit(post, httpd.port, "/generate_batch", {"requests": bodies[8:]})
            results = [f.result() for f in singles] + batch.result()["results"]
        wall = time.perf_counter() - t0
        launches = ragged_paged_attention.launches
        steps = engine.stats["decode_steps"] - steps0
        health = get(httpd.port, "/health")
    for b, r in zip(bodies, results):
        lp = np.asarray(r["output_logprobs"], np.float64)
        if len(r["output_tokens"]) != 64 or len(lp) != 64:
            raise AssertionError(f"{b['rid']}: {len(r['output_tokens'])} tokens, want 64")
        if not (np.isfinite(lp).all() and (lp <= 0).all()):
            raise AssertionError(f"{b['rid']}: logprobs not finite and <= 0")
    if results[0]["output_tokens"] != results[2]["output_tokens"]:
        raise AssertionError("identical greedy requests returned different streams")
    print(f"  12 requests x 64 tokens in {wall:.2f} s; health {health}")
    print(f"  kernel launches {launches}, decode steps {steps}, "
          f"{SERVE_LAYERS} x steps = {SERVE_LAYERS * steps}")
    if steps == 0 or launches != SERVE_LAYERS * steps:
        raise AssertionError("the serving path did not run every decode layer "
                             "through the ragged kernel")
    return engine, launches, steps, wall, sum(len(r["output_tokens"]) for r in results)


def decode_rate(eng, prompt=512, new=64):
    """Steady decode tokens/s of an idle engine filled to its full slot
    grid (the first step, prefill and one chunk, is not timed)."""
    n_slots = eng.n_slots
    rng = np.random.default_rng(1)
    reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, 151936, prompt).tolist(),
                       max_new_tokens=new, temperature=0.0) for i in range(n_slots)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # admission (prefill) + the first chunk
    torch.cuda.synchronize()
    t0, tokens = time.perf_counter(), 0
    while any(not r.stop_reason for r in reqs):
        tokens += eng.step()
    torch.cuda.synchronize()
    return tokens / (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# training at full width
# ---------------------------------------------------------------------------

TRAIN_PROMPTS, GROUP, NEW_TOKENS, ROW_LEN = 8, 4, 256, 1024
# mean |trainer logprob - server logprob| over the completions.  Both sides
# run bf16 on the same weights, but through different attention (naive
# prefill and the ragged kernel, probabilities rounded to bf16, against the
# flash kernels with f32 probabilities) and different head arithmetic
# (one bf16 product against vocab chunks): bf16 logits carry a relative
# rounding of 2^-8, a few hundredths on logits of a few units, so the mean
# should sit near 1e-2; 5e-2 leaves room without hiding a wrong position or
# a wrong token, which would cost whole nats.
LOGP_MEAN_TOL = 5e-2


def flash_counts():
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)


def reset_flash_counts():
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def rollout_batch(results, prompts, rewards):
    """Padded, token-aligned training batch from the server's answers."""
    seqs = [p + r["output_tokens"] for p, r in zip(prompts, results)]
    B, L = len(seqs), max(len(x) for x in seqs)
    batch = {
        "input_ids": np.zeros((B, L), np.int32),
        "attention_mask": np.zeros((B, L), bool),
        "loss_mask": np.zeros((B, L), np.float32),
        "logprobs": np.zeros((B, L), np.float32),
        "rewards": np.asarray(rewards, np.float32),
    }
    for i, (p, r) in enumerate(zip(prompts, results)):
        n, P = len(seqs[i]), len(p)
        batch["input_ids"][i, :n] = seqs[i]
        batch["attention_mask"][i, :n] = True
        batch["loss_mask"][i, P:n] = 1.0
        batch["logprobs"][i, P:n] = r["output_logprobs"]
    return batch


def train_qwen(ckpt_dir, publish_dir):
    """The training half of the main path at full width: rollouts from the
    port's server, the PPO actor's logprobs, advantages and updates, and
    the new weights published back to the server.  Returns the flash
    launch counts of the whole phase and the packed segment ids of one
    training micro-batch."""
    cfg = qwen25_1p5b()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(128, 513))).tolist()
               for _ in range(TRAIN_PROMPTS)]
    reset_flash_counts()
    counts = np.zeros(3, np.int64)
    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots",
                         str(TRAIN_PROMPTS * GROUP), "--max-seq-len", str(ROW_LEN)]) as httpd:
        port = httpd.port
        print(f"  server up in {time.perf_counter() - t0:.1f} s")

        # 1. rollouts: 8 prompts x group 4 over HTTP
        sp = dict(max_new_tokens=NEW_TOKENS, min_new_tokens=NEW_TOKENS, temperature=1.0,
                  top_p=1.0)
        bodies = [dict(rid=f"p{i}g{j}", input_ids=p, sampling_params=sp)
                  for i, p in enumerate(prompts) for j in range(GROUP)]
        t0 = time.perf_counter()
        results = post(port, "/generate_batch", {"requests": bodies})["results"]
        wall = time.perf_counter() - t0
        n_tok = sum(len(r["output_tokens"]) for r in results)
        if any(len(r["output_tokens"]) != NEW_TOKENS for r in results):
            raise AssertionError("a rollout did not return 256 tokens")
        print(f"  rollouts: {len(results)} x {NEW_TOKENS} tokens in {wall:.2f} s "
              f"({n_tok / wall:.1f} tokens/s)")

        # 2. reward: 1 when most completion ids are even
        rewards = [float(np.mean(np.asarray(r["output_tokens"]) % 2 == 0) > 0.5)
                   for r in results]
        batch = rollout_batch(results, [b["input_ids"] for b in bodies], rewards)
        print(f"  batch {batch['input_ids'].shape}, {int(batch['attention_mask'].sum())} "
              f"tokens, mean reward {np.mean(rewards):.3f}")

        # 3. the actor on the same checkpoint: f32 masters, bf16 compute
        t0 = time.perf_counter()
        actor = TorchPPOActor(PPOActorConfig(
            init_from_scratch=False,
            path=ckpt_dir, dtype="bfloat16", gradient_checkpointing=True,
            group_size=GROUP, ppo_n_minibatches=2, use_decoupled_loss=True,
            recompute_logprob=True, pack_length_quantum=ROW_LEN, max_pack_length=ROW_LEN,
            adv_norm=NormConfig(mean_level="group", std_level="group"),
            optimizer=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ))
        actor.initialize(ft_spec=FinetuneSpec(1, len(bodies), len(bodies)))
        torch.cuda.synchronize()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card")

        # 4. logprobs: trainer against server on the completion tokens
        t0 = time.perf_counter()
        before = flash_counts()
        batch["prox_logp"] = actor.compute_logp(batch)
        got = tuple(int(x) for x in np.subtract(flash_counts(), before))
        print(f"  compute_logp in {time.perf_counter() - t0:.2f} s; flash launches "
              f"fwd/dq/dkv {got}")
        if got != (SERVE_LAYERS, 0, 0):
            raise AssertionError("compute_logp did not run 28 flash forwards")
        counts += got
        mask = batch["loss_mask"] > 0
        served = np.roll(batch["logprobs"], -1, axis=-1)[np.roll(mask, -1, axis=-1)]
        mine = batch["prox_logp"][np.roll(mask, -1, axis=-1)]
        dlp = np.abs(mine - served)
        print(f"  |trainer - server| logprob: max {dlp.max():.4f}, mean {dlp.mean():.4f} "
              f"(tolerance on the mean {LOGP_MEAN_TOL})")
        if not np.isfinite(mine).all() or dlp.mean() > LOGP_MEAN_TOL:
            raise AssertionError("trainer logprobs disagree with the server's")

        # 5. advantages and 3 PPO updates
        actor.compute_advantages(batch)
        view = {k: batch[k] for k in actor.actor.LOSS_KEYS if k in batch}
        mbs = split_padded_tensor_dict_into_mb_list(
            view, n_mbs=actor.config.ppo_n_minibatches).mbs  # as ppo_update splits
        mb_tokens = [int(mb["attention_mask"].sum()) for mb in mbs]
        seg_rows = actor._prepare_rows(mbs[0], actor.config.mb_spec.n_mbs)[1]["segment_ids"]
        stats = []
        for step in range(3):
            before = flash_counts()
            st = actor.ppo_update(batch)
            got = tuple(int(x) for x in np.subtract(flash_counts(), before))
            n_mb = len(st) * actor.config.mb_spec.n_mbs
            want = (2 * SERVE_LAYERS * n_mb, SERVE_LAYERS * n_mb, SERVE_LAYERS * n_mb)
            for s_, toks in zip(st, mb_tokens):
                s_["tokens_per_s"] = toks / s_["step_time"]
                print(f"  update {step}: loss {s_['loss']:+.5f} grad_norm "
                      f"{s_['grad_norm']:.4f} step_time {s_['step_time']:.3f} s "
                      f"train tokens/s {s_['tokens_per_s']:.1f} "
                      f"mfu {s_.get('mfu', float('nan')):.4f}")
                if not all(np.isfinite(s_[k]) for k in ("loss", "grad_norm", "step_time")):
                    raise AssertionError("a PPO step returned a non-finite stat")
            print(f"    flash launches fwd/dq/dkv {got}, want {want} "
                  f"({n_mb} micro-batches)")
            if got != want:
                raise AssertionError("a training layer's attention missed the flash kernels")
            counts += got
            stats += st

        # 6. the policy moved along the advantages
        before = flash_counts()
        new_logp = actor.compute_logp(batch)
        counts += np.subtract(flash_counts(), before)
        lm = batch["loss_mask"] > 0
        gain = float(np.sum((batch["advantages"] * (new_logp - batch["prox_logp"]))[lm]))
        print(f"  sum adv * (logp_new - logp_prox) over the loss mask: {gain:.4f}")
        if not gain > 0:
            raise AssertionError("the updates did not move the policy along the advantages")

        # 7. publish: disk snapshot -> /update_weights_from_disk
        actor.set_version(1)
        t0 = time.perf_counter()
        actor.update_weights(WeightUpdateMeta(type="disk", path=publish_dir))
        reply = post(port, "/update_weights_from_disk", {"path": publish_dir, "version": 1})
        health = get(port, "/health")
        print(f"  published and reloaded in {time.perf_counter() - t0:.1f} s: {reply}, "
              f"server version {health['version']}")
        if reply.get("version") != actor.get_version() or health["version"] != 1:
            raise AssertionError("the server did not take the trainer's version")
        snap = dict(safetensors_io.iter_safetensors(os.path.join(publish_dir, "v1")))
        params = dict(actor.model.named_parameters())
        if set(snap) != set(params) or not all(
                torch.equal(snap[n].to(p.device), p.detach().to(torch.bfloat16))
                for n, p in params.items()):
            raise AssertionError("the snapshot is not the trainer's params in bf16")
        print(f"  snapshot equals the trainer's {len(params)} params in bf16, bit for bit")
        out = post(port, "/generate", dict(input_ids=prompts[0], sampling_params=dict(
            max_new_tokens=64, min_new_tokens=64, temperature=0.0)))
        lp = np.asarray(out["output_logprobs"])
        if len(out["output_tokens"]) != 64 or not np.isfinite(lp).all() or out["version"] != 1:
            raise AssertionError("the reloaded server did not answer a greedy request")
        print(f"  greedy request on the new weights: 64 tokens, version {out['version']}")
    actor.destroy()
    del actor
    torch.cuda.empty_cache()
    return tuple(int(c) for c in counts), stats, seg_rows


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_bound(case):
    """Least time for the work: bytes moved (each input read once, each
    output written once; the K/V pages of each slot's copied span) over
    the HBM rate, and the QK and PV flops over the peak rate for the
    inputs' type; the larger."""
    q, ck = case["q"], case["ck"]
    B, T, Hq, hd = q.shape
    Hkv = ck.shape[2]
    K = min(case["key_window"], ck.shape[1])
    end = _copied_end(case["lengths"], T, K, min(case["page_size"], K)).sum().item()
    kv_item = ck.element_size()
    nbytes = (2 * q.numel() * q.element_size()  # q in, out
              + 4 * case["k_new"].numel() * kv_item  # k/v new in, appended out
              + 2 * end * Hkv * hd * kv_item  # K and V pages read
              + case["mask"].numel() + 4 * (2 * B + B * T))  # mask, rows, lengths, widx
    flops = 4 * end * Hkv * T * (Hq // Hkv) * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(case):
    """(kernel ms, plain ms, SDPA ms, bound ms, bound_by) on one case."""
    args = dict(case)
    kern = cuda_ms(lambda: ragged_paged_attention(**args))
    plain = cuda_ms(lambda: ragged_paged_attention_plain(**args), iters=50)
    # SDPA on the same inputs, gathered and GQA-expanded outside the timing
    q, ck, cv = case["q"], case["ck"], case["cv"]
    B, T, Hq, hd = q.shape
    K = case["key_window"]
    group = Hq // ck.shape[2]
    rows = case["rows"].long()
    k = ck[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    v = cv[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    qs = q.transpose(1, 2)
    m = case["mask"][:, None]
    sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, k, v, attn_mask=m))
    bound, by = kernel_bound(case)
    return kern, plain, sdpa, bound, by


FLASH_REPLACES = {
    "flash_fwd": "areal_tpu/ops/attention.py:176 (splash forward, "
                 "splash_attention_kernel.py:1137, jax 0.9.0)",
    "flash_bwd_dq": "areal_tpu/ops/attention.py:176 (splash dq, "
                    "splash_attention_kernel.py:1635, jax 0.9.0)",
    "flash_bwd_dkv": "areal_tpu/ops/attention.py:176 (splash dk/dv, "
                     "splash_attention_kernel.py:2196, jax 0.9.0)",
}


def attended_pairs(seg: torch.Tensor) -> int:
    """Causal (query, key) pairs inside segments, summed over rows: what
    the kernels must compute for one q head."""
    pairs = 0
    for row in seg.cpu().numpy():
        _, n = np.unique(row[row >= 0], return_counts=True)
        pairs += int((n * (n + 1) // 2).sum())
    return pairs


def flash_bounds(qs, k, seg):
    """Least time of each kernel for these inputs: bytes over the HBM rate
    against operations (the attended pairs) over the bf16 peak; the larger,
    with its kind.  Bytes: the segment ids in full, the inputs the function
    needs once each (q, dout, k, v, lse and di at valid tokens only: no
    pair touches padding), the outputs (out, lse, dq, dk, dv) written once
    in full, pad rows included."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    item = qs.element_size()
    n_valid = int((seg >= 0).sum())
    q_in, kv_in, row_in = n_valid * Hq * hd * item, n_valid * Hkv * hd * item, n_valid * Hq * 4
    q_out, kv_out, row_out = qs.numel() * item, k.numel() * item, B * Hq * T * 4
    n_seg = seg.numel() * 4
    ops = attended_pairs(seg) * Hq * hd
    work = {  # (bytes, flops)
        "flash_fwd": (n_seg + q_in + 2 * kv_in + q_out + row_out, 4 * ops),
        "flash_bwd_dq": (n_seg + 2 * q_in + 2 * kv_in + 2 * row_in + q_out, 6 * ops),
        "flash_bwd_dkv": (n_seg + 2 * q_in + 2 * kv_in + 2 * row_in + 2 * kv_out, 8 * ops),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[qs.dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def time_flash(seg_rows):
    """On the packed rows `seg_rows` at Qwen2.5's heads in bf16: each flash
    kernel against its plain version (`compare_flash`), then the kernel,
    the plain version and torch SDPA timed: SDPA's forward for the forward
    kernel, its forward + backward through autograd for the two backward
    kernels (one library call computes all of dq, dk, dv).  Returns the
    timings and the |kernel - plain| of each kernel."""
    seg = torch.from_numpy(np.ascontiguousarray(seg_rows)).to(torch.int32)
    qs, k, v, dout, sg = flash_case(300, seg)
    errs = compare_flash(f"train rows {tuple(seg.shape)}", qs, k, v, dout, sg)
    out, lse = fa.flash_fwd(qs, k, v, sg)
    di = fa.attention_di(out, dout)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(qs, k, v, sg),
                      lambda: fa.flash_fwd_plain(qs, k, v, sg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di),
                         lambda: fa.flash_bwd_dq_plain(qs, k, v, sg, dout, lse, di)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di),
                          lambda: fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, lse, di)),
    }
    # SDPA on the same rows: [B, H, T, hd], a boolean block-diagonal causal
    # mask (pad queries see themselves, so no row is empty); q_s is already
    # scaled, so SDPA's own scale is 1
    B, T, Hq, hd = qs.shape
    idx = torch.arange(T, device=sg.device)
    same = (sg[:, :, None] == sg[:, None, :]) & (sg[:, :, None] >= 0)
    mask = (same & (idx[None, :] <= idx[:, None])) | torch.eye(T, dtype=torch.bool,
                                                                device=sg.device)
    mask = mask[:, None]
    q4 = qs.transpose(1, 2).detach().requires_grad_(True)
    k4 = k.transpose(1, 2).detach().requires_grad_(True)
    v4 = v.transpose(1, 2).detach().requires_grad_(True)
    g4 = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True)

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True),
                            (q4, k4, v4), g4)

    lib = {"flash_fwd": cuda_ms(lib_fwd, iters=20, warmup=3)}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cuda_ms(lib_fwd_bwd, iters=10, warmup=2)
    bounds = flash_bounds(qs, k, sg)
    timings = {}
    for name, (kernel, plain) in runs.items():
        ms = cuda_ms(kernel, iters=20, warmup=3)
        plain_ms = cuda_ms(plain, iters=5, warmup=1)
        timings[name] = (ms, plain_ms, lib[name], *bounds[name])
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{lib[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    print(f"  rows {B} x {T}, {int((sg >= 0).sum())} tokens, "
          f"{attended_pairs(sg)} attended pairs per q head")
    return timings, errs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with phase("device"):
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        print(f"  nvidia-smi: {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
              f"{torch.cuda.device_count()} device(s)")
    with phase("build"):
        logs = _build.build(["ragged_decode", "flash_attention"])
        for name, log in logs.items():
            print(f"  {name}.cu:\n" + "\n".join("    " + ln for ln in log.strip().splitlines()))
        if not logs:
            print("  already built")
    with phase("kernels"):
        max_err = check_kernel()
        flash_err = check_flash()
    with phase("engine"):
        check_engine()
    build_dir = os.path.join(ROOT, "build")
    ckpt_dir = os.path.join(build_dir, "smoke_ckpt")
    publish_dir = os.path.join(build_dir, "smoke_publish")
    for d in (ckpt_dir, publish_dir):
        shutil.rmtree(d, ignore_errors=True)
    try:
        with phase("serve"):
            engine, launches, steps, wall, tokens = serve_qwen(ckpt_dir)
        with phase("timings"):
            tok_s = decode_rate(engine)
            del engine
            lengths = torch.from_numpy(
                np.random.default_rng(2).integers(64, 965, 16)).to(torch.int32)
            main_case = ragged_case(7, K=1024, lengths=lengths)
            kern, plain, sdpa, bound, by = time_kernel(main_case)
            print(f"  serving shape (B=16 T=1 K=1024, spans 64..964): kernel {kern:.4f} ms, "
                  f"plain {plain:.4f} ms, SDPA {sdpa:.4f} ms, bound {bound:.4f} ms ({by})")
            full = time_kernel(ragged_case(8, K=2048))
            print(f"  full window (B=16 T=1 K=2048, random spans): kernel {full[0]:.4f} ms, "
                  f"plain {full[1]:.4f} ms, SDPA {full[2]:.4f} ms, bound {full[3]:.4f} ms "
                  f"({full[4]})")
            print(f"  decode {tok_s:.1f} tokens/s (16 slots, 512-token prompts, greedy); "
                  f"serve window {tokens / wall:.1f} tokens/s incl. prefill")
            torch.cuda.empty_cache()
        with phase("train"):
            flash_launches, train_stats, seg_rows = train_qwen(ckpt_dir, publish_dir)
            print(f"  flash launches over the phase fwd/dq/dkv {flash_launches}")
        with phase("flash timings"):
            flash_times, train_err = time_flash(seg_rows)
            flash_err = {n: max(flash_err[n], train_err[n]) for n in flash_err}
    finally:
        for d in (ckpt_dir, publish_dir):
            shutil.rmtree(d, ignore_errors=True)
    records = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "areal_tpu/ops/ragged_decode.py:93",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": sdpa,
    }]
    for name, n in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_launches):
        ms, plain_ms, lib_ms, bound_ms, bound_by = flash_times[name]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": n,
            "max_abs_err": flash_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    print(f"card: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
