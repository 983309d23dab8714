#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`areal_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name
2. build    nvcc builds every kernel of the serving path from the sources
            in this checkout (-Xptxas -v report printed)
3. kernels  each kernel against its plain PyTorch version at the serving
            shapes (Qwen2.5-1.5B decode: B=16, T=1, Hq=12, Hkv=2, hd=128,
            bf16, page 128, K in {128, 2048}; T=4 at K=512; softcap 30 at
            K=128; one f32 case); the appended cache is compared bit for bit
4. engine   a tiny f32 model served by the port's engine on the card and on
            the CPU: greedy streams equal, logprobs within 1e-4
5. serve    random seeded bf16 Qwen2.5-1.5B weights at full width (28
            layers), written as an HF checkpoint by the port's writer, served
            through `areal_tpu_torch.gen.server.main` over HTTP: 8 /generate
            and one /generate_batch of 4, 64 tokens each, half greedy; the
            kernel's launch count must equal 28 x the engine's decode steps
6. timings  kernel, plain version and torch SDPA on the serving shapes (CUDA
            events), the kernel's bound, and decode tokens/s of the engine

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

from areal_tpu_torch.gen import server as gen_server
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.models.model_config import qwen25_1p5b, tiny_config
from areal_tpu_torch.models.transformer import build_model, init_params
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops.ragged_decode import (
    _copied_end,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)

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

    ready = threading.Event()
    holder = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    def run_server():
        try:
            gen_server.main(["--model-path", ckpt_dir, "--port", "0", "--n-slots", "16",
                             "--max-seq-len", "2048"], on_ready=on_ready)
        except BaseException as e:  # surfaced to the main thread below
            holder["error"] = e
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    ready.wait(900)
    if "httpd" not in holder:
        raise RuntimeError(f"server did not start: {holder.get('error')!r}")
    httpd = holder["httpd"]
    engine = httpd.gen.engine
    print(f"  server up (checkpoint loaded) in {time.perf_counter() - t0:.1f} s "
          f"on port {httpd.port}")
    try:
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
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.port}/health", timeout=60).read())
    finally:
        httpd.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
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
        logs = _build.build(["ragged_decode"])
        for name, log in logs.items():
            print(f"  {name}.cu:\n" + "\n".join("    " + ln for ln in log.strip().splitlines()))
        if not logs:
            print("  already built")
    with phase("kernels"):
        max_err = check_kernel()
    with phase("engine"):
        check_engine()
    ckpt_dir = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
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
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
