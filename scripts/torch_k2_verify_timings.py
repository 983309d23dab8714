"""Time K2 of the PyTorch port (`areal_tpu_torch.ops.ragged_decode
.ragged_paged_attention`) on bf16 decode (T = 1) at the five decode shapes
`chip_smoke.py` times and on bf16 verifies (T = 4 and 8) at the decode
shapes of the port's model families, and print one JSON line.

    python scripts/torch_k2_verify_timings.py [--root DIR] [--label NAME]

`--root` is the checkout whose `areal_tpu_torch` is imported (default: the
one this script is in), so that two checkouts' kernels can be timed on the
same card, one process each: the wrapper's signature is the same in both.
For each shape and T the inputs are seeded, every slot drafts T - 1 tokens
on spans drawn as the serving paths draw them, and the output is held
against the plain version (bf16, within 2e-2, caches bit-equal).  Per case
it reports the device time per call by torch.profiler, the time per call by
CUDA events over back-to-back calls, and the variant the call ran on
("dec" or "tc" by the wrapper's `launches_dec` / `launches_tc`, "passes"
when neither moved; a checkout without such a count ran none); beside
them the yardsticks: torch SDPA on the same mask (the K/V
gathered and GQA-expanded outside the timing, uncapped under a softcap, as
`chip_smoke.py time_kernel` times it), by device time and events, and the
call's bound on an H100 SXM (the larger of its bytes over 3.35 TB/s and its
QK and PV flops over 989 TFLOP/s, counted as `chip_smoke.py kernel_bound`
counts them).  Needs a CUDA device; the kernels build from DIR at first
use.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

BF16_TOL = 2e-2
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM
# (name, slots, q heads, kv heads, head dim, key window, spans [lo, hi), window, softcap)
# the five decode shapes of chip_smoke.py (DECODE_SHAPES), at T = 1
DECODE = (
    ("serving shape", 16, 12, 2, 128, 1024, (64, 965), None, None),
    ("full window", 16, 12, 2, 128, 2048, (0, 2048), None, None),
    ("Gemma-2-2B decode, K 8192, window 4096, softcap 50", 8, 8, 4, 256, 8192, (3988, 4564),
     4096, 50.0),
    ("Qwen3-1.7B decode, 32 slots", 32, 16, 8, 128, 1024, (64, 512), None, None),
    ("Gemma-2B decode (8 q on 1 kv)", 8, 8, 1, 256, 2048, (128, 640), None, None),
)
# verifies at T = 4 and 8
SHAPES = (
    ("spec (Qwen2.5-1.5B heads)", 8, 12, 2, 128, 1024, (64, 641), None, None),
    ("Qwen2.5-1.5B serving, K 2048", 16, 12, 2, 128, 2048, (64, 1985), None, None),
    ("Gemma-2-2B, K 8192, window 4096, softcap 50", 8, 8, 4, 256, 8192, (3988, 4564), 4096,
     50.0),
    ("Qwen3-1.7B, 32 slots", 32, 16, 8, 128, 1024, (64, 320), None, None),
    ("Gemma-2B (8 q on 1 kv)", 8, 8, 1, 256, 2048, (128, 640), None, None),
    # the key window's sweep at Qwen2.5's heads, spans filling it
    ("Qwen2.5-1.5B heads, K 2048 full", 8, 12, 2, 128, 2048, (1024, 2040), None, None),
    ("Qwen2.5-1.5B heads, K 4096 full", 8, 12, 2, 128, 4096, (2048, 4088), None, None),
    ("Qwen2.5-1.5B heads, K 8192 full", 8, 12, 2, 128, 8192, (4096, 8184), None, None),
    ("Gemma-2-2B heads, K 4096 full, softcap 50", 8, 8, 4, 256, 4096, (2048, 4088), None,
     50.0),
)


def make_case(seed, B, Hq, Hkv, hd, K, spans, window, T):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()

    S = B + 1
    lengths = torch.from_numpy(np.random.default_rng(seed).integers(*spans, B)).to(torch.int32)
    lengths = lengths.clamp(max=K - T)
    pos = lengths[:, None] + torch.arange(T, dtype=torch.int32)[None, :]
    mask = torch.arange(K)[None, None, :] <= pos[:, :, None]
    if window:
        mask &= torch.arange(K)[None, None, :] > pos[:, :, None] - window
    return dict(q=randn(B, T, Hq, hd), k_new=randn(B, T, Hkv, hd), v_new=randn(B, T, Hkv, hd),
                ck=randn(S, K, Hkv, hd), cv=randn(S, K, Hkv, hd),
                rows=torch.randperm(S, generator=g)[:B].to(torch.int32).cuda(),
                lengths=lengths.cuda(), widx=pos.contiguous().cuda(), mask=mask.cuda(),
                key_window=K, page_size=128)


def events_ms(fn, iters=200, warmup=20):
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


def device_ms(fn, iters=50, windows=3):
    """Self device time of every kernel `fn` launched, per call; a window
    that recorded none is taken again, and None when all `windows` did."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / iters / 1e3
    return None


def copied_end(lengths, T, K, page):
    """Per slot, the end of the key columns K2 reads (its occupied span
    rounded up to whole pages, or K past the last full page)."""
    n_full = K // page
    span = torch.clamp(lengths.long() + T, max=K)
    npages = torch.clamp((span + page - 1) // page, max=n_full)
    return torch.where(span > n_full * page, K, npages * page)


def bound(case):
    """(ms, "bytes" or "operations"): q in and out, the new K/V in and
    appended, the K/V pages read, the mask and index arrays, against the QK
    and PV flops over the rows' keys."""
    q, ck = case["q"], case["ck"]
    B, T, Hq, hd = q.shape
    Hkv = ck.shape[2]
    K = case["key_window"]
    end = int(copied_end(case["lengths"], T, K, case["page_size"]).sum())
    item = ck.element_size()
    nbytes = (2 * q.numel() * item + 4 * case["k_new"].numel() * item + 2 * end * Hkv * hd * item
              + case["mask"].numel() + 4 * (2 * B + B * T))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * end * T * Hq * hd / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(case):
    """torch SDPA on the case's mask over each slot's gathered keys."""
    q, ck, cv = case["q"], case["ck"], case["cv"]
    K = case["key_window"]
    group = q.shape[2] // ck.shape[2]
    rows = case["rows"].long()
    k = ck[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    v = cv[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    qs, m = q.transpose(1, 2), case["mask"][:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qs, k, v, attn_mask=m)


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k2_verify_timings: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from areal_tpu_torch.ops import ragged_decode as rd

    fn = rd.ragged_paged_attention
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cases = []
    plan = [(i, shape, 1) for i, shape in enumerate(DECODE)] + [
        (len(DECODE) + i, shape, T) for i, shape in enumerate(SHAPES) for T in (4, 8)]
    for i, (name, B, Hq, Hkv, hd, K, spans, window, softcap), T in plan:
        case = make_case(1000 + 10 * i + T, B, Hq, Hkv, hd, K, spans, window, T)

        def call(case=case):
            return fn(**dict(case, ck=case["ck"].clone(), cv=case["cv"].clone()),
                      logit_softcap=softcap)

        counts = [getattr(fn, n, 0) for n in ("launches_dec", "launches_tc")]
        got = call()
        dec, tc = (getattr(fn, n, 0) - c for c, n in zip(counts, ("launches_dec",
                                                                   "launches_tc")))
        ran = "dec" if dec else "tc" if tc else "passes"
        want = rd.ragged_paged_attention_plain(
            **dict(case, ck=case["ck"].clone(), cv=case["cv"].clone()),
            logit_softcap=softcap)
        torch.cuda.synchronize()
        err = float((got[0].float() - want[0].float()).abs().max())
        if (err > BF16_TOL or not torch.equal(got[1], want[1])
                or not torch.equal(got[2], want[2])):
            raise AssertionError(f"{name} T={T}: max|out - plain| {err}")

        def timed(case=case):
            fn(**case, logit_softcap=softcap)

        sdpa = sdpa_call(case)
        bound_ms, bound_by = bound(case)
        cases.append(dict(name=name, T=T, rows=T * Hq // Hkv, chunks=-(-K // 64),
                          variant=ran, max_abs_err=err,
                          device_ms=device_ms(timed), events_ms=events_ms(timed),
                          sdpa_device_ms=device_ms(sdpa), sdpa_events_ms=events_ms(sdpa),
                          bound_ms=bound_ms, bound_by=bound_by))
        print(f"  {name} T={T}: device {cases[-1]['device_ms']} ms, events "
              f"{cases[-1]['events_ms']:.4f} ms, variant {ran}; SDPA device "
              f"{cases[-1]['sdpa_device_ms']} ms; bound {bound_ms:.4f} ms ({bound_by})",
              file=sys.stderr)
    print(json.dumps(dict(label=args.label, root=args.root, card=card.strip(), cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
