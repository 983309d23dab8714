"""Time K2 of the PyTorch port (`areal_tpu_torch.ops.ragged_decode
.ragged_paged_attention`) on bf16 verifies at the decode shapes of the
port's model families, and print one JSON line.

    python scripts/torch_k2_verify_timings.py [--root DIR] [--label NAME]

`--root` is the checkout whose `areal_tpu_torch` is imported (default: the
one this script is in), so that two checkouts' kernels can be timed on the
same card, one process each: the wrapper's signature is the same in both.
For each shape and T in (4, 8) the inputs are seeded, every slot drafts
T - 1 tokens on spans drawn as the serving paths draw them, and the output
is held against the plain version (bf16, within 2e-2, caches bit-equal).
Per case it reports the device time per call by torch.profiler, the time
per call by CUDA events over back-to-back calls, and whether the call ran
on the tensor cores (`launches_tc`, null where the checkout has no such
count).  Needs a CUDA device; the kernels build from DIR at first use.
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
# (name, slots, q heads, kv heads, head dim, key window, spans [lo, hi), window, softcap)
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


def device_ms(fn, iters=50):
    """Self device time of every kernel `fn` launched, per call; None when
    the profiler recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / iters / 1e3 if total > 0 else None


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
    for i, (name, B, Hq, Hkv, hd, K, spans, window, softcap) in enumerate(SHAPES):
        for T in (4, 8):
            case = make_case(1000 + 10 * i + T, B, Hq, Hkv, hd, K, spans, window, T)

            def call(case=case):
                return fn(**dict(case, ck=case["ck"].clone(), cv=case["cv"].clone()),
                          logit_softcap=softcap)

            tc0 = getattr(fn, "launches_tc", None)
            got = call()
            tc = None if tc0 is None else fn.launches_tc - tc0
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

            cases.append(dict(name=name, T=T, rows=T * Hq // Hkv, chunks=-(-K // 64),
                              on_tensor_cores=tc, max_abs_err=err,
                              device_ms=device_ms(timed), events_ms=events_ms(timed)))
            print(f"  {name} T={T}: device {cases[-1]['device_ms']} ms, events "
                  f"{cases[-1]['events_ms']:.4f} ms, tensor cores {tc}", file=sys.stderr)
    print(json.dumps(dict(label=args.label, root=args.root, card=card.strip(), cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
