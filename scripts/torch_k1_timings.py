"""Time K1 of the PyTorch port at head dim 256 (the bf16 forward, dq and
dk/dv kernels behind `areal_tpu_torch.ops.flash_attention`) and print one
JSON line.

    python scripts/torch_k1_timings.py [--root DIR] [--label NAME]

`--root` is the checkout whose `areal_tpu_torch` is imported (default: the
one this script is in), so that two checkouts' kernels can be timed on the
same card, one process each: the wrappers' signatures are the same in
both.  The cases are Gemma-2B's heads (8 q heads on one kv head of 256):
packed rows shaped like `chip_smoke.py`'s gemma1 train rows (one
micro-batch of 4 seeded prompts of 128..511 tokens x group 4, 128 new
tokens each, packed into rows of 1024), and one row of 2048 (3 segments and
tail padding) cut into sp = 2 and 4 shards at their query offsets.  Each
kernel is first held against its plain version (the forward within 2^-6,
the gradients within 2e-2 of the largest element: `chip_smoke.py`'s
limits), then timed: device time per call by torch.profiler and time per
call by CUDA events over back-to-back calls.  Needs a CUDA device; the
kernels build from DIR at first use.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HEADS = dict(Hq=8, Hkv=1, hd=256)  # Gemma-2B
PROMPT_LEN, NEW = (128, 512), 128  # chip_smoke.py GEMMA1_PROMPT_LEN, GEMMA1_NEW
K1A_ATOL, GRAD_RTOL = 2.0 ** -6, 2e-2
WINDOWS = 3  # profiler windows a reading may take (an empty one is taken again)


def gemma1_rows(seed=0):
    """`chip_smoke.py gemma1_like_rows`: int32 [rows, 1024] segment ids."""
    from areal_tpu_torch.utils.data import pack_into_rows

    lens = np.repeat(np.random.default_rng(seed).integers(*PROMPT_LEN, 4) + NEW, 4)
    mask = np.arange(lens.max())[None, :] < lens[:, None]
    seg = pack_into_rows({"attention_mask": mask}, 1024, rows_bucket_pow2=True).data[
        "segment_ids"]
    return torch.from_numpy(np.ascontiguousarray(seg)).to(torch.int32)


def row_2048():
    seg = torch.full((1, 2048), -1, dtype=torch.int32)
    start = 0
    for s, n in enumerate((700, 900, 300)):
        seg[0, start:start + n] = s
        start += n
    return seg


def make_case(seed, seg, fa):
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, T = seg.shape

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()

    qs = fa.scale_query(randn(B, T, HEADS["Hq"], HEADS["hd"]))
    kv = (randn(B, T, HEADS["Hkv"], HEADS["hd"]) for _ in range(2))
    return (qs, *kv, randn(B, T, HEADS["Hq"], HEADS["hd"]), seg.cuda())


def events_ms(fn, iters=50, warmup=5):
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


def device_ms(fn, iters=20):
    """Self device time of every kernel `fn` launched, per call; None when
    every one of WINDOWS profiler windows recorded none."""
    fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / iters / 1e3
    return None


def time_case(fa, name, qs, k, v, dout, sg, q_start=0, kv_seg=None):
    """The three kernels on one input against their plain versions, then
    timed; returns a dict a kernel."""
    kw = dict(q_start=q_start, kv_segment_ids=kv_seg)
    out, lse = fa.flash_fwd(qs, k, v, sg, **kw)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di, **kw)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, **kw)
    p_out, p_lse = fa.flash_fwd_plain(qs, k, v, sg, **kw)
    p_dq = fa.flash_bwd_dq_plain(qs, k, v, sg, dout, p_lse, di, **kw)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, p_lse, di, **kw)
    torch.cuda.synchronize()
    valid = sg >= 0
    errs = {"flash_fwd": float((out.float() - p_out.float()).abs()[valid].max())}
    for key, pairs in (("flash_bwd_dq", ((dq, p_dq),)),
                       ("flash_bwd_dkv", ((dk, p_dk), (dv, p_dv)))):
        errs[key] = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                        for a, b in pairs)
    grads = max(errs["flash_bwd_dq"], errs["flash_bwd_dkv"])
    if errs["flash_fwd"] > K1A_ATOL or grads > GRAD_RTOL:
        raise AssertionError(f"{name}: kernels against plain versions {errs}")
    runs = {
        "flash_fwd": lambda: fa.flash_fwd(qs, k, v, sg, **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di, **kw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, **kw),
    }
    res = {}
    for key, fn in runs.items():
        res[key] = dict(device_ms=device_ms(fn), events_ms=events_ms(fn), err=errs[key])
        print(f"  {name} {key}: device {res[key]['device_ms']} ms, events "
              f"{res[key]['events_ms']:.4f} ms", file=sys.stderr)
    return res


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_timings: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from areal_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    seg = gemma1_rows()
    cases = {"gemma1_rows": time_case(fa, f"gemma1 rows {tuple(seg.shape)}",
                                      *make_case(300, seg, fa))}
    qs, k, v, dout, sg = make_case(310, row_2048(), fa)
    for sp in (2, 4):
        n = 2048 // sp
        for s in range(sp):
            a = s * n
            q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
            cases[f"sp{sp}_shard{s}"] = time_case(fa, f"T=2048 sp {sp} shard {s}", q_s, k, v,
                                                  do_s, sg_s, a, sg)
    print(json.dumps(dict(label=args.label, root=args.root, card=card.strip(),
                          rows=list(seg.shape), cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
