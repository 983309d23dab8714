"""Time K1 of the PyTorch port at head dim 128 and 256 (the bf16 forward,
dq and dk/dv kernels behind `areal_tpu_torch.ops.flash_attention`) and
print one JSON line.

    python scripts/torch_k1_timings.py [--root DIR] [--label NAME] [--hd 128|256]

`--root` is the checkout whose `areal_tpu_torch` is imported (default: the
one this script is in), so that two checkouts' kernels can be timed on the
same card, one process each: the wrappers' signatures are the same in
both.  At hd 256 the cases are Gemma-2B's heads (8 q heads on one kv head
of 256): packed rows shaped like `chip_smoke.py`'s gemma1 train rows (one
micro-batch of 4 seeded prompts of 128..511 tokens x group 4, 128 new
tokens each, packed into rows of 1024), and one row of 2048 (3 segments and
tail padding) cut into sp = 2 and 4 shards at their query offsets.  At hd
128 they are Qwen2.5-1.5B's heads (12 q heads on 2 kv heads of 128): the
train phase's micro-batch (4 seeded prompts of 128..512 tokens x group 4,
256 new tokens each, in 16 rows of 1024), rows like the ref forward's (32
sequences of 192..511 tokens, one a row of 512), the same rows at
Qwen3-1.7B's heads (16 q on 8 kv), the reward model's layout (one
sequence of 20..120 tokens from the start of each of 16 rows of 1024, two
rows filler end to end), and the sp phase's batch (32 rows of 1024) cut
into sp = 2 shards at q_start 0 and 512.  `--hd` times one head
dim only (default both).  Each
kernel is first held against its plain version (the forward within 2^-6,
the gradients within 2e-2 of the largest element: `chip_smoke.py`'s
limits), then timed: device time per call by torch.profiler and time per
call by CUDA events over back-to-back calls.  Beside each unsharded hd-128
kernel: torch SDPA on the same block-diagonal causal mask (device time;
its forward beside the forward kernel, its forward and backward beside
dq and dk/dv) and the kernel's bound on an H100 SXM (the larger of its
bytes over 3.35 TB/s and its attended pairs' flops over 989 TFLOP/s,
counted as `chip_smoke.py flash_bounds` counts them).  Needs a CUDA device; the
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
QWEN25_HEADS, QWEN3_HEADS = dict(Hq=12, Hkv=2, hd=128), dict(Hq=16, Hkv=8, hd=128)
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


def packed(lens, row):
    """int32 [rows, row] segment ids of sequences of `lens`, packed as the
    actor packs them."""
    from areal_tpu_torch.utils.data import pack_into_rows

    lens = np.asarray(lens)
    mask = np.arange(lens.max())[None, :] < lens[:, None]
    seg = pack_into_rows({"attention_mask": mask}, row, rows_bucket_pow2=True).data[
        "segment_ids"]
    return torch.from_numpy(np.ascontiguousarray(seg)).to(torch.int32)


def qwen_rows():
    """(name, segment ids) of the hd-128 cases: the train phase's
    micro-batch, the ref forward's kind of rows, and the sp phase's batch
    (`mp_train_worker.BATCH_SHAPES["qwen2.5-1.5b"]`: 8 prompts of 128..512
    tokens x group 4, 256 new tokens)."""
    rng = np.random.default_rng(7)
    prompts = rng.integers(128, 513, 8)
    batch = np.repeat(prompts + 256, 4)
    ref = np.random.default_rng(11).integers(192, 512, 32)
    rw = np.random.default_rng(13).integers(20, 121, 16)
    rw[[5, 11]] = 0
    seg = torch.full((16, 1024), -1, dtype=torch.int32)
    for i, n in enumerate(rw):
        seg[i, :n] = 0
    return (("train micro-batch", packed(batch[:16], 1024)), ("ref forward rows", packed(ref, 512)),
            ("reward model rows", seg), ("sp batch", packed(batch, 1024)))


def row_2048():
    seg = torch.full((1, 2048), -1, dtype=torch.int32)
    start = 0
    for s, n in enumerate((700, 900, 300)):
        seg[0, start:start + n] = s
        start += n
    return seg


def make_case(seed, seg, fa, heads=HEADS):
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, T = seg.shape

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()

    qs = fa.scale_query(randn(B, T, heads["Hq"], heads["hd"]))
    kv = (randn(B, T, heads["Hkv"], heads["hd"]) for _ in range(2))
    return (qs, *kv, randn(B, T, heads["Hq"], heads["hd"]), seg.cuda())


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


def yardsticks(qs, k, v, dout, sg):
    """{kernel: (SDPA device ms, bound ms, "bytes" or "operations")} on
    unsharded rows: SDPA's forward beside the forward kernel, its forward
    and backward (one autograd call gives dq, dk and dv) beside the two
    backward kernels; each kernel's bound counted as `chip_smoke.py
    flash_bounds` counts it."""
    B, T, Hq, hd = qs.shape
    Hkv, item = k.shape[2], qs.element_size()
    n_valid = int((sg >= 0).sum())
    pairs = 0
    for row in sg.cpu().numpy():
        _, n = np.unique(row[row >= 0], return_counts=True)
        pairs += int((n * (n + 1) // 2).sum())
    q_in, kv_in, row_in = n_valid * Hq * hd * item, n_valid * Hkv * hd * item, n_valid * Hq * 4
    q_out, kv_out, row_out, ids = qs.numel() * item, k.numel() * item, B * Hq * T * 4, sg.numel() * 4
    ops = pairs * Hq * hd
    work = {"flash_fwd": (ids + q_in + 2 * kv_in + q_out + row_out, 4 * ops),
            "flash_bwd_dq": (ids + 2 * q_in + 2 * kv_in + 2 * row_in + q_out, 6 * ops),
            "flash_bwd_dkv": (ids + 2 * q_in + 2 * kv_in + 2 * row_in + 2 * kv_out, 8 * ops)}
    idx = torch.arange(T, device=sg.device)
    same = (sg[:, :, None] == sg[:, None, :]) & (sg[:, :, None] >= 0)
    mask = ((same & (idx[None, :] <= idx[:, None]))
            | torch.eye(T, dtype=torch.bool, device=sg.device))[:, None]
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_(True) for x in (qs, k, v))
    g4 = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True),
                            (q4, k4, v4), g4)

    lib_fwd, lib_bwd = device_ms(fwd), device_ms(fwd_bwd, iters=10)
    res = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
        res[name] = (lib_fwd if name == "flash_fwd" else lib_bwd, max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return res


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
    p.add_argument("--hd", type=int, choices=(128, 256), default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_timings: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from areal_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    cases = {}
    if args.hd in (None, 128):
        (_, train), (_, ref), (_, rw), (_, sp_batch) = qwen_rows()
        for key, seg, heads in (("hd128_train_rows", train, QWEN25_HEADS),
                                ("hd128_ref_forward_rows", ref, QWEN25_HEADS),
                                ("hd128_qwen3_heads", ref, QWEN3_HEADS),
                                ("hd128_reward_model_rows", rw, QWEN25_HEADS)):
            case = make_case(320 + len(cases), seg, fa, heads)
            cases[key] = time_case(fa, f"{key} {tuple(seg.shape)}", *case)
            for name, (sdpa, bound, by) in yardsticks(*case).items():
                cases[key][name].update(sdpa_device_ms=sdpa, bound_ms=bound, bound_by=by)
        qs, k, v, dout, sg = make_case(330, sp_batch, fa, QWEN25_HEADS)
        n = sp_batch.shape[1] // 2
        for s in range(2):
            a = s * n
            q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
            cases[f"hd128_sp2_shard{s}"] = time_case(fa, f"sp batch {tuple(sp_batch.shape)} "
                                                     f"sp 2 shard {s}", q_s, k, v, do_s, sg_s,
                                                     a, sg)
    if args.hd in (None, 256):
        seg = gemma1_rows()
        cases["gemma1_rows"] = time_case(fa, f"gemma1 rows {tuple(seg.shape)}",
                                         *make_case(300, seg, fa))
        qs, k, v, dout, sg = make_case(310, row_2048(), fa)
        for sp in (2, 4):
            n = 2048 // sp
            for s in range(sp):
                a = s * n
                q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
                cases[f"sp{sp}_shard{s}"] = time_case(fa, f"T=2048 sp {sp} shard {s}", q_s, k,
                                                      v, do_s, sg_s, a, sg)
    print(json.dumps(dict(label=args.label, root=args.root, card=card.strip(),
                          cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
