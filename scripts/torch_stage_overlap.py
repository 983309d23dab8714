"""Measure how far the PyTorch port's generation engine decodes while
weights stage on another thread, and whether repeated weight updates
grow the card's reserved memory; print one JSON line.

    python scripts/torch_stage_overlap.py [--layers 28] [--cycles 10]

Qwen2.5-1.5B at full width (random bf16 weights from seed 0, `--layers`
deep) in a `GenEngine` of 16 slots x 2048, as `chip_smoke.py`'s tiers phase
builds it.  For each case, 16 greedy requests (128-token prompts) are
admitted, then the main thread steps the engine while a second thread runs
the case, and the steps and tokens the engine delivered meanwhile are
counted:

    none    no second thread: one second of stepping, the baseline rate
    plain   `GenEngine.stage_params` of the weights as host tensors (the
            transfer publish's form): the engine's own path, copies from
            pageable memory on the current stream
    bounce  the alternative: the same standby built on a side stream (one,
            held for the run) through a pinned two-half bounce buffer of
            2 x 32 MiB, each tensor then recorded as used by the decode
            stream, and handed to `stage_params` as a model on the device
    idle    the thread sleeps as long as the first `plain` took

`plain` and `bounce` alternate (plain, bounce, bounce, plain); after each,
`commit_staged(live=True)` swaps the standby in (the same weights), so
the superseded copy is freed as a weight update frees it.  Each case
reports the thread's seconds, the engine steps and tokens delivered
meanwhile, and tokens/s.  `cycles` then runs `--cycles` stage + commit
pairs with nothing decoding and reports `torch.cuda.memory_reserved` and
`memory_allocated` (GB) after each.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from areal_tpu_torch.gen.engine import GenEngine, GenRequest  # noqa: E402
from areal_tpu_torch.models.hf import state_to_params  # noqa: E402
from areal_tpu_torch.models.model_config import qwen25_1p5b  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402

BOUNCE_BYTES = 32 << 20  # each half of the bounce buffer


def run_case(eng, vocab, work, seconds=None):
    """Admit 16 requests, then step the engine while `work` runs on a
    thread (or for `seconds` with no thread): (thread s, steps, tokens)."""
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rid=f"r{i}", input_ids=rng.integers(0, vocab, 128).tolist(),
                       max_new_tokens=1024, min_new_tokens=1024, temperature=0.0)
            for i in range(eng.n_slots)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # admission and the first chunk
    torch.cuda.synchronize()
    box = {}

    def target():
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        box["s"] = time.perf_counter() - t0

    steps = tokens = 0
    t0 = time.perf_counter()
    if work is None:
        while time.perf_counter() - t0 < seconds:
            tokens += eng.step()
            steps += 1
        box["s"] = time.perf_counter() - t0
    else:
        th = threading.Thread(target=target)
        th.start()
        while th.is_alive():
            tokens += eng.step()
            steps += 1
        th.join()
    eng.abort_all("abort")
    torch.cuda.synchronize()
    return {"thread_s": box["s"], "steps": steps, "tokens": tokens,
            "tokens_per_s": tokens / box["s"]}


class BouncePlacer:
    """The side-stream alternative to the engine's placement: host tensors
    copied in chunks through the two halves of a pinned buffer on one held
    stream (a half is refilled once its last copy has finished), the model
    built from them there, and every tensor recorded as used by the decode
    stream."""

    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device
        self.stream = torch.cuda.Stream(device)
        buf = torch.empty(2 * BOUNCE_BYTES, dtype=torch.uint8, pin_memory=True)
        self.halves = (buf[:BOUNCE_BYTES], buf[BOUNCE_BYTES:])

    def _uploaded(self, items):
        done = [None, None]
        k = 0
        for name, t in items:
            src = t.detach().contiguous().reshape(-1).view(torch.uint8)
            dst = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            out = dst.reshape(-1).view(torch.uint8)
            for off in range(0, src.numel(), BOUNCE_BYTES):
                n = min(BOUNCE_BYTES, src.numel() - off)
                if done[k] is not None:
                    done[k].synchronize()
                self.halves[k][:n].copy_(src[off:off + n])
                out[off:off + n].copy_(self.halves[k][:n], non_blocking=True)
                done[k] = torch.cuda.Event()
                done[k].record(self.stream)
                k ^= 1
            yield name, dst

    def place(self, host, decode_stream):
        with torch.cuda.stream(self.stream):
            model = state_to_params(self._uploaded(iter(host.items())), self.cfg, self.device,
                                    "bfloat16")
        self.stream.synchronize()
        for t in model.state_dict().values():
            t.record_stream(decode_stream)
        return model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=28)
    p.add_argument("--cycles", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_stage_overlap: needs a CUDA device", file=sys.stderr)
        return 1
    cfg = qwen25_1p5b().replace(num_layers=args.layers)
    model = init_params(cfg, seed=0, device="cuda")
    eng = GenEngine(cfg, params=model, n_slots=16, max_seq_len=2048, prompt_bucket=128,
                    kv_dtype="bfloat16", seed=0, abort_reserve_s=0.0)
    host = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    del model  # the engine holds the served copy
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    decode_stream = torch.cuda.current_stream()
    bouncer = BouncePlacer(cfg, torch.device("cuda"))
    run_case(eng, cfg.vocab_size, None, 1.0)  # warm-up
    out = {"device": torch.cuda.get_device_name(0), "layers": args.layers,
           "host_gb": nbytes / 1e9, "bounce_bytes": BOUNCE_BYTES}
    out["none"] = run_case(eng, cfg.vocab_size, None, 1.0)

    def plain():
        if not eng.stage_params(host):
            raise RuntimeError("the standby did not fit")

    def bounce():
        if not eng.stage_params(bouncer.place(host, decode_stream)):
            raise RuntimeError("the standby did not fit")

    for name, fn in (("plain", plain), ("bounce", bounce), ("bounce", bounce),
                     ("plain", plain)):
        out.setdefault(name, []).append(run_case(eng, cfg.vocab_size, fn))
        eng.commit_staged(live=True)
    out["idle"] = run_case(eng, cfg.vocab_size,
                           lambda: time.sleep(out["plain"][0]["thread_s"]))
    torch.cuda.synchronize()
    cycles = []
    for _ in range(args.cycles):
        t0 = time.perf_counter()
        plain()
        eng.commit_staged(live=True)
        torch.cuda.synchronize()
        cycles.append({"s": time.perf_counter() - t0,
                       "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                       "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    out["cycles"] = cycles
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
