"""Serving-side benchmark of the port: decode throughput, prefill cost,
KV-reuse and fan-out gains, the ceiling and speculative-decoding A/Bs.

    python -m areal_tpu_torch.scripts.bench_serving                 # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.scripts.bench_serving --device cpu --model tiny

The counterpart of `scripts/bench_serving.py`, with its flags and its one
JSON line:

  {"decode": {"<n_slots>": {"tokens_per_sec": ..., "wall_s": ...}, ...},
   "prefill": {"bucket_<P>": {"tokens_per_sec": ..., "ms": ...}, ...},
   "multi_turn": {"reuse": {...}, "cold": {...}, "speedup": ...},
   "grouped": {...}, "decode_ceiling_ab": {...}, "spec_ab": {...},
   "device_kind": ...}

Workloads (Qwen2.5-1.5B shapes, bf16, random weights from seed 0 —
serving throughput does not depend on weight values):
- decode: fill every slot, generate to a fixed budget, steady-state
  delivered tokens/s against the slot count;
- prefill: one bucketed admission of `rows` prompts per prompt-length
  bucket, tokens/s through the prefill;
- multi-turn: T-turn conversations where each turn extends the last
  transcript — KV prefix reuse against a cold engine;
- group fan-out: GRPO groups over one prompt each, sharing on and off,
  and sharing with the host KV tier (streams must be equal);
- ceiling A/B: the same decode workload under two `max_seq_len` ceilings;
- spec A/B: a repetition-heavy greedy workload with speculative decoding
  off and on (streams must be equal).

`--model tiny --device cpu` is the CPU smoke mode: wall-clock is
meaningless there, but the token accounting (reused and shared tokens,
drafted and accepted) is workload arithmetic and carries over exactly.
Every engine warms once before its timed window, and the device is
synchronised around each window.  Tokens/s is delivered tokens over wall
time.  Every decode step and verify is one ragged-decode kernel call a
layer: each result's `k2_calls` is layers x (decode steps + verify calls)
over the lives of the engines it ran, warm-ups included, which is what
the kernel's launch counter must read on the card.

`--ab-ragged` has no counterpart: the reference's A/B compares a dense
tiered decode with its ragged kernel, and the port has no dense decode
path (decode attention is always the ragged kernel, `gen/engine.py`).
"""

import argparse
import copy
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import qwen25_1p5b, tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.obs.trace import dist_summary

MODELS = ("qwen25_1p5b", "tiny")
NO_RAGGED_AB = ("--ab-ragged has no counterpart in the port: it compares the reference's "
                "dense tiered decode with its ragged kernel, and the port has no dense "
                "decode path (decode attention is always the ragged kernel)")


def serving_model_setup(model: str = "qwen25_1p5b", device=None):
    """The canonical serving-bench model: Qwen2.5-1.5B shapes, bf16, random
    weights from seed 0.  `model="tiny"` is the CPU smoke mode's f32
    Qwen2-style model."""
    if model == "tiny":
        cfg = tiny_config(vocab_size=512, qkv_bias=True,
                          hf_architecture="Qwen2ForCausalLM", eos_token_id=None)
    else:
        cfg = qwen25_1p5b().replace(dtype="bfloat16", remat=False, eos_token_id=None)
    return cfg, init_params(cfg, seed=0, device=device)


def _reset_stats(eng: GenEngine) -> int:
    """Zero the counters after a warm-up; returns the ragged-decode kernel
    calls they counted (layers x (decode steps + verify calls))."""
    calls = eng.model_config.num_layers * (eng.stats["decode_steps"]
                                           + eng.stats["verify_calls"])
    for k in eng.stats:
        eng.stats[k] = 0
    return calls


def _retire(eng: GenEngine) -> int:
    """The engine is done: free its cache; returns the kernel calls its
    counters held."""
    eng.cache = None
    return _reset_stats(eng)


def _forget_retained(eng: GenEngine) -> None:
    """No retained prefix seeds the timed run: with its valid length 0 a
    slot's radix entry is stale, which costs a hit and never fakes one (the
    overwrite counts it evicted, as in the reference)."""
    eng.retained_len[:] = 0


def _sync(eng: GenEngine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _engine(cfg, params, n_slots, max_seq_len, kv_reuse=True, decode_chunk=8, **kw):
    return GenEngine(
        cfg, params=params, n_slots=n_slots, max_seq_len=max_seq_len,
        prompt_bucket=128, decode_chunk=decode_chunk, kv_reuse=kv_reuse,
        kv_dtype=cfg.dtype, device=next(params.parameters()).device, **kw,
    )


def decode_attended_fraction(eng: GenEngine) -> float:
    """Pages the ragged kernel read over the configured ceiling's, over
    every decode step and verify since the last reset: 1.0 would mean
    decode paid the full `max_seq_len` width."""
    calls = eng.stats["decode_steps"] + eng.stats["verify_calls"]
    if not calls:
        return 1.0
    return (eng.stats["ragged_attended_pages"] * eng.prompt_bucket
            / (calls * eng.n_slots * eng.max_seq_len))


def _timed_decode(eng: GenEngine, reqs: List[GenRequest]):
    """Submit, admit outside the timing, then step until every request is
    done; returns (delivered tokens, wall seconds, finish times by rid)."""
    finished: Dict[str, float] = {}
    for r in reqs:
        r.on_done = lambda q: finished.__setitem__(q.rid, time.perf_counter())
        eng.submit(r)
    eng.step()  # admission (prefill) outside the decode timing
    _sync(eng)
    t0 = time.perf_counter()
    delivered = 0
    while any(not r.stop_reason for r in reqs):
        delivered += eng.step()
    _sync(eng)
    return delivered, time.perf_counter() - t0, finished


def bench_decode(cfg, params, slot_counts, max_seq_len=512, gen_tokens=128,
                 prompt_len=64, spec_decode=False, draft_len=0):
    """Steady-state decode tokens/s with every slot busy."""
    rng = np.random.default_rng(0)
    out = {}
    for n_slots in slot_counts:
        try:
            eng = _engine(cfg, params, n_slots, max_seq_len, kv_reuse=False,
                          spec_decode=spec_decode, spec_draft_len=draft_len or None)
            reqs = [GenRequest(rid=f"w{i}",
                               input_ids=rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                               max_new_tokens=8, temperature=1.0)
                    for i in range(n_slots)]
            eng.generate_blocking(reqs)
            k2 = _reset_stats(eng)  # the warm-up must not skew the counters
            reqs = [GenRequest(rid=f"m{i}",
                               input_ids=rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                               max_new_tokens=gen_tokens, temperature=1.0)
                    for i in range(n_slots)]
            delivered, dt, finished = _timed_decode(eng, reqs)
            # per-request latency triple on the perf_counter clock (submit
            # -> first delivered token -> finish); the admission step sits
            # inside TTFT, as it does for a real client
            ttfts = [r.first_token_ts - r.submit_ts for r in reqs if r.first_token_ts > 0.0]
            e2es = [finished[r.rid] - r.submit_ts for r in reqs if r.rid in finished]
            itls = [(finished[r.rid] - r.first_token_ts) / max(1, len(r.output_tokens) - 1)
                    for r in reqs
                    if r.rid in finished and r.first_token_ts > 0.0 and len(r.output_tokens) > 1]
            out[str(n_slots)] = {
                "tokens_per_sec": round(delivered / dt, 1),
                "wall_s": round(dt, 2),
                "latency": {
                    "ttft_s": dist_summary(ttfts),
                    "e2e_s": dist_summary(e2es),
                    "inter_token_s": dist_summary(itls),
                },
                "decode_calls": eng.stats["decode_calls"],
                "decode_steps": eng.stats["decode_steps"],
                "decode_attended_fraction": round(decode_attended_fraction(eng), 4),
                "verify_calls": eng.stats["verify_calls"],
                "spec_draft_tokens": eng.stats["spec_drafted"],
                "spec_accepted_tokens": eng.stats["spec_accepted"],
                "spec_acceptance_rate": round(
                    eng.stats["spec_accepted"] / max(1, eng.stats["spec_drafted"]), 4),
            }
            print(f"decode n_slots={n_slots}: {out[str(n_slots)]}", file=sys.stderr, flush=True)
            out[str(n_slots)]["k2_calls"] = k2 + _retire(eng)
            del eng
        except Exception as e:  # noqa: BLE001 — record and continue the curve
            out[str(n_slots)] = {"error": str(e)[:200]}
            print(f"decode n_slots={n_slots} failed: {str(e)[:120]}", file=sys.stderr,
                  flush=True)
    return out


def bench_prefill(cfg, params, buckets=(128, 512, 1024), rows=8, max_seq_len=2048):
    """Prefill throughput per prompt bucket: one bucketed admission of
    `rows` prompts, tokens/s through the prefill."""
    rng = np.random.default_rng(1)
    eng = _engine(cfg, params, rows, max_seq_len, kv_reuse=False)
    out = {}
    for bucket in buckets:
        plen = bucket - 1  # stay inside the bucket
        for warm in (True, False):
            reqs = [GenRequest(rid=f"p{bucket}_{warm}_{i}",
                               input_ids=rng.integers(0, cfg.vocab_size, plen).tolist(),
                               max_new_tokens=1, temperature=1.0)
                    for i in range(rows)]
            for r in reqs:
                eng.submit(r)
            _sync(eng)
            t0 = time.perf_counter()
            eng.step()
            _sync(eng)
            dt = time.perf_counter() - t0
            while any(not r.stop_reason for r in reqs):
                eng.step()
        out[f"bucket_{bucket}"] = {
            "tokens_per_sec": round(rows * plen / dt, 1),
            "ms": round(dt * 1e3, 1),
        }
        print(f"prefill bucket={bucket}: {out[f'bucket_{bucket}']}", file=sys.stderr,
              flush=True)
    out["prefill_tokens"] = eng.stats["prefill_tokens"]
    out["k2_calls"] = _retire(eng)
    return out


def bench_multi_turn(cfg, params, n_convs=8, turns=4, turn_prompt=64, turn_gen=32,
                     max_seq_len=1024):
    """T-turn conversations: each turn replays the transcript + new user
    tokens.  Reuse engine against cold engine, wall clock + prefill-token
    accounting."""
    out = {"k2_calls": 0}
    for mode in ("reuse", "cold"):
        rng = np.random.default_rng(2)  # identical workload both modes
        eng = _engine(cfg, params, n_convs, max_seq_len, kv_reuse=(mode == "reuse"))
        # warm each path the timed loop runs once: a fresh prefill, a second
        # turn's suffix prefill, decode (the reference replays every turn
        # to compile each XLA program; the port compiles nothing)
        warm_tr = [[1] * turn_prompt for _ in range(n_convs)]
        for _ in range(min(turns, 2)):
            wreqs = [GenRequest(rid=f"w{i}", input_ids=list(warm_tr[i]),
                                max_new_tokens=8, temperature=1.0)
                     for i in range(n_convs)]
            for r in wreqs:
                eng.submit(r)
            while any(not r.stop_reason for r in wreqs):
                eng.step()
            for i, r in enumerate(wreqs):
                warm_tr[i] = warm_tr[i] + r.output_tokens + [2] * turn_prompt
        out["k2_calls"] += _reset_stats(eng)  # the warm-up must not skew the accounting
        _forget_retained(eng)  # nor seed a reusable prefix
        transcripts = [rng.integers(0, cfg.vocab_size, turn_prompt).tolist()
                       for _ in range(n_convs)]
        _sync(eng)
        t0 = time.perf_counter()
        for _ in range(turns):
            reqs = [GenRequest(rid=f"c{i}", input_ids=list(transcripts[i]),
                               max_new_tokens=turn_gen, temperature=1.0)
                    for i in range(n_convs)]
            for r in reqs:
                eng.submit(r)
            while any(not r.stop_reason for r in reqs):
                eng.step()
            for i, r in enumerate(reqs):
                transcripts[i] = (transcripts[i] + r.output_tokens
                                  + rng.integers(0, cfg.vocab_size, turn_prompt).tolist())
        _sync(eng)
        dt = time.perf_counter() - t0
        out[mode] = {
            "wall_s": round(dt, 2),
            "prefill_tokens": eng.stats["prefill_tokens"],
            "suffix_tokens": eng.stats["suffix_tokens"],
            "reused_tokens": eng.stats["reused_tokens"],
        }
        print(f"multi_turn {mode}: {out[mode]}", file=sys.stderr, flush=True)
        out["k2_calls"] += _retire(eng)
        del eng
    out["speedup"] = round(out["cold"]["wall_s"] / out["reuse"]["wall_s"], 3)
    return out


def bench_group_fanout(cfg, params, group_size=8, n_groups=6, prompt_len=256,
                       gen_tokens=16, max_seq_len=1024):
    """GRPO-shaped admission: `n_groups` groups of `group_size` requests
    over ONE prompt each (distinct prompts across groups).  Share engine
    (group fan-out prefill) against no-share engine over the identical
    workload; reports wall clock plus `shared_prefill_fraction`, the
    fraction of grouped prompt tokens never recomputed.

    A third pass (`share_host`) reruns the share workload with the host KV
    tier on and retained prefixes spilling between groups; its streams
    must equal the device-only share pass's."""
    out = {"group_size": group_size, "n_groups": n_groups, "prompt_len": prompt_len,
           "k2_calls": 0}
    streams = {}  # mode -> [[output_tokens per sibling] per group]
    mode_kw = {
        "share": dict(share_prefix=True),
        "noshare": dict(share_prefix=False),
        "share_host": dict(share_prefix=True, host_offload=True, host_cache_mb=32,
                           host_min_tokens=16),
    }
    for mode in ("share", "noshare", "share_host"):
        rng = np.random.default_rng(5)  # identical workload all modes
        eng = _engine(cfg, params, group_size, max_seq_len, **mode_kw[mode])

        def run_group(prompt, tag):
            reqs = [GenRequest(rid=f"{tag}-{i}", input_ids=list(prompt),
                               max_new_tokens=gen_tokens, temperature=1.0,
                               group_id=tag, group_n=group_size)
                    for i in range(group_size)]
            eng.submit_batch(reqs)
            while any(not r.stop_reason for r in reqs):
                eng.step()
            return reqs

        # warm every shape the timed loop hits (prefill, fan-out copy,
        # sibling suffix, decode)
        run_group([1] * prompt_len, "warm")
        out["k2_calls"] += _reset_stats(eng)
        _forget_retained(eng)  # no cross-group retained carryover
        _sync(eng)
        t0 = time.perf_counter()
        for g in range(n_groups):
            # mode-independent tag: stream keys derive from the rid, so
            # the cross-mode stream check needs identical rids
            done = run_group(rng.integers(0, cfg.vocab_size, prompt_len).tolist(), f"g{g}")
            streams.setdefault(mode, []).append([r.output_tokens for r in done])
        _sync(eng)
        dt = time.perf_counter() - t0
        st = eng.stats
        total = (st["prefill_tokens"] + st["suffix_tokens"] + st["reused_tokens"]
                 + st["shared_tokens"])
        out[mode] = {
            "wall_s": round(dt, 2),
            "prefill_tokens": st["prefill_tokens"],
            "suffix_tokens": st["suffix_tokens"],
            "reused_tokens": st["reused_tokens"],
            "shared_tokens": st["shared_tokens"],
            "copy_calls": st["copy_calls"],
            "shared_prefill_fraction": round(st["shared_tokens"] / max(total, 1), 4),
        }
        if mode == "share_host":
            out[mode]["prefix_cache_host_swaps"] = st["prefix_cache_host_swaps"]
            out[mode]["prefix_cache_evictions"] = st["prefix_cache_evictions"]
        print(f"group_fanout {mode}: {out[mode]}", file=sys.stderr, flush=True)
        out["k2_calls"] += _retire(eng)
        del eng
    out["shared_prefill_fraction"] = out["share"]["shared_prefill_fraction"]
    # the host tier must be invisible to the counter-keyed sampler
    out["streams_bit_identical"] = streams["share"] == streams["share_host"]
    out["speedup"] = round(out["noshare"]["wall_s"] / max(out["share"]["wall_s"], 1e-9), 3)
    return out


def bench_decode_ceiling_ab(cfg, params, n_slots=16, ceilings=(4096, 16384), prompt_len=64,
                            gen_tokens=128, tiers=1):
    """The SAME decode workload under different `max_seq_len` ceilings.
    The ragged kernel reads each slot's occupied pages, so the large
    ceiling's tokens/s should stay near the small one's.  Reports
    per-ceiling tokens/s, `decode_attended_fraction` and the large/small
    throughput ratio."""
    out = {"n_slots": n_slots, "prompt_len": prompt_len, "gen_tokens": gen_tokens,
           "decode_tiers": tiers, "k2_calls": 0}
    per = {}
    for ceiling in ceilings:
        rng = np.random.default_rng(7)  # identical workload per ceiling
        try:
            eng = _engine(cfg, params, n_slots, ceiling, kv_reuse=False, decode_tiers=tiers)
            warm = [GenRequest(rid=f"w{i}",
                               input_ids=rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                               max_new_tokens=8, temperature=1.0)
                    for i in range(n_slots)]
            eng.generate_blocking(warm)
            out["k2_calls"] += _reset_stats(eng)
            reqs = [GenRequest(rid=f"m{i}",
                               input_ids=rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                               max_new_tokens=gen_tokens, temperature=1.0)
                    for i in range(n_slots)]
            delivered, dt, _ = _timed_decode(eng, reqs)
            per[str(ceiling)] = {
                "tokens_per_sec": round(delivered / dt, 1),
                "wall_s": round(dt, 2),
                "decode_attended_fraction": round(decode_attended_fraction(eng), 4),
            }
            print(f"ceiling_ab max_seq_len={ceiling}: {per[str(ceiling)]}", file=sys.stderr,
                  flush=True)
            out["k2_calls"] += _retire(eng)
            del eng
        except Exception as e:  # noqa: BLE001 — record and continue the A/B
            per[str(ceiling)] = {"error": str(e)[:200]}
            print(f"ceiling_ab max_seq_len={ceiling} failed: {str(e)[:120]}", file=sys.stderr,
                  flush=True)
    out["by_ceiling"] = per
    lo, hi = str(min(ceilings)), str(max(ceilings))
    if "tokens_per_sec" in per.get(lo, {}) and "tokens_per_sec" in per.get(hi, {}):
        out["large_over_small_tok_s"] = round(
            per[hi]["tokens_per_sec"] / max(per[lo]["tokens_per_sec"], 1e-9), 3)
    return out


def _repetition_params(cfg, params):
    """Repetition-heavy synthetic regime: zeroing every layer's attention
    output projection makes greedy next-token a pure function of the
    current token, so every stream settles into a short cycle — the
    deterministic stand-in for the restatement loops that the
    prompt-lookup drafter feeds on.  The engine's cost per dispatch is
    unchanged.  A copy of the model: the caller's weights stay as they
    are."""
    rep = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in rep.named_parameters():
            if name.endswith("self_attn.o_proj.weight") or name.endswith("self_attn.o_proj.bias"):
                p.zero_()
    return rep


@torch.no_grad()
def greedy_map(cfg, rep_params, chunk=4096) -> np.ndarray:
    """The greedy next token of every vocabulary id under the repetition
    params, in one batched pass of one-token rows: their attention adds
    exactly nothing (its output projection is zero), so each layer is its
    residual plus its MLP, and the next token is a function of the current
    one alone."""
    device = next(rep_params.parameters()).device
    out = []
    for lo in range(0, cfg.vocab_size, chunk):
        ids = torch.arange(lo, min(lo + chunk, cfg.vocab_size), device=device)[:, None]
        x = rep_params.embed(ids, torch.zeros_like(ids))
        for layer in rep_params.model.layers:
            x = layer(x, None, lambda q, k, v: torch.zeros_like(q))
        out.append(rep_params.logits(x)[:, 0].argmax(-1).cpu())
    return torch.cat(out).numpy()


def map_cycles(nxt) -> List[List[int]]:
    """Every cycle of the map i -> nxt[i], shortest first."""
    nxt = [int(t) for t in nxt]
    state = [0] * len(nxt)  # 0 unseen, 1 on the current walk, 2 done
    cycles = []
    for start in range(len(nxt)):
        path, i = [], start
        while state[i] == 0:
            state[i] = 1
            path.append(i)
            i = nxt[i]
        if state[i] == 1:
            cycles.append(path[path.index(i):])
        for j in path:
            state[j] = 2
    return sorted(cycles, key=len)


def bench_spec_decode_ab(cfg, params, n_slots=8, prompt_len=64, gen_tokens=128,
                         max_seq_len=512, draft_len=31, seed_on_cycles=False):
    """The SAME repetition-heavy greedy workload with speculative decoding
    off and on.  Reports per-arm tokens/s, draft/accept counters, whether
    the streams are equal (the correctness contract rides along with the
    number) and the on/off throughput ratio.

    Prompts are the model's OWN prior greedy output (an untimed setup
    rollout from one seed token per slot) — the continuation-of-own-output
    shape that self-speculation targets.  The seeds are random tokens, as
    in the reference; at a large vocabulary their rollouts are still on
    the way into a cycle after `prompt_len` tokens and hold no repeated
    n-gram, so the drafter has nothing to offer.  `seed_on_cycles` seeds
    each slot instead on one of the shortest cycles of the greedy map
    (`greedy_map`, a slot a cycle while there are cycles of at most half
    the prompt), so that every prompt repeats its cycle; a slot whose
    rollout did not repeat takes the prompt of one that did."""
    rep_params = _repetition_params(cfg, params)
    out = {"n_slots": n_slots, "prompt_len": prompt_len, "gen_tokens": gen_tokens,
           "draft_len": draft_len}
    if seed_on_cycles:
        cycles = map_cycles(greedy_map(cfg, rep_params))
        short = [c for c in cycles if len(c) <= prompt_len // 2] or cycles[:1]
        seeds = [short[i % len(short)][0] for i in range(n_slots)]
        out["cycle_lengths"] = [len(c) for c in cycles[:n_slots]]
    else:
        seeds = np.random.default_rng(9).integers(0, cfg.vocab_size, n_slots).tolist()
    seed_eng = _engine(cfg, rep_params, n_slots, max_seq_len, kv_reuse=False)
    seed_reqs = [GenRequest(rid=f"s{i}", input_ids=[int(s)], max_new_tokens=prompt_len - 1,
                            temperature=0.0)
                 for i, s in enumerate(seeds)]
    seed_eng.generate_blocking(seed_reqs)
    prompts = [[int(s)] + list(r.output_tokens) for s, r in zip(seeds, seed_reqs)]
    if seed_on_cycles:
        # the engine's greedy step can part from the batched map's where
        # bf16 rounding decides the argmax, and then its rollout leaves the
        # cycle: such a slot takes the prompt of one that did repeat
        good = [p for p in prompts if len(set(p)) <= prompt_len // 2]
        prompts = [good[i % len(good)] for i in range(n_slots)] if good else prompts
    # the drafter looks n-grams up in each slot's history: a prompt of all
    # distinct tokens (a greedy cycle longer than the prompt) gives it none
    out["prompt_distinct_tokens"] = [len(set(p)) for p in prompts]
    out["k2_calls"] = _retire(seed_eng)
    del seed_eng
    streams = {}
    for mode in ("off", "on"):
        kw = dict(spec_decode=True, spec_draft_len=draft_len or None) if mode == "on" else {}
        eng = _engine(cfg, rep_params, n_slots, max_seq_len, kv_reuse=False, **kw)
        # full-length warm-up over the same shapes as the timed loop
        warm = [GenRequest(rid=f"w{i}", input_ids=list(p), max_new_tokens=gen_tokens,
                           temperature=0.0)
                for i, p in enumerate(prompts)]
        eng.generate_blocking(warm)
        out["k2_calls"] += _reset_stats(eng)
        _forget_retained(eng)
        reqs = [GenRequest(rid=f"m{i}", input_ids=list(p), max_new_tokens=gen_tokens,
                           temperature=0.0)
                for i, p in enumerate(prompts)]
        delivered, dt, _ = _timed_decode(eng, reqs)
        streams[mode] = [tuple(r.output_tokens) for r in reqs]
        drafted = eng.stats["spec_drafted"]
        accepted = eng.stats["spec_accepted"]
        out[mode] = {
            "tokens_per_sec": round(delivered / dt, 1),
            "wall_s": round(dt, 2),
            "decode_calls": eng.stats["decode_calls"],
            "decode_steps": eng.stats["decode_steps"],
            "verify_calls": eng.stats["verify_calls"],
            "spec_draft_tokens": drafted,
            "spec_accepted_tokens": accepted,
            "spec_acceptance_rate": round(accepted / max(1, drafted), 4),
        }
        print(f"spec_ab {mode}: {out[mode]}", file=sys.stderr, flush=True)
        out["k2_calls"] += _retire(eng)
        del eng
    out["streams_bit_identical"] = streams["on"] == streams["off"]
    out["spec_over_plain_tok_s"] = round(
        out["on"]["tokens_per_sec"] / max(out["off"]["tokens_per_sec"], 1e-9), 3)
    return out


def device_kind(device) -> str:
    dev = torch.device(device or "cuda")
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slots", default="8,32,64,128,256")
    p.add_argument("--skip-decode", action="store_true")
    p.add_argument("--skip-prefill", action="store_true")
    p.add_argument("--skip-multi-turn", action="store_true")
    p.add_argument("--skip-group", action="store_true")
    p.add_argument("--skip-ceiling-ab", action="store_true")
    # the ceiling A/B
    p.add_argument("--ab-slots", type=int, default=16)
    p.add_argument("--ab-ceilings", default="4096,16384")
    p.add_argument("--ab-prompt", type=int, default=64)
    p.add_argument("--ab-gen", type=int, default=128)
    p.add_argument("--ab-tiers", type=int, default=1)
    # speculative decoding
    p.add_argument("--spec-decode", action="store_true",
                   help="run the decode curve with self-speculative decoding on")
    p.add_argument("--draft-len", type=int, default=31,
                   help="pin the draft length D (0 = adaptive ladder)")
    p.add_argument("--ab-spec", action="store_true",
                   help="spec-on/off A/B on the repetition-heavy workload")
    p.add_argument("--spec-slots", type=int, default=8)
    p.add_argument("--spec-gen", type=int, default=128)
    p.add_argument("--spec-seed-on-cycles", action="store_true",
                   help="seed the A/B's prompts on the greedy map's shortest cycles")
    p.add_argument("--ab-ragged", action="store_true",
                   help="refused: the port has no dense decode path to compare")
    # group fan-out
    p.add_argument("--group-size", type=int, default=8)
    p.add_argument("--group-prompt", type=int, default=256)
    p.add_argument("--n-groups", type=int, default=6)
    # multi-turn
    p.add_argument("--turn-prompt", type=int, default=512)
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--turn-gen", type=int, default=32)
    p.add_argument("--mt-max-seq-len", type=int, default=4096)
    p.add_argument("--model", default="qwen25_1p5b", choices=MODELS,
                   help="tiny = CPU smoke mode (token accounting only)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--telemetry-dir", default="",
                   help="enable telemetry and dump events.jsonl + the gen registry here")
    args = p.parse_args(argv)
    if args.ab_ragged:
        p.error(NO_RAGGED_AB)

    from areal_tpu_torch.utils import telemetry

    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)
        telemetry.set_enabled(True)

    cfg, params = serving_model_setup(args.model, args.device)
    result = {"model": args.model, "device_kind": device_kind(args.device)}
    if not args.skip_decode:
        result["decode"] = bench_decode(
            cfg, params, [int(s) for s in args.slots.split(",")],
            spec_decode=args.spec_decode, draft_len=args.draft_len)
    if not args.skip_prefill:
        result["prefill"] = bench_prefill(cfg, params)
    if not args.skip_multi_turn:
        result["multi_turn"] = bench_multi_turn(
            cfg, params, turns=args.turns, turn_prompt=args.turn_prompt,
            turn_gen=args.turn_gen, max_seq_len=args.mt_max_seq_len)
    if not args.skip_group and args.group_size > 1:
        result["grouped"] = bench_group_fanout(
            cfg, params, group_size=args.group_size, n_groups=args.n_groups,
            prompt_len=args.group_prompt)
    if args.ab_spec:
        result["spec_ab"] = bench_spec_decode_ab(
            cfg, params, n_slots=args.spec_slots, gen_tokens=args.spec_gen,
            draft_len=args.draft_len, seed_on_cycles=args.spec_seed_on_cycles)
    if not args.skip_ceiling_ab:
        result["decode_ceiling_ab"] = bench_decode_ceiling_ab(
            cfg, params, n_slots=args.ab_slots,
            ceilings=tuple(int(c) for c in args.ab_ceilings.split(",")),
            prompt_len=args.ab_prompt, gen_tokens=args.ab_gen, tiers=args.ab_tiers)
    if args.telemetry_dir:
        events_path = os.path.join(args.telemetry_dir, "events.jsonl")
        snap_path = os.path.join(args.telemetry_dir, "metrics.json")
        n_events = telemetry.EVENTS.dump_jsonl(events_path)
        with open(snap_path, "w") as f:
            json.dump({"gen": telemetry.GEN.snapshot()}, f, indent=2, default=str)
        result["telemetry"] = {"dir": args.telemetry_dir, "events_jsonl": events_path,
                               "metrics_snapshot": snap_path, "n_events": n_events}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
