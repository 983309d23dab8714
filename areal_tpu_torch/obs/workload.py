"""Arrival processes for trace-driven load replay (the port's copy of
`areal_tpu/obs/workload.py`, standard library only).

`areal_tpu_torch/scripts/bench_replay.py` needs a list of *when* requests arrive and
*what shape* they are.  Two sources:

- :func:`arrivals_from_trace` — replay a recorded run: every
  ``rollout_submit`` in a lifecycle JSONL becomes an arrival at its
  original relative wall time, with the prompt length from the submit
  record and the decode budget from the matching ``gen_done`` (so the
  replayed load reproduces the recorded compute mix, not just the
  arrival clock).
- :func:`synthetic_mixed` — a seeded synthetic mix of the three traffic
  shapes that fleet claims rest on: *chat bursts* (a Poisson
  process of bursts, each a quick volley of short prompts), *GRPO
  groups* (``group_n`` siblings sharing one prompt, arriving together —
  exercises shared prefill), and *long-context stragglers* (rare, big
  prompt, big budget — exercises tier migration and admission holds).

:func:`scale` compresses the arrival clock by a rate multiplier; shapes
are untouched, so a 16× replay is "the same work, sixteen times as
fast", which is exactly what a latency-vs-throughput curve wants.

Determinism: all randomness comes from one `random.Random(seed)`; the
same (seed, duration, base_rps) always yields the same workload, so
replay curves are comparable across commits.  Stdlib-only, offline —
nothing here touches the engine.
"""

import dataclasses
import random
from typing import Any, Dict, Iterable, List

from areal_tpu_torch.obs.trace import EventSource, iter_events


@dataclasses.dataclass
class Arrival:
    """One request in an arrival process (times relative to run start)."""

    t: float                 # arrival time, seconds from start
    prompt_len: int
    max_new_tokens: int
    kind: str = "chat"       # chat | group | straggler | trace
    group_id: str = ""       # nonempty: GRPO siblings share a prompt
    group_n: int = 1
    trace_id: str = ""       # original trace id when replaying a trace


def arrivals_from_trace(source: EventSource, *,
                        default_budget: int = 64) -> List[Arrival]:
    """Extract the arrival process of a recorded run from its lifecycle
    JSONL: submit times + prompt lengths from ``rollout_submit``, decode
    budgets from each trace's ``gen_done.output_len`` (falling back to
    ``default_budget`` for trajectories still open at dump time)."""
    events = iter_events(source)
    out_len: Dict[str, int] = {}
    for e in events:
        if e.get("event") == "gen_done" and e.get("trace_id"):
            n = e.get("output_len")
            if n:
                out_len[e["trace_id"]] = int(n)
    submits = [e for e in events if e.get("event") == "rollout_submit"]
    if not submits:
        return []
    t0 = min(float(e["ts"]) for e in submits)
    arrivals = [
        Arrival(
            t=float(e["ts"]) - t0,
            prompt_len=max(1, int(e.get("input_len", 1) or 1)),
            max_new_tokens=out_len.get(e.get("trace_id", ""), default_budget),
            kind="trace",
            group_id=str(e.get("group_id", "") or ""),
            trace_id=str(e.get("trace_id", "") or ""),
        )
        for e in submits
    ]
    arrivals.sort(key=lambda a: a.t)
    return arrivals


def synthetic_mixed(*, seed: int, duration_s: float, base_rps: float,
                    max_prompt_len: int = 128,
                    max_new_tokens: int = 64) -> List[Arrival]:
    """Seeded synthetic mixed workload over ``duration_s`` seconds.

    Component rates are fractions of ``base_rps`` (expected *request*
    rate, all components combined, is roughly ``base_rps``): chat bursts
    carry most of the volume, GRPO groups arrive less often but bring
    ``group_n`` siblings each, stragglers are rare and heavy.
    """
    rng = random.Random(seed)
    arrivals: List[Arrival] = []

    def poisson_times(rate: float) -> Iterable[float]:
        t = 0.0
        while True:
            if rate <= 0:
                return
            t += rng.expovariate(rate)
            if t >= duration_s:
                return
            yield t

    # Chat bursts: ~60% of volume; burst of 2-6 requests 10-50ms apart.
    mean_burst = 4.0
    for tb in list(poisson_times(0.60 * base_rps / mean_burst)):
        for i in range(2 + rng.randrange(5)):
            arrivals.append(Arrival(
                t=tb + i * rng.uniform(0.01, 0.05),
                prompt_len=rng.randrange(8, max(9, max_prompt_len // 2)),
                max_new_tokens=rng.randrange(4, max(5, max_new_tokens // 2)),
                kind="chat",
            ))

    # GRPO groups: ~35% of volume in groups of 4 sharing a prompt.
    group_n = 4
    for gi, tg in enumerate(list(poisson_times(0.35 * base_rps / group_n))):
        plen = rng.randrange(8, max(9, (3 * max_prompt_len) // 4))
        budget = rng.randrange(8, max(9, max_new_tokens))
        for _ in range(group_n):
            arrivals.append(Arrival(
                t=tg, prompt_len=plen, max_new_tokens=budget,
                kind="group", group_id=f"g{seed}-{gi}", group_n=group_n,
            ))

    # Long-context stragglers: ~5% of volume, near-max prompt + budget.
    for ts in list(poisson_times(0.05 * base_rps)):
        arrivals.append(Arrival(
            t=ts,
            prompt_len=max(8, (3 * max_prompt_len) // 4
                           + rng.randrange(max(1, max_prompt_len // 4))),
            max_new_tokens=max_new_tokens,
            kind="straggler",
        ))

    arrivals.sort(key=lambda a: a.t)
    return arrivals


def scale(arrivals: List[Arrival], rate: float) -> List[Arrival]:
    """Compress the arrival clock by ``rate`` (2.0 = twice as fast);
    request shapes are unchanged."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return [dataclasses.replace(a, t=a.t / rate) for a in arrivals]


def summarize(arrivals: List[Arrival]) -> Dict[str, Any]:
    """Small JSON-able description of a workload for report headers."""
    by_kind: Dict[str, int] = {}
    for a in arrivals:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
    dur = arrivals[-1].t if arrivals else 0.0
    return {
        "n": len(arrivals),
        "by_kind": by_kind,
        "span_s": dur,
        "offered_rps": (len(arrivals) / dur) if dur > 0 else None,
        "prompt_tokens": sum(a.prompt_len for a in arrivals),
        "budget_tokens": sum(a.max_new_tokens for a in arrivals),
        "groups": len({a.group_id for a in arrivals if a.group_id}),
    }


def prompt_ids(a: Arrival, *, vocab: int, seed: int) -> List[int]:
    """Deterministic token ids for an arrival's prompt.  Group siblings
    (same ``group_id``) get identical prompts — that is the whole point
    of the group component (shared prefill); everything else is keyed by
    its position-independent identity."""
    key = a.group_id if a.group_id else f"{a.kind}-{a.t:.6f}-{a.prompt_len}"
    rng = random.Random(f"{seed}:{key}")
    lo, hi = 3, max(4, vocab - 1)
    return [rng.randrange(lo, hi) for _ in range(a.prompt_len)]
