"""Lifecycle-JSONL trace analytics: records, completeness, decomposition
(the port's copy of `areal_tpu/obs/trace.py`, standard library only).

Input is the event stream of :mod:`areal_tpu_torch.utils.telemetry`
(``EventLog.dump_jsonl`` or ``EVENTS.snapshot()``).  Three consumers live
here:

1. **Per-trajectory records** (:class:`TrajectoryRecord`): every trace
   id's events are folded through a small state machine into a stage
   partition of the ``[rollout_submit, gen_done]`` wall span —
   ``admission_wait`` → ``prefill`` → ``decode`` (per-tier chunk
   latencies included) → ``interrupted`` (publish aborts and failover
   windows) → ``tail`` (delivery + client return) — plus reward latency
   and train-consume staleness joined via ``trace_key``.

2. **Completeness linter** (:class:`Completeness`): a log is only
   trustworthy if every referenced span has its opening record — no
   orphan trace ids (events whose submit/admission fell off the ring),
   every ``resubmit`` joins an earlier ``rollout_submit`` for the same
   trace, interrupts on closed traces are followed by a resume or
   re-admission, and the ring itself reports zero dropped events
   (``telemetry_meta`` trailer, written by ``dump_jsonl`` on overflow).
   Open (in-flight at dump time) traces are normal under the async
   executor and are reported, not failed, unless ``strict_open``.

3. **Accounting identity**: the stage partition is built purely from
   event timestamps, while ``gen_done.latency_s`` is measured
   independently by the client around its HTTP/engine call.  For every
   closed trajectory the two must agree: ``|sum(stages) - latency_s|``
   within ``tolerance`` (relative) or ``abs_floor_s`` — a broken identity
   means the decomposition is lying and the report says so.

Clock discipline: events carry paired clocks (wall ``ts`` + monotonic
``mono`` with the emitting ``pid``).  When every event of a trajectory
comes from one process the monotonic clock is used (immune to NTP
steps); otherwise wall time joins across processes.  Chunk *durations*
(``latency_s``) are perf_counter deltas either way.

Strictly post-hoc: this module reads dumped JSONL, never engine
internals.
"""

import dataclasses
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

# Events that open a trajectory span (roots).  A client-side log has
# rollout_submit; a server-only log (bench_serving) roots at admission.
_ROOT_EVENTS = ("rollout_submit", "admission")
# Events that close a trajectory span.
_TERMINAL_EVENTS = ("gen_done", "rollout_lost")
# Per-trace events that require a root to be meaningful; seeing one for
# a trace with no root means the head of the log was lost.
_REQUIRES_ROOT = (
    "prefill", "resume", "resubmit", "resubmit_cache_hit", "interrupt",
    "reward", "gen_done", "rollout_lost", "handoff",
)
# Global (traceless) events: never orphan candidates.  run_restart marks
# a trainer relaunch resuming from a recover generation (utils/recover.py)
# — the boundary event a stitched multi-run log must carry to stay
# complete.
_GLOBAL_EVENTS = (
    "pause", "episode", "trajectory_lost", "telemetry_meta", "run_restart",
)

EventSource = Union[str, Iterable[Dict[str, Any]]]


def iter_events(source: EventSource) -> List[Dict[str, Any]]:
    """Load events from a JSONL path or pass an event list through.
    Blank lines are skipped; a malformed line raises (a trace log is
    evidence — silently skipping corrupt records would undercount)."""
    if isinstance(source, str):
        out: List[Dict[str, Any]] = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
    return list(source)


def dist_summary(values: Iterable[float]) -> Optional[Dict[str, float]]:
    """{count, mean, min, p50, p90, p99, max} or None for no samples.
    Percentiles are linear-interpolated on the sorted sample."""
    vals = sorted(float(v) for v in values
                  if v is not None and math.isfinite(v))
    if not vals:
        return None

    def pct(q: float) -> float:
        if len(vals) == 1:
            return vals[0]
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    return {
        "count": len(vals),
        "mean": sum(vals) / len(vals),
        "min": vals[0],
        "p50": pct(0.50),
        "p90": pct(0.90),
        "p99": pct(0.99),
        "max": vals[-1],
    }


@dataclasses.dataclass
class TrajectoryRecord:
    """One trace id's reconstructed lifecycle."""

    trace_id: str
    trace_key: Optional[int] = None
    group_id: Optional[str] = None
    server: Optional[str] = None
    input_len: Optional[int] = None
    output_len: Optional[int] = None
    stop_reason: Optional[str] = None
    attempts: int = 1
    resubmits: int = 0
    resubmit_cache_hits: int = 0
    resubmit_cache_hit_tokens: int = 0
    interrupts: int = 0
    handoffs: int = 0
    handoff_bytes: int = 0
    closed: bool = False
    lost: bool = False
    has_submit: bool = False
    has_admission: bool = False
    clock: str = "mono"            # which clock built the stage partition
    # Stage partition of [root, terminal] in seconds.  Keys among:
    # admission_wait / prefill / decode / handoff / interrupted / tail
    # / opaque.
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    span_s: Optional[float] = None       # terminal - root, event clocks
    e2e_s: Optional[float] = None        # gen_done.latency_s (client)
    identity_err_s: Optional[float] = None
    identity_rel: Optional[float] = None
    ttft_s: Optional[float] = None
    inter_token_s: Optional[float] = None
    n_chunks: int = 0
    tiers: List[int] = dataclasses.field(default_factory=list)
    prefill_kinds: List[str] = dataclasses.field(default_factory=list)
    cold_tokens: int = 0
    inherited_tokens: int = 0
    reward: Optional[float] = None
    reward_latency_s: Optional[float] = None
    staleness: Optional[float] = None
    consume_latency_s: Optional[float] = None

    def stage_sum(self) -> float:
        return sum(self.stages.values())


@dataclasses.dataclass
class Completeness:
    """Result of the trace completeness linter."""

    complete: bool = True
    dropped_events: int = 0
    n_events: int = 0
    n_traces: int = 0
    open_traces: int = 0
    orphan_traces: List[str] = dataclasses.field(default_factory=list)
    unjoined_resubmits: int = 0
    incomplete_interrupts: int = 0
    unmatched_consumes: int = 0
    strict_open: bool = False
    errors: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TraceReport:
    records: List[TrajectoryRecord]
    completeness: Completeness
    pauses: List[Dict[str, Any]]
    chunk_latency_by_tier: Dict[int, List[float]]
    wall_span_s: float
    # run_restart boundary events (utils/recover.py): one per trainer
    # relaunch that resumed from a recover generation — the seam where a
    # stitched multi-run log changes pid
    restarts: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def closed(self) -> List[TrajectoryRecord]:
        return [r for r in self.records if r.closed and not r.lost]


def _clock_picker(events: List[Dict[str, Any]]) -> Tuple[str, Any]:
    """Choose the boundary clock for one trajectory's events: monotonic
    when every event has one and all share a pid, else wall time."""
    pids = set()
    for e in events:
        if "mono" not in e or "pid" not in e:
            return "ts", (lambda e: float(e["ts"]))
        pids.add(e["pid"])
    if len(pids) == 1:
        return "mono", (lambda e: float(e["mono"]))
    return "ts", (lambda e: float(e["ts"]))


def _build_record(trace_id: str, events: List[Dict[str, Any]]) -> TrajectoryRecord:
    """Fold one trace's events (log order) into a TrajectoryRecord via
    the stage state machine described in the module docstring."""
    rec = TrajectoryRecord(trace_id=trace_id)
    clock_name, t_of = _clock_picker(events)
    rec.clock = clock_name

    submit = next((e for e in events if e["event"] == "rollout_submit"), None)
    terminal = next((e for e in events if e["event"] in _TERMINAL_EVENTS), None)
    rec.has_submit = submit is not None
    rec.has_admission = any(e["event"] == "admission" for e in events)
    root = submit
    if root is None:
        root = next((e for e in events if e["event"] == "admission"), None)
    if root is None:
        return rec  # orphan: caller records it via completeness

    rec.trace_key = root.get("trace_key")
    if submit is not None:
        rec.group_id = submit.get("group_id") or None
        rec.server = submit.get("server")
        rec.input_len = submit.get("input_len")

    # --- stage state machine -------------------------------------------
    cursor = t_of(root)
    t_root = cursor
    # With a submit root the first segment is queue time; with an
    # admission root we are already in prefill.
    state = "admission_wait" if submit is not None else "prefill"
    stages: Dict[str, float] = {}
    first_chunk_end: Optional[float] = None
    last_chunk_end: Optional[float] = None

    def close(upto: float, into: str) -> float:
        nonlocal cursor
        seg = max(0.0, upto - cursor)
        if seg:
            stages[into] = stages.get(into, 0.0) + seg
        cursor = max(cursor, upto)
        return seg

    for e in events:
        name = e["event"]
        t = t_of(e)
        if name == "admission":
            close(t, state)
            state = "prefill"
            rec.has_admission = True
        elif name == "prefill":
            rec.prefill_kinds.append(str(e.get("kind", "")))
            rec.cold_tokens += int(e.get("cold_tokens", 0) or 0)
            rec.inherited_tokens += int(e.get("inherited_tokens", 0) or 0)
        elif name in ("decode_chunk", "spec_verify"):
            lat = float(e.get("latency_s", 0.0) or 0.0)
            start = max(cursor, t - lat)
            close(start, state)
            close(t, "decode")
            state = "decode"
            rec.n_chunks += 1
            tier = e.get("tier")
            if tier is not None and tier not in rec.tiers:
                rec.tiers.append(tier)
            if first_chunk_end is None:
                first_chunk_end = t
            last_chunk_end = t
        elif name == "handoff":
            # Disaggregated prefill->decode transfer: the
            # router measures the full export+import leg and stamps it
            # as latency_s; everything before the leg stays in the
            # prior stage (decode chunks served on the prefill server),
            # and the leg itself becomes its own stage so SLO reports
            # can band it.
            lat = float(e.get("latency_s", 0.0) or 0.0)
            start = max(cursor, t - lat)
            close(start, state)
            close(t, "handoff")
            state = "handoff"
            rec.handoffs += 1
            rec.handoff_bytes += int(e.get("bytes", 0) or 0)
        elif name == "interrupt":
            close(t, state)
            state = "interrupted"
            rec.interrupts += 1
        elif name in ("resume", "resubmit"):
            close(t, state)
            state = "interrupted"
            if name == "resubmit":
                rec.resubmits += 1
        elif name == "resubmit_cache_hit":
            # A failover resubmit whose replacement server warm-started the
            # accumulated prefix through the radix/paged cache.
            # Pure annotation on the in-flight attempt: no stage boundary.
            rec.resubmit_cache_hits += 1
            rec.resubmit_cache_hit_tokens += int(e.get("hit_tokens", 0) or 0)
        elif name in _TERMINAL_EVENTS:
            # Delivery + HTTP return after the last decode chunk is its
            # own "tail" stage; any other state closes into itself
            # (e.g. a trace lost while queued stays admission_wait).
            close(t, "tail" if state == "decode" else state)
            rec.closed = True
            rec.lost = name == "rollout_lost"
            if name == "gen_done":
                rec.output_len = e.get("output_len")
                rec.stop_reason = e.get("stop_reason")
                rec.attempts = int(e.get("attempts", 1) or 1)
                lat = e.get("latency_s")
                rec.e2e_s = float(lat) if lat is not None else None
                ttft = e.get("ttft_s")
                if ttft is not None and math.isfinite(float(ttft)):
                    rec.ttft_s = float(ttft)
            break

    if terminal is not None and rec.closed:
        rec.span_s = max(0.0, t_of(terminal) - t_root)
        # A client-only log (no server-side spans in this process's
        # ring, e.g. the chaos harness's fake servers) has nothing to
        # decompose: report the whole span as opaque server time rather
        # than mislabeling it queue wait.
        if not rec.has_admission and rec.n_chunks == 0:
            stages = {"opaque": rec.span_s}
        rec.stages = stages
        if rec.e2e_s is not None:
            rec.identity_err_s = abs(rec.stage_sum() - rec.e2e_s)
            rec.identity_rel = rec.identity_err_s / max(rec.e2e_s, 1e-9)
    else:
        rec.stages = stages  # open trace: partial partition up to last event

    if rec.ttft_s is None and first_chunk_end is not None and submit is not None:
        rec.ttft_s = max(0.0, first_chunk_end - t_root)
    if (rec.e2e_s is not None and rec.ttft_s is not None
            and rec.output_len and rec.output_len > 1):
        rec.inter_token_s = max(0.0, rec.e2e_s - rec.ttft_s) / (rec.output_len - 1)

    # Post-terminal joins (reward, train consumption) use wall time:
    # they may legitimately come from another process.
    if terminal is not None:
        t_done_wall = float(terminal["ts"])
        reward_e = next((e for e in events if e["event"] == "reward"), None)
        if reward_e is not None:
            rec.reward = reward_e.get("reward")
            rec.reward_latency_s = max(0.0, float(reward_e["ts"]) - t_done_wall)
        consume = next((e for e in events if e["event"] == "train_consume"), None)
        if consume is not None:
            rec.staleness = consume.get("staleness")
            rec.consume_latency_s = max(0.0, float(consume["ts"]) - t_done_wall)
    return rec


_ORPHAN_CAP = 32  # keep completeness reports bounded


def analyze(source: EventSource, *, strict_open: bool = False,
            dropped_events: Optional[int] = None) -> TraceReport:
    """Parse a lifecycle event log into per-trajectory records plus a
    completeness verdict.

    ``dropped_events`` overrides drop detection (pass ``EVENTS.dropped``
    when analyzing a live snapshot; JSONL dumps carry a
    ``telemetry_meta`` trailer instead).  ``strict_open`` additionally
    fails completeness on traces still in flight at dump time — use it
    when the producer is known to have drained (tail-truncation check).
    """
    events = iter_events(source)
    comp = Completeness(strict_open=strict_open, n_events=len(events))

    dropped = 0
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    by_key: Dict[int, str] = {}
    submit_seen: set = set()
    pauses: List[Dict[str, Any]] = []
    restarts: List[Dict[str, Any]] = []
    chunk_by_tier: Dict[int, List[float]] = {}
    unmatched_consumes = 0
    for e in events:
        name = e.get("event")
        if name == "telemetry_meta":
            dropped += int(e.get("dropped_events", 0) or 0)
            continue
        if name == "pause":
            pauses.append(e)
            continue
        if name == "run_restart":
            restarts.append(e)
            continue
        if name == "train_consume":
            tid = by_key.get(e.get("trace_key"))
            if tid is None:
                unmatched_consumes += 1
            else:
                by_trace[tid].append(e)
            continue
        tids: List[str] = []
        if e.get("trace_id"):
            tids = [e["trace_id"]]
        elif name in ("decode_chunk", "spec_verify"):
            tids = list(e.get("trace_ids") or [])
            lat = e.get("latency_s")
            if lat is not None:
                chunk_by_tier.setdefault(int(e.get("tier", -1) or -1),
                                         []).append(float(lat))
        elif name not in _GLOBAL_EVENTS:
            comp.errors.append(f"traceless event: {name}")
            continue
        for tid in tids:
            by_trace.setdefault(tid, []).append(e)
            if name == "rollout_submit":
                submit_seen.add(tid)
                if e.get("trace_key") is not None:
                    by_key[e["trace_key"]] = tid
            elif name == "resubmit" and tid not in submit_seen:
                # every failover resubmit must join a trace whose
                # original submit is still in the log, *earlier*
                comp.unjoined_resubmits += 1

    if dropped_events is not None:
        dropped = max(dropped, int(dropped_events))
    comp.dropped_events = dropped
    comp.unmatched_consumes = unmatched_consumes

    records: List[TrajectoryRecord] = []
    for tid, evs in by_trace.items():
        rec = _build_record(tid, evs)
        records.append(rec)
        if not any(ev["event"] in _ROOT_EVENTS for ev in evs):
            if len(comp.orphan_traces) < _ORPHAN_CAP:
                comp.orphan_traces.append(tid)
            else:
                comp.errors.append("orphan list capped")
        elif not rec.closed:
            comp.open_traces += 1
        elif not rec.lost and rec.interrupts:
            # on a closed, delivered trace every interrupt must have
            # been followed by a resume or re-admission before gen_done
            seq = [ev["event"] for ev in evs]
            for i, name in enumerate(seq):
                if name == "interrupt" and not any(
                        s in ("resume", "resubmit", "admission")
                        for s in seq[i + 1:]):
                    comp.incomplete_interrupts += 1
    comp.n_traces = len(records)

    comp.complete = (
        comp.dropped_events == 0
        and not comp.orphan_traces
        and comp.unjoined_resubmits == 0
        and comp.incomplete_interrupts == 0
        and not comp.errors
        and (not strict_open or comp.open_traces == 0)
    )

    wall = [float(e["ts"]) for e in events if "ts" in e]
    span = (max(wall) - min(wall)) if wall else 0.0
    return TraceReport(records=records, completeness=comp, pauses=pauses,
                       chunk_latency_by_tier=chunk_by_tier, wall_span_s=span,
                       restarts=restarts)


@dataclasses.dataclass
class AccountingCheck:
    ok: bool
    tolerance: float
    abs_floor_s: float
    checked: int
    violations: int
    max_rel_err: Optional[float]
    mean_rel_err: Optional[float]


def check_accounting(records: List[TrajectoryRecord], *,
                     tolerance: float = 0.05,
                     abs_floor_s: float = 0.025) -> AccountingCheck:
    """Verify the accounting identity over all closed trajectories that
    carry a client-measured end-to-end: the event-derived stage sum must
    match ``gen_done.latency_s`` within ``tolerance`` (relative) or
    ``abs_floor_s`` (absolute — sub-floor jitter on very fast CPU-rig
    trajectories is measurement noise, not a broken decomposition)."""
    rels: List[float] = []
    violations = 0
    for r in records:
        if r.identity_rel is None or r.identity_err_s is None:
            continue
        rels.append(r.identity_rel)
        if r.identity_rel > tolerance and r.identity_err_s > abs_floor_s:
            violations += 1
    return AccountingCheck(
        ok=violations == 0,
        tolerance=tolerance,
        abs_floor_s=abs_floor_s,
        checked=len(rels),
        violations=violations,
        max_rel_err=max(rels) if rels else None,
        mean_rel_err=sum(rels) / len(rels) if rels else None,
    )
