"""SLO report generation from lifecycle trace analytics (the port's copy
of `areal_tpu/obs/slo.py`, standard library only).

Turns one analyzed event log (:func:`areal_tpu_torch.obs.trace.analyze`) into
the repo's canonical SLO artifact — ``SLO_REPORT_*.json`` plus a
human-readable markdown twin:

- p50/p90/p99 per lifecycle stage (admission wait, prefill, decode,
  interrupt windows, delivery tail), TTFT, inter-token latency, and
  client-measured end-to-end;
- goodput (delivered trajectories/s and output tokens/s over the log's
  wall span);
- staleness-at-consumption and pause-window distributions (the paper's
  bounded-asynchrony evidence);
- the completeness verdict and the accounting-identity check, so a
  report built from a lossy or self-inconsistent log says so up front.

`scripts/check_slo.py` (which imports neither package and reads only
JSON) diffs these reports against a checked-in baseline with per-metric
tolerance bands; `areal_tpu_torch/scripts/bench_replay.py --slo-report`
builds one from a replay run.

CLI::

    python -m areal_tpu_torch.obs.slo events.jsonl --out SLO_REPORT_r01.json \
        --md SLO_REPORT_r01.md --run-id r01 [--require-complete] \
        [--require-identity] [--strict-open]
"""

import argparse
import json
import time
from typing import Any, Dict, List, Optional

from areal_tpu_torch.obs import trace as trace_mod
from areal_tpu_torch.obs.trace import (AccountingCheck, TraceReport,
                                 check_accounting, dist_summary)

SCHEMA = "areal-slo-report/v1"


def build_report(source: trace_mod.EventSource, *, run_id: str = "",
                 source_name: str = "", tolerance: float = 0.05,
                 abs_floor_s: float = 0.025, strict_open: bool = False,
                 dropped_events: Optional[int] = None) -> Dict[str, Any]:
    """Analyze ``source`` and assemble the SLO report dict."""
    rep: TraceReport = trace_mod.analyze(
        source, strict_open=strict_open, dropped_events=dropped_events)
    closed = rep.closed
    acct: AccountingCheck = check_accounting(
        rep.records, tolerance=tolerance, abs_floor_s=abs_floor_s)

    stage_samples: Dict[str, List[float]] = {}
    for r in closed:
        for k, v in r.stages.items():
            stage_samples.setdefault(k, []).append(v)

    out_tokens = sum(r.output_len or 0 for r in closed)
    span = rep.wall_span_s
    goodput = {
        "wall_span_s": span,
        "trajectories": len(closed),
        "output_tokens": out_tokens,
        "trajectories_per_s": (len(closed) / span) if span > 0 else None,
        "output_tokens_per_s": (out_tokens / span) if span > 0 else None,
    }

    pause_by_kind: Dict[str, int] = {}
    for p in rep.pauses:
        pause_by_kind[str(p.get("kind", ""))] = (
            pause_by_kind.get(str(p.get("kind", "")), 0) + 1)

    comp = rep.completeness
    report: Dict[str, Any] = {
        "schema": SCHEMA,
        "run_id": run_id,
        "source": source_name or (source if isinstance(source, str) else ""),
        "generated_unix": time.time(),
        "complete": comp.complete and acct.ok,
        "completeness": {
            "complete": comp.complete,
            "dropped_events": comp.dropped_events,
            "n_events": comp.n_events,
            "n_traces": comp.n_traces,
            "open_traces": comp.open_traces,
            "orphan_traces": comp.orphan_traces,
            "unjoined_resubmits": comp.unjoined_resubmits,
            "incomplete_interrupts": comp.incomplete_interrupts,
            "unmatched_consumes": comp.unmatched_consumes,
            "strict_open": comp.strict_open,
            "errors": comp.errors,
        },
        "accounting": {
            "ok": acct.ok,
            "tolerance": acct.tolerance,
            "abs_floor_s": acct.abs_floor_s,
            "checked": acct.checked,
            "violations": acct.violations,
            "max_rel_err": acct.max_rel_err,
            "mean_rel_err": acct.mean_rel_err,
        },
        "trajectories": {
            "n": len(rep.records),
            "closed": len(closed),
            "lost": sum(1 for r in rep.records if r.lost),
            "open": comp.open_traces,
            "resubmits": sum(r.resubmits for r in rep.records),
            "interrupts": sum(r.interrupts for r in rep.records),
        },
        "e2e_s": dist_summary(r.e2e_s for r in closed
                              if r.e2e_s is not None),
        "ttft_s": dist_summary(r.ttft_s for r in closed
                               if r.ttft_s is not None),
        "inter_token_s": dist_summary(r.inter_token_s for r in closed
                                      if r.inter_token_s is not None),
        "stages": {k: dist_summary(v)
                   for k, v in sorted(stage_samples.items())},
        "goodput": goodput,
        "staleness": dist_summary(r.staleness for r in rep.records
                                  if r.staleness is not None),
        "consume_latency_s": dist_summary(
            r.consume_latency_s for r in rep.records
            if r.consume_latency_s is not None),
        "reward": dist_summary(r.reward for r in rep.records
                               if r.reward is not None),
        "pause": {
            "n": len(rep.pauses),
            "by_kind": pause_by_kind,
            "dur_s": dist_summary(float(p.get("dur_s", 0.0) or 0.0)
                                  for p in rep.pauses),
        },
        "decode_chunks": {
            "per_tier": {
                str(tier): {"n": len(lats), "latency_s": dist_summary(lats)}
                for tier, lats in sorted(rep.chunk_latency_by_tier.items())
            },
        },
        "prefill": _prefill_summary(rep),
        "handoff": _handoff_summary(rep, closed),
    }
    return report


def _prefill_summary(rep: TraceReport) -> Dict[str, Any]:
    kinds: Dict[str, int] = {}
    cold = inherited = 0
    for r in rep.records:
        for k in r.prefill_kinds:
            kinds[k] = kinds.get(k, 0) + 1
        cold += r.cold_tokens
        inherited += r.inherited_tokens
    total = cold + inherited
    return {
        "kinds": kinds,
        "cold_tokens": cold,
        "inherited_tokens": inherited,
        "shared_fraction": (inherited / total) if total else None,
    }


def _handoff_summary(rep: TraceReport, closed) -> Dict[str, Any]:
    """Disaggregated prefill->decode handoff ledger: transfer
    counts/bytes from the `handoff` events plus the per-trajectory
    handoff-stage latency (the same samples the `stages.handoff` band in
    check_slo gates on)."""
    n = sum(r.handoffs for r in rep.records)
    return {
        "n": n,
        "trajectories": sum(1 for r in rep.records if r.handoffs),
        "bytes": sum(r.handoff_bytes for r in rep.records),
        "latency_s": dist_summary(
            r.stages["handoff"] for r in closed if "handoff" in r.stages),
    }


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    return f"{v * 1e3:.1f}ms"


def _dist_row(name: str, d: Optional[Dict[str, float]]) -> str:
    if not d:
        return f"| {name} | - | - | - | - | - |"
    return (f"| {name} | {d['count']} | {_fmt_s(d['p50'])} "
            f"| {_fmt_s(d['p90'])} | {_fmt_s(d['p99'])} "
            f"| {_fmt_s(d['max'])} |")


def render_markdown(report: Dict[str, Any]) -> str:
    """Human twin of the JSON report: headline verdicts + stage table."""
    comp = report["completeness"]
    acct = report["accounting"]
    traj = report["trajectories"]
    good = report["goodput"]
    lines = [
        f"# SLO report {report.get('run_id') or ''}".rstrip(),
        "",
        f"- source: `{report.get('source', '')}`",
        f"- complete: **{report['complete']}** "
        f"(dropped_events={comp['dropped_events']}, "
        f"orphans={len(comp['orphan_traces'])}, "
        f"unjoined_resubmits={comp['unjoined_resubmits']}, "
        f"open={comp['open_traces']})",
        f"- accounting identity: **{'ok' if acct['ok'] else 'VIOLATED'}** "
        f"({acct['checked']} trajectories checked, "
        f"max_rel_err={acct['max_rel_err'] if acct['max_rel_err'] is None else round(acct['max_rel_err'], 4)}, "
        f"tol={acct['tolerance']})",
        f"- trajectories: {traj['closed']} closed / {traj['open']} open / "
        f"{traj['lost']} lost ({traj['resubmits']} resubmits, "
        f"{traj['interrupts']} interrupts)",
        f"- goodput: {_rate(good['trajectories_per_s'])} traj/s, "
        f"{_rate(good['output_tokens_per_s'])} output tok/s "
        f"over {good['wall_span_s']:.1f}s",
        "",
        "| stage | n | p50 | p90 | p99 | max |",
        "|---|---|---|---|---|---|",
        _dist_row("end-to-end", report["e2e_s"]),
        _dist_row("ttft", report["ttft_s"]),
        _dist_row("inter-token", report["inter_token_s"]),
    ]
    for name, d in (report.get("stages") or {}).items():
        lines.append(_dist_row(f"stage:{name}", d))
    for tier, td in (report["decode_chunks"]["per_tier"] or {}).items():
        lines.append(_dist_row(f"decode-chunk tier={tier}", td["latency_s"]))
    st = report.get("staleness")
    if st:
        st_line = ("- staleness at consumption: "
                   f"p50={st['p50']:.1f} p99={st['p99']:.1f} "
                   f"max={st['max']:.0f}")
    else:
        st_line = "- staleness at consumption: n/a"
    pa = report.get("pause", {})
    pause_line = f"- pause windows: n={pa.get('n', 0)}"
    if pa.get("dur_s"):
        pause_line += f" p99={_fmt_s(pa['dur_s']['p99'])}"
    ho = report.get("handoff") or {}
    if ho.get("n"):
        ho_line = (f"- kv handoffs: {ho['n']} over "
                   f"{ho.get('trajectories', 0)} trajectories, "
                   f"{ho.get('bytes', 0)} bytes")
        if ho.get("latency_s"):
            ho_line += f", p99={_fmt_s(ho['latency_s']['p99'])}"
    else:
        ho_line = "- kv handoffs: none"
    lines += ["", st_line, pause_line, ho_line, ""]
    return "\n".join(lines)


def _rate(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.2f}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Build an SLO report from a lifecycle events JSONL")
    ap.add_argument("events", help="events.jsonl from EventLog.dump_jsonl")
    ap.add_argument("--out", default="", help="report JSON path")
    ap.add_argument("--md", default="", help="markdown twin path")
    ap.add_argument("--run-id", default="")
    ap.add_argument("--tolerance", type=float, default=0.05)
    ap.add_argument("--abs-floor-s", type=float, default=0.025)
    ap.add_argument("--strict-open", action="store_true")
    ap.add_argument("--require-complete", action="store_true",
                    help="exit 1 unless completeness passes")
    ap.add_argument("--require-identity", action="store_true",
                    help="exit 1 unless the accounting identity holds")
    args = ap.parse_args(argv)

    report = build_report(
        args.events, run_id=args.run_id, tolerance=args.tolerance,
        abs_floor_s=args.abs_floor_s, strict_open=args.strict_open)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=False)
            f.write("\n")
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_markdown(report))
    print(render_markdown(report))

    rc = 0
    if args.require_complete and not report["completeness"]["complete"]:
        print("FAIL: trace completeness violated")
        rc = 1
    if args.require_identity and not report["accounting"]["ok"]:
        print("FAIL: accounting identity violated")
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
