"""Trace-driven load replay of the port: latency-against-throughput curves
for a fleet of port servers.

    python -m areal_tpu_torch.scripts.bench_replay --servers 2 --router     # on the card
    python -m areal_tpu_torch.scripts.bench_replay --device cpu --model tiny \\
        --servers 1 --router --workload mixed --duration 8 --base-rps 2 \\
        --rates 1,4,16 --n-slots 8 --max-seq-len 256 --max-new-tokens 16 \\
        --telemetry-dir /tmp/replay --slo-report /tmp/replay/SLO_REPORT.json

The counterpart of `scripts/bench_replay.py`, on the standard library (the
card's machine has no aiohttp):

- **workload**: ``--trace events.jsonl`` (a recorded run's
  ``rollout_submit`` arrival clock, prompt lengths and decode budgets,
  `areal_tpu_torch/obs/workload.py`) or ``--workload mixed`` (seeded
  synthetic mix: chat bursts, GRPO groups with shared prompts,
  long-context stragglers);
- **fleet**: N port servers (`gen/server.py`) in this process, each on its
  own thread, behind the port's router (`gen/router.py`) on another, or an
  external fleet through ``--addr host:port`` (client-side numbers only);
- **rates**: each ``--rates`` multiplier compresses the arrival clock (16 =
  the same work arriving 16x faster) and replays the whole workload.

The load client is open-loop: a thread per arrival sleeps to its scheduled time
and sends whether or not earlier requests have returned, so queueing shows
up as latency.  Each rate reports the load client's own send lag (actual send
time against the scheduled one): a slow client is never read as a slow
server.  The load client emits the client-side lifecycle events
(rollout_submit / gen_done / rollout_lost / resubmit) into the same
telemetry ring as the servers' spans, so ``--telemetry-dir`` holds whole
trajectories and ``--slo-report`` turns them into an SLO report
(`areal_tpu_torch/obs/slo.py`) that `scripts/check_slo.py` reads.

``--disagg`` is the A/B at a matched rate: a colocated control (N servers
of role both) against a disaggregated fleet (one prefill server, N - 1
decode servers, the role-aware router), over the same workload with
sampler streams pinned per trace id, so both phases must return equal
streams.  ``--chaos`` kills the prefill server part way through the last
rate; the load client's retries stand for the remote client's failover, and no
trajectory may be lost.

Prints one curve JSON line.
"""

import argparse
import http.client
import json
import os
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from areal_tpu_torch.obs import slo as slo_mod
from areal_tpu_torch.obs import workload as wl
from areal_tpu_torch.obs.trace import dist_summary
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.http import exchange

SCHEMA = "areal-replay-curves/v1"


# ---------------------------------------------------------------------------
# fleet boot (self-hosted mode)
# ---------------------------------------------------------------------------


def _boot_server(cfg, params, args, role: str = "both",
                 host_offload: Optional[bool] = None) -> Tuple[str, Callable[[], None]]:
    """One port server on its own thread: the fleet's servers share one copy
    of the weights and the process's telemetry ring, so the load client's and
    the servers' events make whole trajectories.  Returns (addr, stop);
    stop is a kill: the listener closes, the worker stops, and requests
    still in flight are answered 500, as a dead server's clients see."""
    from areal_tpu_torch.gen import server as gen_server
    from areal_tpu_torch.gen.engine import GenEngine

    engine = GenEngine(
        cfg, params=params, n_slots=args.n_slots, max_seq_len=args.max_seq_len,
        prompt_bucket=64, decode_chunk=8, share_prefix=True, kv_dtype=cfg.dtype,
        host_offload=args.host_offload if host_offload is None else host_offload,
        host_cache_mb=args.host_cache_mb, host_min_tokens=args.host_min_tokens,
        device=next(params.parameters()).device,
    )
    ready = threading.Event()
    holder: Dict[str, Any] = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    thread = threading.Thread(target=gen_server.serve, args=(engine,),
                              kwargs=dict(host="127.0.0.1", on_ready=on_ready, role=role),
                              daemon=True)
    thread.start()
    if not ready.wait(120):
        raise RuntimeError("replay server did not come up")
    httpd = holder["httpd"]
    addr = f"127.0.0.1:{httpd.port}"
    _wait_health(addr)
    stopped = threading.Event()

    def stop():
        if stopped.is_set():
            return
        stopped.set()
        httpd.shutdown()
        thread.join(timeout=60)  # serve() closes the listener and stops the worker
        engine.abort_all(gen_server.STEP_FAILED)

    return addr, stop


def _boot_router(addrs: List[str], disagg: bool = False) -> Tuple[str, Callable[[], None]]:
    """The port's router over the booted servers, on its own thread."""
    from areal_tpu_torch.gen import router as router_mod

    router = router_mod.Router(router_mod.RouterConfig(disagg=disagg), addresses=list(addrs))
    ready = threading.Event()
    holder: Dict[str, Any] = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    thread = threading.Thread(target=router_mod.serve, args=(router,),
                              kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("replay router did not come up")

    def stop():
        holder["httpd"].shutdown()
        thread.join(timeout=60)

    return f"127.0.0.1:{holder['httpd'].port}", stop


def _wait_health(addr: str, timeout: float = 60.0) -> None:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            if exchange(addr, "/health", method="GET", timeout=1)[0] == 200:
                return
        except (OSError, http.client.HTTPException):
            pass
        time.sleep(0.1)
    raise RuntimeError(f"replay backend {addr} did not come up")


# ---------------------------------------------------------------------------
# the load client
# ---------------------------------------------------------------------------


def _drive(addr: str, arrivals: List[wl.Arrival], *, rate: float, vocab: int, seed: int,
           timeout: float, max_seq_len: int, pin_streams: bool = False,
           record: bool = False, retries: int = 0) -> List[Dict[str, Any]]:
    """Replay one rate multiplier open-loop: every arrival is sent at its
    scheduled time (offsets from the run's start), whatever is still in
    flight, and its wall latency measured from its send.

    ``pin_streams`` gives each trace id a deterministic sampler stream (the
    counter-keyed sampler then makes its tokens a function of the request,
    not of which server or topology served it).  ``record`` keeps trace id,
    token and logprob streams on each result for the A/B.  ``retries``
    stands for the remote client's failover: on a failed request resubmit
    up to N times; only exhausted retries count as lost."""
    scaled = wl.scale(arrivals, rate)
    results: List[Optional[Dict[str, Any]]] = [None] * len(scaled)
    t0 = time.perf_counter()

    def one(i: int, a: wl.Arrival) -> None:
        time.sleep(max(0.0, a.t - (time.perf_counter() - t0)))
        sent = time.perf_counter() - t0
        # keep prompt + budget inside the fleet's sequence budget
        budget = max(1, min(a.max_new_tokens, max_seq_len - 4))
        plen = max(1, min(a.prompt_len, max_seq_len - budget - 4))
        ids = wl.prompt_ids(a, vocab=vocab, seed=seed)[:plen]
        trace_id = f"replay-x{rate:g}-{i:05d}"
        payload = {
            "rid": trace_id,
            "trace_id": trace_id,
            "group_id": f"x{rate:g}-{a.group_id}" if a.group_id else "",
            "group_n": a.group_n if a.group_id else 0,
            "input_ids": ids,
            "sampling_params": {"max_new_tokens": budget, "temperature": 1.0},
        }
        if pin_streams:
            payload["stream_id"] = (zlib.crc32(trace_id.encode()) & 0x0FFFFFFF) + 1
        telemetry.emit("rollout_submit", trace_id=trace_id, rid=trace_id,
                       group_id=payload["group_id"], input_len=len(ids), server=addr)
        start = time.perf_counter()
        rec: Dict[str, Any] = {"kind": a.kind, "rate": rate, "send_lag_s": sent - a.t}
        attempts = 0
        while True:
            attempts += 1
            try:
                status, body = exchange(addr, "/generate", payload, timeout=timeout)
                if status != 200:
                    raise RuntimeError(f"HTTP {status}")
                lat = time.perf_counter() - start
                out_len = len(body.get("output_tokens", []))
                telemetry.emit("gen_done", trace_id=trace_id,
                               stop_reason=body.get("stop_reason", "stop"),
                               output_len=out_len, attempts=attempts, latency_s=lat)
                rec.update(ok=True, latency_s=lat, output_len=out_len,
                           stop_reason=body.get("stop_reason", "stop"))
                if record:
                    rec.update(trace_id=trace_id, tokens=list(body.get("output_tokens", [])),
                               logprobs=list(body.get("output_logprobs", []) or []))
                break
            except Exception as e:  # noqa: BLE001 — errors are data here
                if attempts <= retries:
                    telemetry.emit("resubmit", trace_id=trace_id, attempt=attempts)
                    time.sleep(0.2)
                    continue
                lat = time.perf_counter() - start
                telemetry.emit("rollout_lost", trace_id=trace_id)
                rec.update(ok=False, latency_s=lat, output_len=0, error=str(e)[:120])
                break
        results[i] = rec

    threads = [threading.Thread(target=one, args=(i, a), daemon=True)
               for i, a in enumerate(scaled)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [r for r in results if r is not None]


def _warmup(addrs: List[str], *, vocab: int, max_seq_len: int) -> None:
    """One request per prompt length the workload reaches, against every
    server directly (through the router a balancer could leave a replica
    cold), with telemetry still off so no warm-up lands in the SLO log."""
    lens = sorted({8, min(100, max(9, max_seq_len - 12))})
    for a, addr in enumerate(addrs):
        for i, plen in enumerate(lens):
            payload = {
                "rid": f"warmup-{a}-{i}",
                "trace_id": f"warmup-{a}-{i}",
                "input_ids": [3 + (j % max(1, vocab - 4)) for j in range(plen)],
                "sampling_params": {"max_new_tokens": 8, "temperature": 1.0},
            }
            exchange(addr, "/generate", payload, timeout=300)


def _metrics(addr: str) -> Dict[str, Any]:
    try:
        status, m = exchange(addr, "/metrics", method="GET", timeout=5)
    except (OSError, http.client.HTTPException):  # a dead or external backend
        return {}
    return m if status == 200 else {}


def _scrape_prefix_stats(addrs: List[str]) -> Dict[str, int]:
    """The prefix-cache counters summed over the fleet's JSON /metrics."""
    keys = ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_evictions",
            "prefix_cache_host_swaps")
    total = dict.fromkeys(keys, 0)
    for addr in addrs:
        m = _metrics(addr)
        for k in keys:
            total[k] += int(m.get(k, 0))
    return total


def _prefix_cache_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, Any]:
    d = {k: after[k] - before[k] for k in before}
    lookups = d["prefix_cache_hits"] + d["prefix_cache_misses"]
    return {
        "hits": d["prefix_cache_hits"],
        "misses": d["prefix_cache_misses"],
        "evictions": d["prefix_cache_evictions"],
        "host_swaps": d["prefix_cache_host_swaps"],
        "hit_rate": (d["prefix_cache_hits"] / lookups) if lookups else None,
    }


def _rate_summary(rate: float, arrivals: List[wl.Arrival], results: List[Dict[str, Any]],
                  wall_s: float) -> Dict[str, Any]:
    ok = [r for r in results if r["ok"]]
    out_tokens = sum(r["output_len"] for r in ok)
    offered_span = (arrivals[-1].t / rate) if arrivals else 0.0
    return {
        "rate": rate,
        "n": len(results),
        "ok": len(ok),
        "errors": len(results) - len(ok),
        "offered_rps": (len(arrivals) / offered_span) if offered_span > 0 else None,
        "achieved_rps": (len(ok) / wall_s) if wall_s > 0 else None,
        "output_tokens": out_tokens,
        "output_tokens_per_s": (out_tokens / wall_s) if wall_s > 0 else None,
        "wall_s": round(wall_s, 3),
        "latency_s": dist_summary(r["latency_s"] for r in ok),
        "latency_by_kind": {
            kind: dist_summary(r["latency_s"] for r in ok if r["kind"] == kind)
            for kind in sorted({r["kind"] for r in ok})
        },
        # the load client's own lateness: actual send time against the schedule
        "send_lag_s": dist_summary(r["send_lag_s"] for r in results),
    }


def _fleet_k2(addrs: List[str]) -> Dict[str, int]:
    """The fleet's decode steps and verify calls from /metrics."""
    steps = verifies = 0
    for addr in addrs:
        m = _metrics(addr)
        steps += int(m.get("decode_steps", 0))
        verifies += int(m.get("verify_calls", 0))
    return {"decode_steps": steps, "verify_calls": verifies}


# ---------------------------------------------------------------------------
# the disaggregated A/B
# ---------------------------------------------------------------------------


def _warm_through_router(addr: str, *, vocab: int, n: int = 6) -> None:
    """A few requests through the router: in the disaggregated phase only a
    routed request runs the handoff path; both phases run the same pass."""
    for i in range(n):
        plen = 12 + 7 * i
        payload = {
            "rid": f"routewarm-{i}",
            "trace_id": f"routewarm-{i}",
            "input_ids": [3 + (j % max(1, vocab - 4)) for j in range(plen)],
            "sampling_params": {"max_new_tokens": 6, "temperature": 1.0},
        }
        exchange(addr, "/generate", payload, timeout=300)


def _run_ab(args, arrivals: List[wl.Arrival], rates: List[float],
            source: Dict[str, Any]) -> int:
    """Disaggregated against colocated at a matched arrival rate: two
    phases over the SAME workload, seed and server count — N servers of
    role both, then one prefill server and N - 1 decode servers behind the
    role-aware router.  Streams are pinned per trace id, so the phases must
    return equal token streams.  ``--chaos`` kills the prefill server part
    way through the last disaggregated rate; the load client's retries must
    recover every trajectory."""
    from areal_tpu_torch.scripts.bench_serving import device_kind, serving_model_setup

    cfg, params = serving_model_setup(args.model, args.device)
    vocab = cfg.vocab_size
    n_servers = max(3, args.servers)
    phases: Dict[str, Any] = {}
    streams: Dict[str, Dict[str, Dict[str, Any]]] = {}

    for mode in ("colocated", "disagg"):
        stops: List[Callable[[], None]] = []
        chaos_timer: Optional[threading.Timer] = None
        try:
            server_addrs = []
            if mode == "colocated":
                specs = [("both", None)] * n_servers
            else:
                # decode servers take the handoff as host-tier entries
                specs = [("prefill", None)] + [("decode", True)] * (n_servers - 1)
            for role, off in specs:
                a, stop = _boot_server(cfg, params, args, role=role, host_offload=off)
                server_addrs.append(a)
                stops.append(stop)
            addr, rstop = _boot_router(server_addrs, disagg=(mode == "disagg"))
            stops.append(rstop)
            print(f"[{mode}] fleet up: {specs} -> {addr}", file=sys.stderr, flush=True)

            _warmup(server_addrs, vocab=vocab, max_seq_len=args.max_seq_len)
            _warm_through_router(addr, vocab=vocab)

            telemetry.set_enabled(True)
            telemetry.EVENTS.clear()
            curve = []
            phase_streams: Dict[str, Dict[str, Any]] = {}
            for ri, rate in enumerate(rates):
                chaos_here = args.chaos and mode == "disagg" and ri == len(rates) - 1
                retries = 2 if chaos_here else 0
                if chaos_here:
                    span = (arrivals[-1].t / rate) if arrivals else 1.0
                    chaos_timer = threading.Timer(max(0.2, 0.4 * span), stops[0])
                    chaos_timer.start()
                    print(f"[{mode}] chaos: prefill kill armed at "
                          f"{max(0.2, 0.4 * span):.1f}s into x{rate:g}", file=sys.stderr,
                          flush=True)
                t0 = time.perf_counter()
                results = _drive(addr, arrivals, rate=rate, vocab=vocab, seed=args.seed,
                                 timeout=args.timeout, max_seq_len=args.max_seq_len,
                                 pin_streams=True, record=True, retries=retries)
                wall = time.perf_counter() - t0
                for r in results:
                    if r.get("ok") and "trace_id" in r:
                        phase_streams[r["trace_id"]] = {"tokens": r.pop("tokens"),
                                                        "logprobs": r.pop("logprobs")}
                summary = _rate_summary(rate, arrivals, results, wall)
                summary["chaos"] = bool(chaos_here)
                curve.append(summary)
                lat = summary["latency_s"] or {}
                print(f"[{mode}] rate x{rate:g}: ok={summary['ok']}/{summary['n']} "
                      f"p50={lat.get('p50')} p99={lat.get('p99')}", file=sys.stderr,
                      flush=True)
            router_snap = _metrics(addr)

            events_path = ""
            slo_report: Dict[str, Any] = {}
            if args.telemetry_dir:
                events_path = os.path.join(args.telemetry_dir, f"events_{mode}.jsonl")
                telemetry.EVENTS.dump_jsonl(events_path)
                slo_report = slo_mod.build_report(events_path, run_id=f"replay-{mode}",
                                                  source_name=events_path)
            telemetry.set_enabled(False)
            telemetry.EVENTS.clear()
            phases[mode] = {
                "curve": curve,
                "router": {k: router_snap.get(k) for k in
                           ("handoffs", "handoff_fallbacks", "roles", "failovers")},
                "events_jsonl": events_path,
                "slo": {k: slo_report.get(k) for k in
                        ("inter_token_s", "ttft_s", "e2e_s", "handoff", "trajectories",
                         "complete")} if slo_report else {},
            }
            streams[mode] = phase_streams
            if slo_report and mode == "disagg" and args.slo_report:
                _write_report(slo_report, args.slo_report)
        finally:
            if chaos_timer is not None:
                chaos_timer.cancel()
            for stop in reversed(stops):
                try:
                    stop()
                except Exception as e:  # noqa: BLE001 — teardown only
                    print(f"teardown: {str(e)[:120]}", file=sys.stderr)

    # exactness: same trace id => same pinned stream => equal tokens
    # whatever the topology (logprob mismatches are reported, not gated:
    # a suffix prefill and a decode step may differ in the last bit)
    common = sorted(set(streams["colocated"]) & set(streams["disagg"]))
    token_mism = [t for t in common
                  if streams["colocated"][t]["tokens"] != streams["disagg"][t]["tokens"]]
    lp_mism = [t for t in common
               if streams["colocated"][t]["logprobs"] != streams["disagg"][t]["logprobs"]]
    bit_identity = {
        "compared": len(common),
        "token_mismatches": len(token_mism),
        "token_mismatch_ids": token_mism[:8],
        "logprob_mismatches": len(lp_mism),
    }

    def _it_p99(mode: str) -> Optional[float]:
        d = (phases[mode]["slo"] or {}).get("inter_token_s") or {}
        return d.get("p99")

    co_p99, dis_p99 = _it_p99("colocated"), _it_p99("disagg")
    interference = {
        "colocated_inter_token_p99": co_p99,
        "disagg_inter_token_p99": dis_p99,
        "win": co_p99 is not None and dis_p99 is not None and dis_p99 <= co_p99,
    }
    disagg_errors = sum(s["errors"] for s in phases["disagg"]["curve"])
    gates = {
        "bit_identity": len(common) > 0 and not token_mism,
        "handoffs_nonzero": int(phases["disagg"]["router"].get("handoffs") or 0) > 0,
        "zero_lost": disagg_errors == 0,
    }
    out: Dict[str, Any] = {
        "schema": SCHEMA,
        "mode": "disagg_ab",
        "source": source,
        "fleet": {"model": args.model, "servers": n_servers, "n_slots": args.n_slots,
                  "max_seq_len": args.max_seq_len, "chaos": bool(args.chaos),
                  "device_kind": device_kind(args.device)},
        "workload": wl.summarize(arrivals),
        "phases": phases,
        "bit_identity": bit_identity,
        "interference": interference,
        "gates": gates,
    }
    _write_json(out, args.out)
    print(json.dumps(out))
    failed = [k for k, v in gates.items() if not v]
    if failed:
        print(f"FAIL: disagg gates violated: {failed}", file=sys.stderr)
        return 1
    print(f"disagg A/B ok: {bit_identity['compared']} streams equal, handoffs="
          f"{phases['disagg']['router'].get('handoffs')}, inter-token p99 {dis_p99} "
          f"against colocated {co_p99}", file=sys.stderr)
    return 0


def _write_json(obj: Dict[str, Any], path: str) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)
            f.write("\n")


def _write_report(report: Dict[str, Any], path: str) -> None:
    """The SLO report JSON and its markdown twin beside it."""
    _write_json(report, path)
    with open(os.path.splitext(path)[0] + ".md", "w") as f:
        f.write(slo_mod.render_markdown(report))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="tiny", choices=("qwen25_1p5b", "tiny"),
                   help="serving_model_setup model (tiny = CPU smoke)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--servers", type=int, default=1,
                   help="self-hosted server count (ignored with --addr)")
    p.add_argument("--router", action="store_true",
                   help="front the servers with the router (forced on when --servers > 1)")
    p.add_argument("--addr", default="", help="target an existing fleet instead of self-hosting")
    p.add_argument("--trace", default="", help="events.jsonl to replay (arrival clock + shapes)")
    p.add_argument("--workload", default="mixed", choices=["mixed"],
                   help="synthetic workload when no --trace is given")
    p.add_argument("--duration", type=float, default=8.0,
                   help="synthetic workload span at 1x, seconds")
    p.add_argument("--base-rps", type=float, default=2.0,
                   help="synthetic workload request rate at 1x")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rates", default="1,4,16",
                   help="comma-separated arrival-rate multipliers (1-100x)")
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=256)
    p.add_argument("--host-offload", action="store_true",
                   help="self-hosted servers spill evicted prefixes to a host-memory LRU tier")
    p.add_argument("--host-cache-mb", type=int, default=64,
                   help="host tier capacity per server, MiB")
    p.add_argument("--host-min-tokens", type=int, default=32,
                   help="minimum retained length worth spilling to the host")
    p.add_argument("--max-new-tokens", type=int, default=16,
                   help="synthetic workload decode-budget ceiling")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated A/B: colocated control against a 1-prefill + "
                        "N-1-decode fleet over the same workload, gated on equal streams")
    p.add_argument("--chaos", action="store_true",
                   help="with --disagg: kill the prefill server part way through the last "
                        "rate; no trajectory may be lost (the client's retries stand for failover)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warm-up requests before the measurement")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-request client timeout (a timeout counts as an error, a lost "
                        "trajectory)")
    p.add_argument("--out", default="", help="curve JSON path")
    p.add_argument("--telemetry-dir", default="", help="enable telemetry and dump events here")
    p.add_argument("--slo-report", default="",
                   help="also build an SLO report JSON from the run's events (markdown twin "
                        "next to it)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    rates = sorted({float(r) for r in args.rates.split(",") if r})
    if not rates:
        p.error("--rates must name at least one multiplier")
    if any(r <= 0 or r > 100 for r in rates):
        p.error("--rates multipliers must be in (0, 100]")
    if args.slo_report and not args.telemetry_dir:
        p.error("--slo-report requires --telemetry-dir (events feed it)")
    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)

    # workload ---------------------------------------------------------
    if args.trace:
        arrivals = wl.arrivals_from_trace(args.trace, default_budget=args.max_new_tokens)
        if not arrivals:
            p.error(f"--trace {args.trace} has no rollout_submit events")
        source: Dict[str, Any] = {"trace": args.trace}
    else:
        arrivals = wl.synthetic_mixed(
            seed=args.seed, duration_s=args.duration, base_rps=args.base_rps,
            max_prompt_len=max(16, args.max_seq_len // 2),
            max_new_tokens=args.max_new_tokens)
        source = {"synthetic": args.workload, "seed": args.seed,
                  "duration_s": args.duration, "base_rps": args.base_rps}
    print(f"workload: {wl.summarize(arrivals)}", file=sys.stderr, flush=True)

    if args.chaos and not args.disagg:
        p.error("--chaos requires --disagg")
    if args.disagg:
        if args.addr:
            p.error("--disagg self-hosts both fleets; drop --addr")
        return _run_ab(args, arrivals, rates, source)

    # fleet ------------------------------------------------------------
    stops: List[Callable[[], None]] = []
    fleet: Dict[str, Any] = {"external": bool(args.addr)}
    vocab = 512
    if args.addr:
        addr = args.addr
        warm_addrs = [addr]
        _wait_health(addr)
    else:
        from areal_tpu_torch.scripts.bench_serving import device_kind, serving_model_setup

        cfg, params = serving_model_setup(args.model, args.device)
        vocab = cfg.vocab_size
        server_addrs = []
        for _ in range(args.servers):
            a, stop = _boot_server(cfg, params, args)
            server_addrs.append(a)
            stops.append(stop)
        addr = server_addrs[0]
        warm_addrs = server_addrs
        use_router = args.router or args.servers > 1
        if use_router:
            addr, stop = _boot_router(server_addrs)
            stops.append(stop)
        fleet.update(model=args.model, num_layers=cfg.num_layers, servers=args.servers,
                     router=use_router, n_slots=args.n_slots, max_seq_len=args.max_seq_len,
                     device_kind=device_kind(args.device))
        print(f"fleet up: {server_addrs} -> {addr}", file=sys.stderr, flush=True)

    # replay -----------------------------------------------------------
    curve = []
    run_prefix_cache: Optional[Dict[str, Any]] = None
    fleet_k2 = None
    try:
        if not args.no_warmup:
            tw = time.perf_counter()
            _warmup(warm_addrs, vocab=vocab, max_seq_len=args.max_seq_len)
            print(f"warmup done in {time.perf_counter() - tw:.1f}s", file=sys.stderr,
                  flush=True)
        # telemetry goes live only now: a half-recorded warm-up trace would
        # fail the completeness linter
        if args.telemetry_dir:
            telemetry.EVENTS.clear()
            telemetry.set_enabled(True)
        run_cache_before = _scrape_prefix_stats(warm_addrs)
        for rate in rates:
            cache_before = _scrape_prefix_stats(warm_addrs)
            t0 = time.perf_counter()
            results = _drive(addr, arrivals, rate=rate, vocab=vocab, seed=args.seed,
                             timeout=args.timeout, max_seq_len=args.max_seq_len)
            wall = time.perf_counter() - t0
            summary = _rate_summary(rate, arrivals, results, wall)
            summary["prefix_cache"] = _prefix_cache_delta(cache_before,
                                                          _scrape_prefix_stats(warm_addrs))
            curve.append(summary)
            lat = summary["latency_s"] or {}
            lag = summary["send_lag_s"] or {}
            print(f"rate x{rate:g}: ok={summary['ok']}/{summary['n']} p50={lat.get('p50')} "
                  f"p99={lat.get('p99')} tok/s={summary['output_tokens_per_s']} "
                  f"hit_rate={summary['prefix_cache']['hit_rate']} "
                  f"send lag p99={lag.get('p99')}", file=sys.stderr, flush=True)
        run_prefix_cache = _prefix_cache_delta(run_cache_before,
                                               _scrape_prefix_stats(warm_addrs))
        fleet_k2 = _fleet_k2(warm_addrs)
    finally:
        telemetry.set_enabled(False)
        for stop in reversed(stops):
            try:
                stop()
            except Exception as e:  # noqa: BLE001 — teardown only
                print(f"teardown: {str(e)[:120]}", file=sys.stderr)

    out: Dict[str, Any] = {
        "schema": SCHEMA,
        "source": source,
        "fleet": fleet,
        "workload": wl.summarize(arrivals),
        "rates": curve,
        "prefix_cache": run_prefix_cache,
        # the servers' decode steps and verify calls over their lives, the
        # warm-up included (each one ragged-decode kernel call a layer)
        "fleet_k2": fleet_k2,
    }
    if args.telemetry_dir:
        events_path = os.path.join(args.telemetry_dir, "events.jsonl")
        n_events = telemetry.EVENTS.dump_jsonl(events_path)
        out["telemetry"] = {"events_jsonl": events_path, "n_events": n_events,
                            "dropped_events": telemetry.EVENTS.dropped}
        if args.slo_report:
            report = slo_mod.build_report(events_path, run_id="replay",
                                          source_name=events_path)
            # the prefix-cache composition rides the report, so check_slo.py
            # can band the hit rate beside the latency percentiles
            if run_prefix_cache is not None:
                report["prefix_cache"] = run_prefix_cache
            _write_report(report, args.slo_report)
            out["slo_report"] = args.slo_report
            out["slo_complete"] = report["complete"]
    _write_json(out, args.out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
