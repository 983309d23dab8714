"""Process-local telemetry: a metrics registry and the trajectory event log
(the port's copy of `areal_tpu/utils/telemetry.py`, standard library only).

- **Metrics**: `Counter` / `Gauge` / `Histogram` behind named `Registry`
  objects, rendered in the Prometheus text exposition format.  Components
  that keep their own counters (``engine.stats``, `StalenessManager`)
  register a *collector* callback that samples them at scrape time, so
  the hot paths pay nothing.
- **Events**: a bounded in-memory log of timestamped trajectory lifecycle
  events (submit -> admission -> prefill -> decode chunks and verifies ->
  interrupt/resume -> reward -> train consumption), dumped to JSONL and
  exportable as a Chrome trace (Perfetto loads it).
- **Trace ids**: rollouts carry a ``trace_id`` string on the wire
  (ModelRequest -> torch_remote -> GenRequest -> response); batches carry
  its stable int64 ``trace_key`` hash, so trainer-side events join the
  generation-side spans.

Event emission is off by default; call :func:`set_enabled` (or set
``AREAL_TELEMETRY=1``) to turn it on.  Histogram observations at cold
sites (weight-swap pause windows, admission waits) are always live, so
the histograms fill on any scrape; the per-decode-chunk timing is gated
on the flag.  Left out of the copy: the stats-key miss counter of the
reference server's tolerant JSON, and `publish_train_stats`, whose gauges
are named at run time.
"""

import hashlib
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Global enable flag
# ---------------------------------------------------------------------------

_enabled = os.environ.get("AREAL_TELEMETRY", "") not in ("", "0", "false")

# Cached per process: every event record carries the emitting pid so the
# trace analyzer knows when two events share a perf_counter epoch (the
# monotonic clock is only comparable within one process).
_PID = os.getpid()


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def trace_key(trace_id: str) -> int:
    """Stable non-negative int64 hash of a trace id.  Rides inside
    trajectory batches (plain int per row) so `train_batch` events can
    be joined to generation-side events without string plumbing."""
    h = hashlib.blake2b(trace_id.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(v: Any) -> str:
    s = str(v)
    for ch, rep in _LABEL_ESC.items():
        s = s.replace(ch, rep)
    return s


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0, 32.0)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = _sanitize(name)
        self.help = help
        self._lock = threading.Lock()

    def samples(self) -> List[Tuple[str, Dict[str, Any], float]]:
        """[(suffix, labels, value)] — suffix appended to the metric name
        ("" for plain counters/gauges, "_bucket"/"_sum"/"_count" for
        histograms)."""
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    @staticmethod
    def _key(labels: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
        if not labels:
            return ()
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels: Any) -> None:
        """Scrape-time sampling of an externally maintained monotonic
        total (e.g. ``engine.stats`` counters) — the source guarantees
        monotonicity, the registry just mirrors it."""
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def samples(self):
        with self._lock:
            return [("", dict(k), v) for k, v in sorted(self._values.items())]


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # label-key -> [bucket counts..., +Inf count]; plus (sum, count)
        self._counts: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}
        self._sums: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = Counter._key(labels)
        v = float(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0.0] * (len(self.buckets) + 1)
                self._sums[key] = [0.0, 0.0]
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1.0
                    break
            else:
                counts[-1] += 1.0
            s = self._sums[key]
            s[0] += v
            s[1] += 1.0

    def samples(self):
        out = []
        with self._lock:
            for key in sorted(self._counts):
                labels = dict(key)
                cum = 0.0
                for b, c in zip(self.buckets, self._counts[key][:-1]):
                    cum += c
                    out.append(("_bucket", {**labels, "le": _fmt(b)}, cum))
                cum += self._counts[key][-1]
                out.append(("_bucket", {**labels, "le": "+Inf"}, cum))
                out.append(("_sum", labels, self._sums[key][0]))
                out.append(("_count", labels, self._sums[key][1]))
        return out


class Registry:
    """A named collection of metrics plus scrape-time collectors.

    Collectors are zero-arg callables invoked before rendering; they
    sample external state (``engine.stats``, staleness stats) into registered metrics, keeping the owning hot paths free
    of any telemetry bookkeeping.  A collector that raises is skipped
    (and counted) rather than failing the scrape."""

    def __init__(self, namespace: str):
        self.namespace = _sanitize(namespace)
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []
        self.collector_errors = 0

    def _full(self, name: str) -> str:
        name = _sanitize(name)
        if name.startswith("areal_"):
            return name
        return f"areal_{self.namespace}_{name}"

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        full = self._full(name)
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = cls(full, help, **kw)
                self._metrics[full] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {full} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        """Drop a collector `add_collector` took (its owner has stopped)."""
        with self._lock:
            self._collectors.remove(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                self.collector_errors += 1

    def metric_names(self) -> List[str]:
        self.collect()
        with self._lock:
            return sorted(self._metrics)

    def render_prometheus(self) -> str:
        self.collect()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, labels, value in m.samples():
                if labels:
                    lab = ",".join(
                        f'{_sanitize(k)}="{_escape_label(v)}"'
                        for k, v in sorted(labels.items())
                    )
                    lines.append(f"{m.name}{suffix}{{{lab}}} {_fmt(value)}")
                else:
                    lines.append(f"{m.name}{suffix} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able {metric: value | {label_repr: value} | histogram}."""
        self.collect()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: Dict[str, Any] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                for suffix, labels, value in m.samples():
                    name = m.name + suffix
                    lab = {k: v for k, v in labels.items()}
                    key = json.dumps(lab, sort_keys=True) if lab else ""
                    out.setdefault(name, {})[key or "_"] = value
            else:
                samples = list(m.samples())
                if any(labels for _, labels, _ in samples):
                    # a family with any labeled series renders as a dict;
                    # its unlabeled series (legal in Prometheus — e.g. a
                    # fleet-wide rate next to per-tier rates) keys as ""
                    d = out.setdefault(m.name, {})
                    for _, labels, value in samples:
                        key = (json.dumps(labels, sort_keys=True)
                               if labels else "")
                        d[key] = value
                else:
                    for _, _, value in samples:
                        out[m.name] = value
        return out


_registries: Dict[str, Registry] = {}
_registries_lock = threading.Lock()


def registry(name: str) -> Registry:
    with _registries_lock:
        reg = _registries.get(name)
        if reg is None:
            reg = _registries[name] = Registry(name)
        return reg


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal exposition-format parser (for tests / snapshot diffing):
    returns {metric_name: {label_block_or_'': value}}."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$", line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels, raw = m.groups()
        value = float("inf") if raw == "+Inf" else float(raw)
        out.setdefault(name, {})[labels or ""] = value
    return out


# ---------------------------------------------------------------------------
# Canonical evidence metrics, shared across modules
# ---------------------------------------------------------------------------

GEN = registry("gen")
ROUTER = registry("router")
TRAIN = registry("train")

PAUSE_WINDOW = GEN.histogram(
    "pause_window_seconds",
    "Generation pause window at weight load/swap/commit (replaces the "
    "single overwritten last_pause_s)",
)
ADMISSION_WAIT = GEN.histogram(
    "admission_queue_wait_seconds",
    "submit() -> slot admission wait (holdback + group-hold + queue)",
)
DECODE_CHUNK = GEN.histogram(
    "decode_chunk_seconds",
    "Per-tier decode-chunk dispatch+fetch latency (label: tier)",
)
HANDOFF = GEN.histogram(
    "kv_handoff_seconds",
    "Prefill->decode KV handoff latency (label: op=export|import): the "
    "worker-thread service time of one page-set transfer leg",
)
STALENESS_AT_CONSUMPTION = TRAIN.histogram(
    "staleness_at_consumption",
    "consumed_version - behavior_version per trajectory row at train_batch",
    buckets=STALENESS_BUCKETS,
)
# Fault-tolerance evidence.  Registered at module import so the
# pinned metric appears on the train /metrics surface (TYPE line) even
# before the first backend ever fails; the client-side failover loop in
# core/remote.py increments it.  The name is already fully qualified, so
# the registry serves it verbatim rather than namespacing it.
CLIENT_RESUBMISSIONS = TRAIN.counter(
    "areal_client_resubmissions_total",
    "Trajectories resubmitted to another server after a backend failure",
)

# A resubmit whose replacement server reported nonzero cache_hit_tokens:
# the retried trajectory warm-started through the radix/paged prefix cache
# instead of cold-prefilling its accumulated tokens.
CLIENT_RESUBMIT_CACHE_HITS = TRAIN.counter(
    "areal_client_resubmit_cache_hits_total",
    "Failover resubmits that warm-started via a prefix-cache hit",
)

# Incremented once per successful RecoverHandler.load — a relaunched run
# resuming from a recover generation (utils/recover.py).  Registered at
# import for the same early-visibility reason as above.
TRAIN_RECOVER = TRAIN.counter(
    "areal_train_recover_total",
    "Trainer restarts that resumed from a recover checkpoint generation",
)

# Control-plane fanouts (update_weights / set_version / pause / continue)
# that missed at least one server.  Eager registration so the pinned name
# serves a TYPE line before the first partial failure; core/remote.py's
# fanout path increments it by the number of servers missed.
PUBLISH_PARTIAL_FAILURES = TRAIN.counter(
    "publish_partial_failures_total",
    "Servers missed by client control-plane fanouts",
)

# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------


class EventLog:
    """Bounded in-memory trajectory event log.

    `emit` is a no-op unless telemetry is enabled; when the ring is
    full the oldest events fall off (counted in `dropped`).  Dumping
    (JSONL / Chrome trace) snapshots under the lock and writes outside
    it — call the dump methods from sync contexts only (benches,
    tests, executor threads), never on an event loop."""

    def __init__(self, capacity: int = 65536):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0

    def emit(self, event: str, trace_id: Optional[str] = None,
             **fields: Any) -> None:
        if not _enabled:
            return
        # Paired clocks: wall `ts` joins events across processes, mono
        # `mono` (perf_counter) gives skew-free stage durations within
        # one process.  The analyzer prefers mono when pids match.
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "mono": time.perf_counter(),
            "pid": _PID,
            "event": event,
        }
        if trace_id:
            rec["trace_id"] = trace_id
            rec.setdefault("trace_key", trace_key(trace_id))
        rec.update(fields)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump_jsonl(self, path: str) -> int:
        events = self.snapshot()
        with self._lock:
            dropped = self.dropped
        if dropped:
            # Ring overflow is silent data loss to downstream analysis;
            # stamp it into the dump so the trace analyzer can refuse to
            # call a lossy log "complete" (see areal_tpu/obs/trace.py).
            events = events + [{
                "ts": time.time(),
                "mono": time.perf_counter(),
                "pid": _PID,
                "event": "telemetry_meta",
                "dropped_events": dropped,
                "capacity": self._events.maxlen,
            }]
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def to_chrome_trace(
        self, events: Optional[Iterable[Dict[str, Any]]] = None
    ) -> Dict[str, Any]:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing).
        Events with a `latency_s`/`dur_s` field become complete ("X")
        slices; everything else becomes an instant event.  Each trace id
        gets its own track (tid = trace_key)."""
        evs = list(events) if events is not None else self.snapshot()
        trace_events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "areal"}},
        ]
        if not evs:
            return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
        t0 = min(e["ts"] for e in evs)
        for e in evs:
            ts_us = (e["ts"] - t0) * 1e6
            tid = int(e.get("trace_key") or 0) % (2**31)
            args = {k: v for k, v in e.items() if k not in ("ts", "event")}
            dur = e.get("latency_s") or e.get("dur_s")
            if dur:
                trace_events.append({
                    "name": e["event"], "ph": "X", "cat": "areal",
                    "pid": 1, "tid": tid,
                    "ts": max(0.0, ts_us - float(dur) * 1e6),
                    "dur": float(dur) * 1e6, "args": args,
                })
            else:
                trace_events.append({
                    "name": e["event"], "ph": "i", "s": "t", "cat": "areal",
                    "pid": 1, "tid": tid, "ts": ts_us, "args": args,
                })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> int:
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"]) - 1  # minus metadata record


EVENTS = EventLog(
    capacity=int(os.environ.get("AREAL_TELEMETRY_EVENTS", "65536"))
)


def emit(event: str, trace_id: Optional[str] = None, **fields: Any) -> None:
    EVENTS.emit(event, trace_id=trace_id, **fields)


def _register_events_dropped(reg: Registry) -> None:
    c = reg.counter(
        "areal_telemetry_events_dropped_total",
        "Lifecycle events lost to EventLog ring overflow; any nonzero "
        "value marks downstream trace analysis incomplete",
    )
    reg.add_collector(lambda: c.set_total(float(EVENTS.dropped)))


# All three surfaces (the gen server, the router and the trainer endpoint)
# render these registries, so ring overflow is visible wherever /metrics is; the name
# is fully qualified and therefore served verbatim on each.
for _reg in (GEN, ROUTER, TRAIN):
    _register_events_dropped(_reg)
del _reg


# ---------------------------------------------------------------------------
# Trainer-side helpers
# ---------------------------------------------------------------------------


def register_staleness(reg: Registry, manager: Any) -> None:
    """Scrape-time collector exporting StalenessManager's RolloutStat
    (submitted / running / accepted) as gauges."""
    sub = reg.gauge("rollout_submitted", "Rollouts submitted (RolloutStat)")
    run = reg.gauge("rollout_running", "Rollouts in flight (RolloutStat)")
    acc = reg.gauge("rollout_accepted", "Rollouts accepted (RolloutStat)")
    rej = reg.gauge("rollout_rejected", "Rollouts rejected (RolloutStat)")

    def _collect():
        st = manager.get_stats()
        sub.set(st.submitted)
        run.set(st.running)
        acc.set(st.accepted)
        rej.set(getattr(st, "rejected", 0))

    reg.add_collector(_collect)


# ---------------------------------------------------------------------------
# Standalone metrics endpoint (trainer side)
# ---------------------------------------------------------------------------


def start_metrics_server(reg: Registry, host: str = "127.0.0.1",
                         port: int = 0):
    """Serve `reg` at ``/metrics`` (Prometheus text; ``?format=json``
    for the snapshot dict) on a daemon thread.  Returns
    ``(server, port)``; call ``server.shutdown()`` to stop.  This is
    the trainer's lightweight metrics surface; the gen server serves
    its registry on its own HTTP server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.split("?")[0] not in ("/metrics", "/health"):
                self.send_error(404)
                return
            if self.path.startswith("/health"):
                body = b'{"status": "ok"}'
                ctype = "application/json"
            elif "format=json" in self.path:
                body = json.dumps(reg.snapshot()).encode()
                ctype = "application/json"
            else:
                body = reg.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr lines
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="areal-metrics")
    t.start()
    return srv, srv.server_address[1]


def wants_prometheus(query_format: Optional[str], accept: str) -> bool:
    """Content negotiation for the gen server's /metrics endpoint: explicit ``?format=prometheus`` wins; otherwise honor an
    Accept header asking for text/plain or openmetrics.  Default stays
    the legacy JSON dict."""
    if query_format:
        return query_format in ("prometheus", "text")
    accept = accept or ""
    return "text/plain" in accept or "openmetrics" in accept
