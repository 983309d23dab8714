"""HTTP generation server on the standard library (the port of
`areal_tpu/gen/server.py`).

Same paths and JSON keys as the JAX server:

    POST /generate             {rid, input_ids, sampling_params, ...} ->
                               {output_tokens, output_logprobs,
                                output_versions, stop_reason, version, ...}
    POST /generate_batch       {"requests": [...]} -> {"results": [...]}
    POST /pause_generation     the decode loop parks
    POST /continue_generation
    POST /update_weights_from_disk {path, version?} -> {ok, version}: abort
                               in-flight requests, reload the trainer's
                               snapshot (`GenEngine.load_weights`)
    POST /update_weights_chunk the transfer publish: octet-stream pieces
                               (X-Weight-Name/Dtype/Shape/Nbytes/Offset
                               headers) or JSON {name, dtype, shape, nbytes,
                               offset, data_b64}; then {prepare, version}
                               stages them on the engine's device while
                               decoding goes on (`GenEngine.stage_params`,
                               a second copy of the weights) and answers
                               {"staged": true}, or {"staged": false} with
                               the host copy kept when the standby does not
                               fit; {commit, version, live} swaps it in
                               (`commit_staged`: a pointer swap, live or
                               after aborting in-flight requests; unstaged,
                               the placement runs inside the pause)
    POST /kv_export            {input_ids} -> the resident K/V prefix
                               covering them in the wire format
                               (`gen.kv_pool.wire_encode_entry`); 404 when
                               none is resident
    POST /kv_import            a wire entry -> installed in the host tier
                               ({ok, valid_len}); 409 without one, 400 for
                               an entry this cache cannot take (another
                               depth, kv width or dtype, a block past
                               --max-seq-len)
    GET  /health
    GET  /metrics              JSON counters (below); the Prometheus text
                               exposition with ?format=prometheus or an
                               Accept header asking for text/plain

A request that a failed decode step finished is answered with HTTP 500,
so the remote client counts a failover instead of resubmitting without
end; a request aborted by a weight update is answered 200 with
"abort", and the client resumes it.

`/metrics` keys: `decode_steps` (forward_decode steps of the slot grid,
one per token position; the reference's server counted decode chunks,
which the port reports as `decode_calls`), `decode_calls`,
`tokens_generated`, `active`, `role`, `version`, `last_pause_s` (the decode
loop's idle window in the last weight swap), `staged` (a standby waits for
its commit), the prefill accounting
(`prefill_tokens` cold, `suffix_tokens`, `reused_tokens` from retained
prefixes, `shared_tokens` from a group's fanned-out prefix, `copy_calls`)
and `reservations_lapsed` (abort reservations whose owner did not
resubmit in time), the tiers (`tier_occupancy`, `tier_slots`,
`tier_lens`, `tier_migrations`), the prefix cache (`prefix_cache_hits`,
`_misses`, `_evictions`, `_host_swaps`, `_partial_hits`, `_hit_rate`),
the handoff ledger (`kv_handoff_exports`, `_imports`, `_bytes`,
`_failures`), `ragged_dispatches`,
`ragged_attended_pages`, `ragged_kernel_launches` (launches of the ragged
decode kernel in this process, 0 on the CPU) and `ragged_verify_launches`
(those at T > 1, a verify's), speculative decoding's
`spec_drafted`, `spec_accepted`, `spec_acceptance_rate` (over the
server's life) and `verify_calls`, and, on the card,
`max_memory_allocated` in bytes.

The Prometheus surface renders the process's `gen` registry
(`utils/telemetry.py`): a scrape-time collector mirrors the engine's
counters, each under its own name pinned in
`tests/data/metrics_schema.json` (`areal_gen_<stat>_total`), plus the
gauges (active requests, weight version, the last pause, the staged
standby, the prefix-cache hit rate, each tier's occupancy and acceptance
rate as `{tier="t"}`, the acceptance rate over the server's life, the mean
pages a ragged dispatch read) and the histograms the engine and the
worker observe (pause window, admission wait, decode chunk, handoff).

`--role` (prefill, decode or both) is what the server advertises to a
disaggregating router (`/health`, `/metrics`); the engine serves every
route whatever the role, so the router can always fall back to a
colocated request.  A decode server gets its work as `/kv_import` entries
and so always runs the host tier.

A request's `group_id`/`group_n` reach the engine, which holds and
clusters a GRPO group to prefill its prompt once; each answer carries its
`cache_hit_tokens`, the prompt tokens that came from resident K/V.  The
server runs the engine's defaults: prefix reuse and sharing on.

The server logs, at INFO and on arrival, every generate request and every
JSON weight action (a disk reload, a transfer's prepare and commit) with
its wall-clock time and version: ``arrival <path> at <time.time()>
<JSON>``.  The servers of a launched run outlive its trainer, and these
lines show what a relaunched trainer asked of them first (its recover
load's reload, pinned to the recovered version, before any generate).

`http.server.ThreadingHTTPServer` handles each connection on its own
thread; a dedicated worker thread owns the engine and the device's decode
loop (every admission, decode step and weight swap runs there), and
handler threads wait on the request's completion.  `/kv_export` and
`/kv_import` touch the device cache, so they run on the worker too, from
a mailbox it drains between steps (even while paused), and answer 503
when it does not serve them within 30 s.

    python -m areal_tpu_torch.gen.server --model-path <hf dir> --port 8000
    python -m areal_tpu_torch.gen.server --model-path <hf dir> --spec-decode
    python -m areal_tpu_torch.gen.server --model-path <hf dir> --role decode \
        --decode-tiers 2 --host-cache-mb 1024
"""

import argparse
import base64
import concurrent.futures
import json
import logging
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import torch

from areal_tpu_torch.device import torch_dtype
from areal_tpu_torch.gen import kv_pool
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import TransformerConfig, tiny_config
from areal_tpu_torch.ops.ragged_decode import ragged_paged_attention
from areal_tpu_torch.utils import name_resolve, names, network, telemetry
from areal_tpu_torch.utils.shutdown import exit_with_parent

logger = logging.getLogger("areal_tpu_torch.gen.server")

# the stop reason of requests a failed decode step finished: answered 500
STEP_FAILED = "error"
ROLES = ("prefill", "decode", "both")
# how long /kv_export and /kv_import wait for the worker before a 503
HANDOFF_TIMEOUT_S = 30.0


class GenServer:
    """The engine's worker thread plus the request/response translation."""

    def __init__(self, engine: GenEngine, role: str = "both"):
        if role not in ROLES:
            raise ValueError(f"unknown server role: {role!r}")
        self.engine = engine
        self.role = role
        self.paused = threading.Event()  # set => the decode loop parks
        self.shutdown = threading.Event()
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.last_error: float = 0.0
        self.tokens_out = 0  # tokens delivered by decode steps
        self.last_pause_s = 0.0
        # a weight swap handed from a handler thread to the worker
        self._cmd_lock = threading.Lock()
        self._pending_weight_update: Optional[dict] = None
        self._last_committed_version: Optional[int] = None
        # /kv_export and /kv_import handed to the worker
        self._pending_handoffs: List[dict] = []  # guarded-by: _cmd_lock
        # the transfer publish: pieces by name; a prepare whose standby did
        # not fit keeps the assembled host tensors for the commit
        self._chunk_lock = threading.Lock()
        self._chunk_buf: Dict[str, dict] = {}  # guarded-by: _chunk_lock
        self._unstaged: Optional[Tuple[dict, Optional[int]]] = None  # guarded-by: _chunk_lock
        self._register_telemetry()

    def _register_telemetry(self) -> None:
        """A scrape-time collector mirroring this server's counters into
        the process's `gen` registry; the decode loop never touches it.
        It holds a weak reference and goes quiet once the server stops;
        `stop` removes it, so a process that runs servers one after another
        (tests, the smoke script) reports the live one."""
        reg = telemetry.GEN
        self_ref = weakref.ref(self)
        # engine stats and their pinned counter names, one literal each
        counters = (
            ("prefill_calls", reg.counter("prefill_calls_total", "Fresh prefill calls")),
            ("prefill_tokens", reg.counter("prefill_tokens_total",
                                           "Prompt tokens through fresh prefill")),
            ("suffix_calls", reg.counter("suffix_calls_total", "Suffix prefill calls")),
            ("suffix_tokens", reg.counter("suffix_tokens_total",
                                          "Tokens through suffix prefill")),
            ("reused_tokens", reg.counter("reused_tokens_total",
                                          "Retained-prefix tokens not recomputed")),
            ("shared_tokens", reg.counter("shared_tokens_total",
                                          "Fanned-out prefix tokens not recomputed")),
            ("copy_calls", reg.counter("copy_calls_total", "Suffix calls with a fan-out copy")),
            ("decode_calls", reg.counter("decode_calls_total", "Plain decode dispatches")),
            ("decode_steps", reg.counter("decode_steps_total",
                                         "forward_decode steps of the slot grid")),
            ("reservations_lapsed", reg.counter("reservations_lapsed_total",
                                                "Abort reservations that lapsed unclaimed")),
            ("prefix_cache_hits", reg.counter("prefix_cache_hits_total",
                                              "Admissions that inherited a resident prefix")),
            ("prefix_cache_misses", reg.counter("prefix_cache_misses_total",
                                                "Admissions that prefilled cold")),
            ("prefix_cache_evictions", reg.counter("prefix_cache_evictions_total",
                                                   "Retained prefixes overwritten unused")),
            ("prefix_cache_partial_hits", reg.counter(
                "prefix_cache_partial_hits_total", "Hits on a page-rounded donor prefix")),
            ("ragged_dispatches", reg.counter("ragged_dispatches_total",
                                              "Decode and verify dispatches")),
            ("ragged_attended_pages", reg.counter("ragged_attended_pages_total",
                                                  "KV pages the ragged kernel read")),
            ("spec_drafted", reg.counter("spec_drafted_total", "Draft tokens proposed")),
            ("spec_accepted", reg.counter("spec_accepted_total", "Draft tokens accepted")),
            ("verify_calls", reg.counter("verify_calls_total", "Speculative verify dispatches")),
            ("tier_migrations", reg.counter("tier_migrations_total",
                                            "Slots moved to a roomier length-cohort tier")),
            ("prefix_cache_host_swaps", reg.counter(
                "prefix_cache_host_swaps_total", "Prefix spills to the host tier and swap-ins")),
            ("kv_handoff_exports", reg.counter("kv_handoff_exports_total",
                                               "K/V prefixes exported for a handoff")),
            ("kv_handoff_imports", reg.counter("kv_handoff_imports_total",
                                               "K/V prefixes imported into the host tier")),
            ("kv_handoff_bytes", reg.counter("kv_handoff_bytes_total",
                                             "K/V bytes exported and imported")),
            ("kv_handoff_failures", reg.counter(
                "kv_handoff_failures_total", "Exports with nothing resident, refused imports")),
        )
        tokens = reg.counter("tokens_generated_total", "Decode tokens delivered")
        active = reg.gauge("active_requests", "Requests in slots, admitting or queued")
        version = reg.gauge("weight_version", "Live weight version")
        pause = reg.gauge("last_pause_seconds",
                          "Most recent weight-swap pause window (histogram: "
                          "areal_gen_pause_window_seconds)")
        staged = reg.gauge("staged_standby", "Standby weights staged on the device (0/1)")
        occupancy = reg.gauge("tier_occupancy", "Occupied slots per decode tier")
        hit_rate = reg.gauge("prefix_cache_hit_rate",
                             "Admissions served from a resident prefix")
        rate = reg.gauge("spec_acceptance_rate",
                         "Draft tokens accepted / drafted (per-tier series: the "
                         "controller's acceptance window)")
        pages = reg.gauge("ragged_attended_pages",
                          "Mean KV pages read per ragged kernel dispatch")

        def _collect():
            srv = self_ref()
            if srv is None or srv.shutdown.is_set():
                return
            eng = srv.engine
            st = eng.stats
            for key, counter in counters:
                counter.set_total(float(st[key]))
            tokens.set_total(float(srv.tokens_out))
            active.set(eng.active_count())
            version.set(eng.version)
            pause.set(srv.last_pause_s)
            staged.set(1.0 if eng.has_standby else 0.0)
            for t, occ in enumerate(eng.tier_occupancy()):
                occupancy.set(occ, tier=str(t))
            hit_rate.set(eng.prefix_cache_hit_rate())
            drafted = float(st["spec_drafted"])
            rate.set(st["spec_accepted"] / drafted if drafted else 0.0)
            for t, r in enumerate(eng.spec_acceptance_rates()):
                rate.set(r, tier=str(t))
            disp = float(st["ragged_dispatches"])
            pages.set(st["ragged_attended_pages"] / disp if disp else 0.0)

        reg.add_collector(_collect)
        self._collector = _collect

    def start(self) -> None:
        self.worker.start()

    def stop(self, timeout: float = 30.0) -> None:
        collector, self._collector = self._collector, None
        if collector is not None:
            telemetry.GEN.remove_collector(collector)
        self.shutdown.set()
        self.worker.join(timeout)

    def _queue(self, fn: Callable[[], int]) -> "concurrent.futures.Future[int]":
        """Hand a weight swap `fn() -> version` to the worker.  One still
        waiting is superseded (its future fails): only the newest runs."""
        fut: "concurrent.futures.Future[int]" = concurrent.futures.Future()
        with self._cmd_lock:
            old = self._pending_weight_update
            self._pending_weight_update = {"future": fut, "fn": fn}
        if old is not None:
            old["future"].set_exception(RuntimeError("superseded by a newer weight update"))
        return fut

    def queue_weight_update(self, path: str, version: Optional[int] = None
                            ) -> "concurrent.futures.Future[int]":
        """Hand a reload of `path` to the worker; the future resolves to the
        engine's new version."""
        return self._queue(lambda: self.engine.load_weights(path=path, version=version))

    def _apply_weight_update(self) -> bool:
        with self._cmd_lock:
            upd, self._pending_weight_update = self._pending_weight_update, None
        if upd is None:
            return False
        t0 = time.perf_counter()
        try:
            upd["future"].set_result(upd["fn"]())
        except Exception as e:  # noqa: BLE001 — surfaced to the waiting handler
            upd["future"].set_exception(e)
        self.last_pause_s = time.perf_counter() - t0
        return True

    def _run(self) -> None:
        while not self.shutdown.is_set():
            if self._apply_weight_update():
                continue
            self._service_handoffs()
            if self.paused.is_set():
                time.sleep(0.005)
                continue
            try:
                stepped = self.engine.step()
            except Exception:  # noqa: BLE001 — the loop must outlive a failed step
                logger.exception("decode step failed; failing in-flight requests")
                self.last_error = time.time()
                self.engine.abort_all(STEP_FAILED)
                continue
            self.tokens_out += stepped
            if not stepped:
                time.sleep(0.002)

    # --------------------------- the KV handoff -----------------------

    def _service_handoffs(self) -> None:
        """Run the queued exports and imports on the worker, where every
        other touch of the device cache runs, between decode steps."""
        with self._cmd_lock:
            ops, self._pending_handoffs = self._pending_handoffs, []
        for op in ops:
            t0 = time.perf_counter()
            try:
                if op["kind"] == "export":
                    result = self.engine.export_request_kv(op["input_ids"])
                else:
                    result = self.engine.import_request_kv(op["entry"])
            except Exception as e:  # noqa: BLE001 — surfaced to the waiting handler
                op["future"].set_exception(e)
                continue
            telemetry.HANDOFF.observe(time.perf_counter() - t0, op=op["kind"])
            op["future"].set_result(result)

    def _handoff(self, **op):
        """Queue one export or import for the worker and wait for it;
        raises concurrent.futures.TimeoutError after HANDOFF_TIMEOUT_S."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cmd_lock:
            self._pending_handoffs.append(dict(op, future=fut))
        return fut.result(timeout=HANDOFF_TIMEOUT_S)

    def kv_export(self, body: dict) -> Tuple[int, dict]:
        """The resident prefix covering `input_ids`, in the wire format."""
        try:
            entry = self._handoff(kind="export", input_ids=[int(t) for t in body["input_ids"]])
        except concurrent.futures.TimeoutError:
            return 503, {"error": "kv_export timed out"}
        if entry is None:
            return 404, {"error": "no exportable prefix"}
        return 200, kv_pool.wire_encode_entry(entry)

    def kv_import(self, body: dict) -> Tuple[int, dict]:
        """Install a wire entry in the host tier; the next admission that
        matches its tokens swaps it in."""
        try:
            entry = kv_pool.wire_decode_entry(body)
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": f"malformed wire entry: {e!r}"}
        try:
            ok = self._handoff(kind="import", entry=entry)
        except concurrent.futures.TimeoutError:
            return 503, {"error": "kv_import timed out"}
        except ValueError as e:  # an entry this engine's cache cannot take
            return 400, {"error": str(e)}
        if not ok:
            return 409, {"error": "no host tier on this server (start with --host-offload)"}
        return 200, {"ok": True, "valid_len": int(entry["valid_len"])}

    # ------------------------- the transfer publish ---------------------

    def receive_chunk(self, name: str, data, nbytes: int, dtype: str, shape: List[int],
                      offset: int) -> None:
        """Copy one piece of tensor `name` into its staging buffer."""
        with self._chunk_lock:
            entry = self._chunk_buf.setdefault(
                name, {"buf": bytearray(nbytes), "dtype": dtype, "shape": list(shape)})
            entry["buf"][offset:offset + len(data)] = data

    def _assemble_locked(self) -> dict:  # holds: _chunk_lock
        """Drain the chunk buffer into HF-named host tensors (views over the
        received bytes)."""
        buf, self._chunk_buf = self._chunk_buf, {}
        return {name: torch.frombuffer(e["buf"], dtype=torch_dtype(e["dtype"])
                                       ).reshape(e["shape"])
                for name, e in buf.items()}

    def prepare(self, version: Optional[int]) -> Tuple[int, dict]:
        """Stage the received pieces as standby weights on the device;
        decoding goes on.  Without room for the standby the assembled host
        tensors wait for the commit, which then places them in its pause."""
        with self._chunk_lock:
            if not self._chunk_buf:
                return 409, {"error": "prepare without staged chunks"}
            host = self._assemble_locked()
            staged = self.engine.stage_params(host, version)
            self._unstaged = None if staged else (host, version)
        return 200, {"ok": True, "staged": staged}

    def _place_and_swap(self, host: dict, version: Optional[int], live: bool):
        """The unstaged commit, for the worker: place the weights (inside
        the pause, O(model bytes)), then swap live or after the abort."""
        def fn() -> int:
            model = self.engine.place_params(host)
            if live:
                return self.engine.swap_weights_live(model, version=version)
            return self.engine.load_weights(model=model, version=version)
        return fn

    def commit(self, version: Optional[int], live: bool) -> Tuple[int, dict]:
        """Swap in the staged standby (a pointer swap), or place and swap
        the unstaged host copy or the received pieces: live, or after
        aborting in-flight requests.  A commit of another version than the
        one staged is refused (409) and the standby kept; a commit retried
        after its response was lost answers 200 when that version is
        already live."""
        eng = self.engine
        with self._chunk_lock:
            staged_v = eng.staged_version
            if eng.has_standby:
                if version not in (None, staged_v):
                    return 409, {"error": f"staged version {staged_v}, commit of {version}"}
                fn = lambda: eng.commit_staged(live=live)  # noqa: E731
            elif self._unstaged is not None:
                host, v = self._unstaged
                if version not in (None, v):
                    return 409, {"error": f"staged version {v}, commit of {version}"}
                self._unstaged = None
                fn = self._place_and_swap(host, v, live)
            elif self._chunk_buf:
                fn = self._place_and_swap(self._assemble_locked(), version, live)
            elif version is None or version == self._last_committed_version:
                return 200, {"ok": True, "version": eng.version}
            else:
                return 409, {"error": "commit without staged chunks"}
        new_version = self._queue(fn).result()
        self._last_committed_version = new_version
        return 200, {"ok": True, "version": new_version}

    def metrics(self) -> dict:
        eng = self.engine
        stats = eng.stats
        out = {
            "decode_steps": stats["decode_steps"],
            "decode_calls": stats["decode_calls"],
            "tokens_generated": self.tokens_out,
            "active": eng.active_count(),
            "role": self.role,
            "version": eng.version,
            "last_pause_s": self.last_pause_s,
            "staged": eng.has_standby,
            "prefill_tokens": stats["prefill_tokens"],
            "suffix_tokens": stats["suffix_tokens"],
            "reused_tokens": stats["reused_tokens"],
            "shared_tokens": stats["shared_tokens"],
            "copy_calls": stats["copy_calls"],
            "reservations_lapsed": stats["reservations_lapsed"],
            # the router's decode placement reads the occupancy
            "tier_occupancy": eng.tier_occupancy(),
            "tier_slots": list(eng.tier_size),
            "tier_lens": list(eng.tier_bounds),
            **{k: stats[k] for k in (
                "tier_migrations", "prefix_cache_hits", "prefix_cache_misses",
                "prefix_cache_evictions", "prefix_cache_host_swaps",
                "prefix_cache_partial_hits", "kv_handoff_exports", "kv_handoff_imports",
                "kv_handoff_bytes", "kv_handoff_failures")},
            "prefix_cache_hit_rate": round(eng.prefix_cache_hit_rate(), 4),
            "ragged_dispatches": stats["ragged_dispatches"],
            "ragged_attended_pages": stats["ragged_attended_pages"],
            "ragged_kernel_launches": ragged_paged_attention.launches,
            "ragged_verify_launches": ragged_paged_attention.launches_verify,
            "spec_drafted": stats["spec_drafted"],
            "spec_accepted": stats["spec_accepted"],
            "spec_acceptance_rate": round(
                stats["spec_accepted"] / max(1, stats["spec_drafted"]), 4),
            "verify_calls": stats["verify_calls"],
        }
        if eng.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(eng.device)
        return out

    @staticmethod
    def _req_from_body(body: dict, on_done) -> GenRequest:
        """Wire body -> GenRequest (shared by /generate and /generate_batch)."""
        sp = body.get("sampling_params", {})
        return GenRequest(
            rid=body.get("rid", ""),
            trace_id=str(body.get("trace_id", "") or ""),
            group_id=str(body.get("group_id", "") or ""),
            group_n=int(body.get("group_n", 0) or 0),
            input_ids=[int(t) for t in body["input_ids"]],
            max_new_tokens=int(sp.get("max_new_tokens", 256)),
            min_new_tokens=int(sp.get("min_new_tokens", 0)),
            temperature=float(sp.get("temperature", 1.0)),
            top_p=float(sp.get("top_p", 1.0)),
            top_k=int(sp.get("top_k", 0)),
            stop_token_ids=[int(t) for t in sp.get("stop_token_ids", [])],
            stream_id=int(body.get("stream_id", 0) or 0),
            on_done=on_done,
        )

    @staticmethod
    def _result_payload(r: GenRequest, version: int) -> dict:
        return {
            "output_tokens": r.output_tokens,
            "output_logprobs": r.output_logprobs,
            "output_versions": r.output_versions,
            "stop_reason": r.stop_reason or "stop",
            "version": version,
            "trace_id": r.trace_id,
            # prompt tokens served from resident K/V (a retained prefix or
            # a sibling's shared one): a resubmit can see its warm start
            "cache_hit_tokens": r.cache_hit_tokens,
            "stream_id": r.stream_id,
        }

    def generate_many(self, bodies: List[dict]) -> List[dict]:
        """Submit request bodies as one group and block until all finish;
        raises when a failed decode step finished any of them."""
        done = [threading.Event() for _ in bodies]
        reqs = [
            self._req_from_body(b, lambda _r, ev=ev: ev.set())
            for b, ev in zip(bodies, done)
        ]
        self.engine.submit_batch(reqs)
        for ev in done:
            ev.wait()
        if any(r.stop_reason == STEP_FAILED for r in reqs):
            raise RuntimeError("a decode step failed while the request was in flight")
        return [self._result_payload(r, self.engine.version) for r in reqs]

    def health(self) -> tuple:
        if not self.worker.is_alive() and not self.shutdown.is_set():
            return 500, {"status": "dead"}
        return 200, {
            "status": "paused" if self.paused.is_set() else "ok",
            "role": self.role,
            "version": self.engine.version,
            "active": self.engine.active_count(),
            "last_error": self.last_error,
        }


class _Handler(BaseHTTPRequestHandler):
    server: "GenHTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply(self, status: int, payload: dict) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json")

    def _send(self, status: int, data: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):
        url = urlsplit(self.path)
        if url.path == "/health":
            self._reply(*self.server.gen.health())
        elif url.path == "/metrics":
            fmt = parse_qs(url.query).get("format", [None])[0]
            if telemetry.wants_prometheus(fmt, self.headers.get("Accept", "")):
                self._send(200, telemetry.GEN.render_prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(200, self.server.gen.metrics())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _chunk_octets(self) -> None:
        h = self.headers
        data = self.rfile.read(int(h.get("Content-Length") or 0))
        self.server.gen.receive_chunk(
            h["X-Weight-Name"], data, int(h["X-Weight-Nbytes"]),
            h.get("X-Weight-Dtype", "bfloat16"), json.loads(h.get("X-Weight-Shape", "[]")),
            int(h.get("X-Weight-Offset", 0)))
        self._reply(200, {"ok": True, "received": h["X-Weight-Name"]})

    def _update_weights_chunk(self, body: dict) -> None:
        gen = self.server.gen
        version = body.get("version")
        version = None if version is None else int(version)
        if body.get("prepare"):
            self._reply(*gen.prepare(version))
        elif body.get("commit"):
            self._reply(*gen.commit(version, live=bool(body.get("live"))))
        else:
            gen.receive_chunk(body["name"], base64.b64decode(body["data_b64"]),
                              int(body["nbytes"]), body["dtype"], body["shape"],
                              int(body["offset"]))
            self._reply(200, {"ok": True, "received": body["name"]})

    @staticmethod
    def _arrival(path: str, body: dict) -> Optional[dict]:
        """What the arrival line records of a request; None for requests
        it does not record (pauses, chunk pieces)."""
        if path == "/generate":
            return {"rid": body.get("rid", "")}
        if path == "/generate_batch":
            return {"n": len(body.get("requests", []))}
        if path == "/update_weights_from_disk":
            return {"version": body.get("version")}
        if path == "/update_weights_chunk" and (body.get("prepare") or body.get("commit")):
            if body.get("commit"):
                return {"action": "commit", "version": body.get("version"),
                        "live": bool(body.get("live"))}
            return {"action": "prepare", "version": body.get("version")}
        return None

    def do_POST(self):
        gen = self.server.gen
        if (self.path == "/update_weights_chunk"
                and "application/octet-stream" in self.headers.get("Content-Type", "")):
            try:
                self._chunk_octets()
            except (KeyError, ValueError) as e:  # missing or malformed X-Weight-* headers
                self._reply(400, {"error": f"malformed weight chunk: {e!r}"})
            return
        try:
            body = self._body()
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"malformed JSON: {e}"})
            return
        arrival = self._arrival(self.path, body)
        if arrival is not None:
            logger.info("arrival %s at %.6f %s", self.path, time.time(), json.dumps(arrival))
        try:
            if self.path == "/generate":
                self._reply(200, gen.generate_many([body])[0])
            elif self.path == "/generate_batch":
                bodies = body.get("requests", [])
                if not bodies:
                    self._reply(400, {"error": "empty batch"})
                else:
                    self._reply(200, {"results": gen.generate_many(bodies)})
            elif self.path == "/pause_generation":
                gen.paused.set()
                self._reply(200, {"ok": True})
            elif self.path == "/continue_generation":
                gen.paused.clear()
                self._reply(200, {"ok": True})
            elif self.path == "/update_weights_from_disk":
                if "path" not in body:
                    self._reply(400, {"error": "missing 'path'"})
                    return
                version = body.get("version")
                fut = gen.queue_weight_update(
                    body["path"], None if version is None else int(version))
                self._reply(200, {"ok": True, "version": fut.result()})
            elif self.path == "/update_weights_chunk":
                self._update_weights_chunk(body)
            elif self.path == "/kv_export":
                self._reply(*gen.kv_export(body))
            elif self.path == "/kv_import":
                self._reply(*gen.kv_import(body))
            else:
                self._reply(404, {"error": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 — the failure goes to the client as a 500
            logger.warning("%s failed: %r", self.path, e)
            self._reply(500, {"error": f"{self.path} failed: {e}"})


class GenHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer carrying the GenServer its handlers use."""

    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets the connections
    # of a burst of concurrent clients (a GRPO rollout opens one per sample)
    request_queue_size = 1024

    def __init__(self, gen: GenServer, host: str = "0.0.0.0", port: int = 0):
        self.gen = gen
        super().__init__((host, port), _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve(engine: GenEngine, host: str = "0.0.0.0", port: int = 0,
          on_ready: Optional[Callable[[GenHTTPServer], None]] = None,
          role: str = "both") -> None:
    """Blocking serve: start the worker, bind, call `on_ready(httpd)`, and
    handle requests until `httpd.shutdown()`; then stop the worker."""
    gen = GenServer(engine, role=role)
    gen.start()
    try:
        with GenHTTPServer(gen, host, port) as httpd:
            logger.info("generation server on %s:%d", host, httpd.port)
            if on_ready is not None:
                on_ready(httpd)
            httpd.serve_forever()
    finally:
        gen.stop()


def main(argv: Optional[List[str]] = None,
         on_ready: Optional[Callable[[GenHTTPServer], None]] = None) -> None:
    """`python -m areal_tpu_torch.gen.server`: the JAX server's
    --model-path/--port/--n-slots/--max-seq-len, plus --dtype (weights and
    KV cache), --seed, --decode-chunk, --device (the card unless `cpu`)
    --exit-with-parent (a launcher's: the server exits when the
    process that started it is gone, so a killed trainer leaves no server
    holding the card), the JAX server's --spec-decode, --spec-ladder and
    --spec-draft-len (speculative decoding, verified through the ragged
    kernel at T = D + 1), --telemetry (lifecycle events; also
    AREAL_TELEMETRY=1), the JAX server's --decode-tiers, --decode-tier-lens
    and --decode-tier-slots (length-cohort tiers), --host-offload and
    --host-cache-mb (the host KV tier), --role (prefill, decode or both;
    decode turns the host tier on) and --experiment-name,
    --trial-name and --server-idx: with an experiment name the server
    reads the rendezvous store from ``AREAL_NAME_RESOLVE`` and registers
    its address under `names.gen_server` once it listens (the host's
    address when it binds every interface, else the one it binds).
    Decode attention is always the ragged kernel.
    Without --model-path it serves a random tiny model, as the JAX server
    does."""
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=128, help="KV page and prompt bucket")
    p.add_argument("--dtype", default="bfloat16", help="weights and KV cache")
    p.add_argument("--seed", type=int, default=0, help="sampler seed (and random weights)")
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--exit-with-parent", action="store_true",
                   help="exit when the process that started this one is gone")
    p.add_argument("--spec-decode", action="store_true",
                   help="speculative decoding: prompt-lookup drafts verified in one "
                        "dispatch; output streams stay those of plain decode")
    p.add_argument("--spec-ladder", default="",
                   help="static draft-length ladder (comma list incl. 0, e.g. '0,3,7')")
    p.add_argument("--spec-draft-len", type=int, default=0,
                   help="pin the draft length instead of adapting along the ladder")
    p.add_argument("--decode-tiers", type=int, default=1,
                   help="length-cohort slot tiers (placement and migration; one dispatch)")
    p.add_argument("--decode-tier-lens", default="",
                   help="per-tier length ceilings (comma list, ascending; with "
                        "--decode-tier-slots, overrides --decode-tiers)")
    p.add_argument("--decode-tier-slots", default="",
                   help="per-tier slot counts (comma list summing to --n-slots)")
    p.add_argument("--role", choices=ROLES, default="both",
                   help="what a disaggregating router sees: prefill servers take "
                        "admissions and export K/V, decode servers import it and "
                        "continue the stream; both is the colocated default")
    p.add_argument("--host-offload", action="store_true",
                   help="spill evicted retained prefixes to a host-memory LRU tier and "
                        "swap them back on a radix hit")
    p.add_argument("--host-cache-mb", type=int, default=64,
                   help="the host tier's capacity in MiB (with --host-offload)")
    p.add_argument("--telemetry", action="store_true",
                   help="emit trajectory lifecycle events (also AREAL_TELEMETRY=1)")
    p.add_argument("--experiment-name", default="",
                   help="register under this experiment's name_resolve keys")
    p.add_argument("--trial-name", default="")
    p.add_argument("--server-idx", type=int, default=0)
    args = p.parse_args(argv)
    if args.exit_with_parent:
        exit_with_parent(os.getppid())
    if args.telemetry:
        telemetry.set_enabled(True)
    if args.role == "decode" and not args.host_offload:
        # a decode server's work arrives as /kv_import host-tier entries
        logger.info("--role decode implies --host-offload; enabling it")
        args.host_offload = True

    def ints(text: str) -> Optional[List[int]]:
        return [int(x) for x in text.split(",")] if text else None

    kw = dict(n_slots=args.n_slots, max_seq_len=args.max_seq_len,
              prompt_bucket=args.page_size, kv_dtype=args.dtype, seed=args.seed,
              decode_chunk=args.decode_chunk, device=args.device,
              spec_decode=args.spec_decode,
              spec_ladder=ints(args.spec_ladder),
              spec_draft_len=args.spec_draft_len or None,
              decode_tiers=args.decode_tiers, decode_tier_lens=ints(args.decode_tier_lens),
              decode_tier_slots=ints(args.decode_tier_slots),
              host_offload=args.host_offload, host_cache_mb=args.host_cache_mb)
    if args.model_path:
        cfg = TransformerConfig.from_hf(args.model_path).replace(dtype=args.dtype)
        engine = GenEngine(cfg, model_path=args.model_path, **kw)
    else:
        engine = GenEngine(tiny_config().replace(dtype=args.dtype), **kw)
    if args.experiment_name:
        # launchers point every process of a fleet at one rendezvous store
        name_resolve.reconfigure_from_env()

    def ready(httpd: GenHTTPServer) -> None:
        if args.experiment_name:
            name_resolve.add(
                names.gen_server(args.experiment_name, args.trial_name, str(args.server_idx)),
                f"{network.advertised_host(args.host)}:{httpd.port}", replace=True)
        if on_ready is not None:
            on_ready(httpd)

    serve(engine, host=args.host, port=args.port, on_ready=ready, role=args.role)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
