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
                               assembles them into a model on the engine's
                               device while decoding goes on, and {commit,
                               version, live} swaps it in: live
                               (`swap_weights_live`) or after aborting
                               in-flight requests
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
`tokens_generated`, `active`, `version`, `last_pause_s` (the decode
loop's idle window in the last weight swap), `staged` (a transfer is
assembled and waits for its commit), the prefill accounting
(`prefill_tokens` cold, `suffix_tokens`, `reused_tokens` from retained
prefixes, `shared_tokens` from a group's fanned-out prefix, `copy_calls`)
and `reservations_lapsed` (abort reservations whose owner did not
resubmit in time), `ragged_dispatches`,
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
gauges (active requests, weight version, the last pause, the prefix-cache
hit rate, the acceptance rate over the server's life and per tier as
`{tier="0"}`, the mean pages a ragged dispatch read) and the histograms
the engine observes (pause window, admission wait, decode chunk).

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
handler threads wait on the request's completion.  The KV handoff
endpoints come with a later slice.

    python -m areal_tpu_torch.gen.server --model-path <hf dir> --port 8000
    python -m areal_tpu_torch.gen.server --model-path <hf dir> --spec-decode
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
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.hf import state_to_params
from areal_tpu_torch.models.model_config import TransformerConfig, tiny_config
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.ops.ragged_decode import ragged_paged_attention
from areal_tpu_torch.utils import name_resolve, names, network, telemetry
from areal_tpu_torch.utils.shutdown import exit_with_parent

logger = logging.getLogger("areal_tpu_torch.gen.server")

# the stop reason of requests a failed decode step finished: answered 500
STEP_FAILED = "error"


class GenServer:
    """The engine's worker thread plus the request/response translation."""

    def __init__(self, engine: GenEngine):
        self.engine = engine
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
        # the transfer publish: pieces by name, then the assembled model
        self._chunk_lock = threading.Lock()
        self._chunk_buf: Dict[str, dict] = {}  # guarded-by: _chunk_lock
        self._staged: Optional[Tuple[Transformer, Optional[int]]] = None  # guarded-by: _chunk_lock
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
        )
        tokens = reg.counter("tokens_generated_total", "Decode tokens delivered")
        active = reg.gauge("active_requests", "Requests in slots, admitting or queued")
        version = reg.gauge("weight_version", "Live weight version")
        pause = reg.gauge("last_pause_seconds",
                          "Most recent weight-swap pause window (histogram: "
                          "areal_gen_pause_window_seconds)")
        staged = reg.gauge("staged_standby", "Transfer staged and awaiting its commit (0/1)")
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
            with srv._chunk_lock:
                staged.set(1.0 if srv._staged is not None else 0.0)
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

    # ------------------------- the transfer publish ---------------------

    def receive_chunk(self, name: str, data, nbytes: int, dtype: str, shape: List[int],
                      offset: int) -> None:
        """Copy one piece of tensor `name` into its staging buffer."""
        with self._chunk_lock:
            entry = self._chunk_buf.setdefault(
                name, {"buf": bytearray(nbytes), "dtype": dtype, "shape": list(shape)})
            entry["buf"][offset:offset + len(data)] = data

    def _assemble_locked(self) -> Transformer:  # holds: _chunk_lock
        """Drain the chunk buffer into a model on the engine's device, in
        the engine's weight dtype (bf16 pieces round-trip exactly)."""
        buf, self._chunk_buf = self._chunk_buf, {}
        items = ((name, torch.frombuffer(e["buf"], dtype=torch_dtype(e["dtype"])
                                         ).reshape(e["shape"]))
                 for name, e in buf.items())
        model = state_to_params(items, self.engine.model_config, device=self.engine.device)
        if self.engine.device.type == "cuda":
            # the copies are done when `prepare` answers: the commit swaps
            # a model that is already on the card
            torch.cuda.synchronize(self.engine.device)
        return model

    def prepare(self, version: Optional[int]) -> Tuple[int, dict]:
        """Assemble the received pieces on the device; decoding goes on."""
        with self._chunk_lock:
            if not self._chunk_buf:
                return 409, {"error": "prepare without staged chunks"}
            self._staged = (self._assemble_locked(), version)
        return 200, {"ok": True, "staged": True}

    def commit(self, version: Optional[int], live: bool) -> Tuple[int, dict]:
        """Swap in the prepared model (or the received pieces): live, or
        after aborting in-flight requests.  A commit retried after its
        response was lost answers 200 when that version is already live."""
        with self._chunk_lock:
            staged, self._staged = self._staged, None
            if staged is not None and version not in (None, staged[1]):
                self._staged = staged  # another version's: keep it, refuse
                return 409, {"error": f"staged version {staged[1]}, commit of {version}"}
            if staged is None and self._chunk_buf:
                staged = (self._assemble_locked(), version)
        if staged is None:
            if version is None or version == self._last_committed_version:
                return 200, {"ok": True, "version": self.engine.version}
            return 409, {"error": "commit without staged chunks"}
        model, v = staged
        if live:
            fut = self._queue(lambda: self.engine.swap_weights_live(model, version=v))
        else:
            fut = self._queue(lambda: self.engine.load_weights(model=model, version=v))
        new_version = fut.result()
        self._last_committed_version = new_version
        return 200, {"ok": True, "version": new_version}

    def metrics(self) -> dict:
        stats = self.engine.stats
        with self._chunk_lock:
            staged = self._staged is not None
        out = {
            "decode_steps": stats["decode_steps"],
            "decode_calls": stats["decode_calls"],
            "tokens_generated": self.tokens_out,
            "active": self.engine.active_count(),
            "version": self.engine.version,
            "last_pause_s": self.last_pause_s,
            "staged": staged,
            "prefill_tokens": stats["prefill_tokens"],
            "suffix_tokens": stats["suffix_tokens"],
            "reused_tokens": stats["reused_tokens"],
            "shared_tokens": stats["shared_tokens"],
            "copy_calls": stats["copy_calls"],
            "reservations_lapsed": stats["reservations_lapsed"],
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
        if self.engine.device.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.engine.device)
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
          on_ready: Optional[Callable[[GenHTTPServer], None]] = None) -> None:
    """Blocking serve: start the worker, bind, call `on_ready(httpd)`, and
    handle requests until `httpd.shutdown()`; then stop the worker."""
    gen = GenServer(engine)
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
    AREAL_TELEMETRY=1) and the JAX server's --experiment-name,
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
    kw = dict(n_slots=args.n_slots, max_seq_len=args.max_seq_len,
              prompt_bucket=args.page_size, kv_dtype=args.dtype, seed=args.seed,
              decode_chunk=args.decode_chunk, device=args.device,
              spec_decode=args.spec_decode,
              spec_ladder=[int(x) for x in args.spec_ladder.split(",")] if args.spec_ladder
              else None,
              spec_draft_len=args.spec_draft_len or None)
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

    serve(engine, host=args.host, port=args.port, on_ready=ready)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
