"""HTTP generation server on the standard library (the port of
`areal_tpu/gen/server.py`, serving slice).

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
    GET  /health

`http.server.ThreadingHTTPServer` handles each connection on its own
thread; a dedicated worker thread owns the engine and the device (every
admission, decode step and weight reload runs there), and handler threads
wait on the request's completion.  /metrics, the chunked weight transfer
and the KV handoff endpoints come with later slices.

    python -m areal_tpu_torch.gen.server --model-path <hf dir> --port 8000
"""

import argparse
import concurrent.futures
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.model_config import TransformerConfig, tiny_config

logger = logging.getLogger("areal_tpu_torch.gen.server")


class GenServer:
    """The engine's worker thread plus the request/response translation."""

    def __init__(self, engine: GenEngine):
        self.engine = engine
        self.paused = threading.Event()  # set => the decode loop parks
        self.shutdown = threading.Event()
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.last_error: float = 0.0
        # a weight update handed from a handler thread to the worker
        self._cmd_lock = threading.Lock()
        self._pending_weight_update: Optional[dict] = None

    def start(self) -> None:
        self.worker.start()

    def stop(self, timeout: float = 30.0) -> None:
        self.shutdown.set()
        self.worker.join(timeout)

    def queue_weight_update(self, path: str, version: Optional[int] = None
                            ) -> "concurrent.futures.Future[int]":
        """Hand a reload of `path` to the worker; the future resolves to the
        engine's new version.  A reload still waiting is superseded (its
        future fails), so only the newest snapshot is loaded."""
        fut: "concurrent.futures.Future[int]" = concurrent.futures.Future()
        with self._cmd_lock:
            old = self._pending_weight_update
            self._pending_weight_update = {"future": fut, "path": path, "version": version}
        if old is not None:
            old["future"].set_exception(RuntimeError("superseded by a newer weight update"))
        return fut

    def _apply_weight_update(self) -> bool:
        with self._cmd_lock:
            upd, self._pending_weight_update = self._pending_weight_update, None
        if upd is None:
            return False
        try:
            upd["future"].set_result(
                self.engine.load_weights(path=upd["path"], version=upd["version"]))
        except Exception as e:  # noqa: BLE001 — surfaced to the waiting handler
            upd["future"].set_exception(e)
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
                logger.exception("decode step failed; aborting in-flight requests")
                self.last_error = time.time()
                self.engine.abort_all("abort")
                continue
            if not stepped:
                time.sleep(0.002)

    @staticmethod
    def _req_from_body(body: dict, on_done) -> GenRequest:
        """Wire body -> GenRequest (shared by /generate and /generate_batch)."""
        sp = body.get("sampling_params", {})
        return GenRequest(
            rid=body.get("rid", ""),
            trace_id=str(body.get("trace_id", "") or ""),
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
            # prefix reuse is not ported: no prompt token comes from
            # resident K/V
            "cache_hit_tokens": 0,
            "stream_id": r.stream_id,
        }

    def generate_many(self, bodies: List[dict]) -> List[dict]:
        """Submit request bodies as one group and block until all finish."""
        done = [threading.Event() for _ in bodies]
        reqs = [
            self._req_from_body(b, lambda _r, ev=ev: ev.set())
            for b, ev in zip(bodies, done)
        ]
        self.engine.submit_batch(reqs)
        for ev in done:
            ev.wait()
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
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):
        if self.path == "/health":
            self._reply(*self.server.gen.health())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        gen = self.server.gen
        try:
            body = self._body()
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"malformed JSON: {e}"})
            return
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
            try:
                self._reply(200, {"ok": True, "version": fut.result()})
            except Exception as e:  # noqa: BLE001 — the reload's error goes to the client
                self._reply(500, {"error": f"weight update failed: {e}"})
        else:
            self._reply(404, {"error": f"no route {self.path}"})


class GenHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer carrying the GenServer its handlers use."""

    daemon_threads = True

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
    --model-path/--port/--n-slots/--max-seq-len, serving on the card.
    Decode attention is always the ragged kernel.  Without --model-path it
    serves a random tiny model, as the JAX server does."""
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", default="")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    args = p.parse_args(argv)
    if args.model_path:
        cfg = TransformerConfig.from_hf(args.model_path).replace(dtype="bfloat16")
        engine = GenEngine(cfg, model_path=args.model_path, n_slots=args.n_slots,
                           max_seq_len=args.max_seq_len)
    else:
        engine = GenEngine(tiny_config(), n_slots=args.n_slots,
                           max_seq_len=args.max_seq_len)
    serve(engine, port=args.port, on_ready=on_ready)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
