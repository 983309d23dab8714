"""The router in front of N generation servers (the port of
`areal_tpu/gen/router.py`, on the standard library: the card's machine has
no `aiohttp`).

A service of its own, the counterpart of the reference's `GserverManager`,
that

- **routes** `/generate` and `/generate_batch` to a backend under a policy
  (round_robin | least_requests | least_tokens), with rid affinity (the
  group's id when one is declared) in an LRU of `RID_CACHE_SIZE` keys, so
  that a resubmission lands where the K/V prefix lives and a GRPO group's
  siblings share one engine;
- **gates rollout admission fleet-wide**: `/allocate_request` grants a
  lease while ``(max_head_offpolicyness + version + 1) x train_batch_size``
  exceeds the leases running plus the rollouts accepted, and answers 409
  otherwise; `/finish_request` returns a lease (one the TTL reclaimed is
  refused, so it cannot double-book the budget);
- **follows the trainer's version**: a checkpoint watcher polls
  name_resolve for `update_weights_from_disk` keys and flushes the fleet
  (pause all, `/update_weights_from_disk`, always resume; a publish that
  reaches only part of the fleet is counted in `publish_partial_failures`);
  without a watcher, `/set_version` from the trainer's transfer publish and
  a poll of the backends' `/health` version move the gate;
- **checks backend health** (`gen/health.py`): a probe thread and a
  circuit breaker per backend.  A proxied request that fails in transport
  answers 502, strikes the breaker and drops its affinity; the client's
  failover resubmits.  A backend that answers again after death is
  half-open until `_verify_rejoin` has force-reloaded it from the last disk
  publish when it serves an older version than the fleet's.

- **disaggregates prefill and decode** (`RouterConfig.disagg`): with a
  prefill-role and a decode-role backend placeable, `/generate` runs as
  two legs.  Leg 1 (admission, prefill and the first
  `handoff_leg1_tokens` tokens) goes to a prefill server (rid or group
  affinity first); its prefix K/V moves `/kv_export` -> `/kv_import` to the
  decode server of lowest polled tier occupancy; leg 2 (the tail) runs
  there with leg 1's `stream_id`, so the merged stream is the one a
  single server would sample.  A failed transfer continues the tail on
  the prefill server; an empty role pool, the transfer backpressure
  (`handoff_max_inflight`) or a failed leg 1 serve the request colocated.

Clients speak the generation server's wire format to it, so the remote
client points at the router as at one big server.  Routes:

    POST /generate, /generate_batch             proxied to one backend
    POST /allocate_request {qid}                -> {version, staled, alloc_id} | 409
    POST /finish_request {alloc_id, accepted}   -> {ok} | {ok: false, expired: true}
    POST /update_weights {path, version?}       the fleet flush -> {ok, version}
    POST /set_version {version}                 -> {ok, version}
    POST /pause_generation, /continue_generation   fanned out
    POST /drain, /undrain {addr}                -> {ok} | 404
    GET  /health                                the checker's cached view, `freshness_s`
    GET  /metrics                               JSON, or Prometheus (`areal_router_*`)
                                                with ?format=prometheus

The JSON `/metrics` adds keys to the reference's: `last_flush_s`, the last
fleet flush's wall time from the first pause to the last resume, and
`handoff_bytes` and `handoff_seconds`, the K/V bytes the handoffs moved and
their export-to-import wall time, summed.

`ThreadingHTTPServer` handles each connection on a thread of its own, and
backend calls are `http.client` calls on those threads: the ledger lock
is a `threading.Lock`, the flush serializer a lock of its own taken before
it, the transfer backpressure a `threading.BoundedSemaphore`, and the probe
loop, the checkpoint watcher, the version poller and the decode-occupancy
poller are daemon threads that `stop` joins.

    python -m areal_tpu_torch.gen.router --experiment-name E --trial-name T \\
        --train-batch-size 32 --max-head-offpolicyness 1 --weights-path DIR
    python -m areal_tpu_torch.gen.router --addrs PREFILL,DECODE --disagg
"""

import argparse
import concurrent.futures
import http.client
import json
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlsplit

from areal_tpu_torch.gen.health import STATE_CODES, BackendHealthChecker
from areal_tpu_torch.utils import name_resolve, names, network, telemetry
from areal_tpu_torch.utils.http import exchange
from areal_tpu_torch.utils.shutdown import exit_with_parent

logger = logging.getLogger("areal_tpu_torch.gen.router")

RID_CACHE_SIZE = 8192
# a proxied call that failed in transport (refused, reset, timed out)
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

Reply = Tuple[int, Union[dict, str]]


@dataclass
class RouterConfig:
    experiment_name: str = ""
    trial_name: str = ""
    schedule_policy: str = "least_requests"  # round_robin | least_requests | least_tokens
    # the fleet staleness gate (0 disables it)
    train_batch_size: int = 0
    max_head_offpolicyness: int = 0
    # the checkpoint watcher: snapshots at `weights_path`/v{N}
    weights_path: str = ""
    poll_interval: float = 1.0
    # without a watcher, with the gate on: poll the backends' /health and
    # adopt the fleet's newest served version (0 disables)
    version_poll_interval: float = 2.0
    request_timeout: float = 3600.0
    # leases older than this are reclaimed (0 => request_timeout), so a
    # client that crashed mid-episode cannot wedge fleet admission
    alloc_ttl: float = 0.0
    # the probe thread and the circuit breaker (gen/health.py): probe every
    # interval seconds (0: no probe thread; proxied outcomes still count),
    # open after this many consecutive failures
    health_check_interval: float = 5.0
    health_failure_threshold: int = 3
    health_probe_timeout: float = 2.0
    # disaggregated prefill/decode serving: with both role pools placeable,
    # /generate runs as a prefill leg, a K/V transfer and a decode leg
    disagg: bool = False
    # backpressure: transfers in flight fleet-wide; beyond it, colocated
    handoff_max_inflight: int = 4
    # tokens sampled on the prefill server before the handoff (>= 1: the
    # prefill samples the first)
    handoff_leg1_tokens: int = 1
    # poll decode servers' /metrics for tier occupancy at this cadence (0:
    # place by in-flight counts alone)
    occupancy_poll_interval: float = 1.0


class Router:
    # the fleet staleness gate's ledger and the failure counters: every
    # read and write holds _lock, so capacity checks are atomic with lease
    # grants
    _GUARDED_FIELDS = {
        "_running": "_lock",
        "_accepted": "_lock",
        "_failovers": "_lock",
        "_publish_partial_failures": "_lock",
        "_last_publish": "_lock",
        "_handoffs": "_lock",
        "_handoff_fallbacks": "_lock",
        "_handoff_bytes": "_lock",
        "_handoff_seconds": "_lock",
    }
    # _flush_and_update holds the flush serializer across the backend
    # fan-out, then takes the ledger lock to commit; never the other way
    # lock-order: _flush_lock -> _lock

    def __init__(self, config: RouterConfig, addresses: Optional[List[str]] = None):
        self.config = config
        self.addresses: List[str] = list(addresses or [])
        self.version = 0
        self._rr = 0
        self._inflight: Dict[str, int] = {}
        self._routed: Dict[str, int] = {}  # requests per backend, cumulative
        self._tokens: Dict[str, int] = {}  # prompt tokens in flight per backend
        self._rid_to_addr: "OrderedDict[str, str]" = OrderedDict()
        # the gate's ledger: lease id -> grant time (orphans age out)
        self._running: Dict[str, float] = {}
        self._accepted = 0
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.n_flushes = 0
        self.last_flush_s = 0.0
        self._health: Optional[BackendHealthChecker] = None
        self._failovers = 0
        self._publish_partial_failures = 0
        # (path, version) of the last disk publish: a rejoining backend is
        # reloaded from it before it takes placements again
        self._last_publish: Optional[Tuple[str, int]] = None
        # disaggregated serving: each backend's advertised role (from its
        # /health), the decode servers' polled occupancy (plain dict writes
        # from the probe and poller threads), the transfer backpressure and
        # the handoff ledger
        self._roles: Dict[str, str] = {}
        self._decode_occ: Dict[str, float] = {}
        self._handoff_sem = threading.BoundedSemaphore(max(1, config.handoff_max_inflight))
        self._handoffs = 0
        self._handoff_fallbacks = 0
        self._handoff_bytes = 0
        self._handoff_seconds = 0.0

    # ---------------------------- scheduling ----------------------------

    def _placeable(self) -> List[str]:
        """Backends for new placements: the breaker's closed set, in address
        order (round-robin indices stay stable while all are healthy); the
        whole list when every backend is tripped, so requests fail fast
        and probing goes on."""
        if self._health is None:
            return self.addresses
        ok = set(self._health.placeable_cache)
        return [a for a in self.addresses if a in ok] or self.addresses

    def _choose(self) -> str:
        pool = self._placeable()
        policy = self.config.schedule_policy
        if policy == "least_requests":
            return min(pool, key=lambda a: self._inflight.get(a, 0))
        if policy == "least_tokens":
            return min(pool, key=lambda a: self._tokens.get(a, 0))
        addr = pool[self._rr % len(pool)]
        self._rr += 1
        return addr

    def _server_for_rid(self, rid: str) -> str:
        if rid and rid in self._rid_to_addr:
            addr = self._rid_to_addr[rid]
            if addr in self._placeable():
                self._rid_to_addr.move_to_end(rid)
                return addr
            # pinned to a dead or draining backend: its K/V is gone, re-place
            # (a group rides one key, so its siblings move together)
            del self._rid_to_addr[rid]
        addr = self._choose()
        if rid:
            if len(self._rid_to_addr) >= RID_CACHE_SIZE:
                self._rid_to_addr.popitem(last=False)
            self._rid_to_addr[rid] = addr
        return addr

    # --------------------- disaggregated placement ----------------------

    def _role_pool(self, role: str) -> List[str]:
        """Placeable backends advertising exactly `role`: `both` servers
        stay out of the pools, as the colocated fallback."""
        return [a for a in self._placeable() if self._roles.get(a, "both") == role]

    def _prefill_for_rid(self, rid: str, pool: List[str]) -> str:  # holds: _lock
        """Prefill placement: rid or group affinity first (a group's fan-out
        shares its prefix inside one engine), else the shallowest queue."""
        if rid and self._rid_to_addr.get(rid) in pool:
            self._rid_to_addr.move_to_end(rid)
            return self._rid_to_addr[rid]
        addr = min(pool, key=lambda a: self._inflight.get(a, 0))
        if rid:
            if len(self._rid_to_addr) >= RID_CACHE_SIZE:
                self._rid_to_addr.popitem(last=False)
            self._rid_to_addr[rid] = addr
        return addr

    def _decode_pick(self, pool: List[str]) -> str:
        """Decode placement: the lowest polled tier occupancy, in-flight
        requests as the tiebreak."""
        return min(pool, key=lambda a: (self._decode_occ.get(a, 0.0), self._inflight.get(a, 0)))

    def _evict_backend_locked(self, addr: str) -> int:  # holds: _lock
        """Drop every affinity pinned to `addr`; each one is a failover."""
        evicted = [r for r, a in self._rid_to_addr.items() if a == addr]
        for r in evicted:
            del self._rid_to_addr[r]
        self._failovers += len(evicted)
        return len(evicted)

    def _on_backend_death(self, addr: str) -> None:
        """The breaker's callback (closed/half_open -> open)."""
        with self._lock:
            n = self._evict_backend_locked(addr)
        logger.warning("backend %s dead: rerouted %d rid/group affinities", addr, n)

    # ------------------------- staleness gate ---------------------------

    def _prune_allocations(self) -> None:  # holds: _lock
        """Reclaim leases whose client never called /finish_request."""
        cutoff = time.monotonic() - (self.config.alloc_ttl or self.config.request_timeout)
        stale = [aid for aid, t in self._running.items() if t < cutoff]
        for aid in stale:
            del self._running[aid]
        if stale:
            logger.warning("reclaimed %d expired rollout allocations", len(stale))

    def _capacity(self) -> Optional[int]:  # holds: _lock
        """Admissions left fleet-wide, or None when the gate is off: the
        staleness manager's formula over every client, (staleness +
        version + 1) x train_batch_size minus the leases running and the
        rollouts accepted."""
        bs = self.config.train_batch_size
        if bs <= 0:
            return None
        self._prune_allocations()
        allowed = (self.config.max_head_offpolicyness + self.version + 1) * bs
        return allowed - (len(self._running) + self._accepted)

    # ---------------------------- handlers ------------------------------

    def generate(self, body: dict) -> Reply:
        # a group's members must land on one engine (the K/V prefix is
        # shared only within one cache): the key is the group when one is
        # declared, the rid otherwise
        key = body.get("group_id") or body.get("rid", "")
        if self.config.disagg:
            reply = self._generate_disagg(body, key)
            if reply is not None:
                return reply
            # colocated: an empty role pool, backpressure or a failed leg 1
        return self._proxy("/generate", body, key, 1, len(body.get("input_ids", ())))

    def generate_batch(self, body: dict) -> Reply:
        """A whole group to one backend in one POST; the key is the first
        member's group id or rid."""
        reqs = body.get("requests", [])
        if not reqs:
            return 400, {"error": "empty batch"}
        key = reqs[0].get("group_id") or reqs[0].get("rid", "")
        n_prompt = sum(len(r.get("input_ids", ())) for r in reqs)
        return self._proxy("/generate_batch", body, key, len(reqs), n_prompt)

    def _proxy(self, path: str, body: dict, key: str, n_reqs: int, n_prompt: int) -> Reply:
        # _tokens is the prompt tokens resident on each backend (the
        # reference's least_token_usage signal), freed when a call returns
        with self._lock:
            addr = self._server_for_rid(key)
            self._inflight[addr] = self._inflight.get(addr, 0) + n_reqs
            self._routed[addr] = self._routed.get(addr, 0) + n_reqs
            self._tokens[addr] = self._tokens.get(addr, 0) + n_prompt
        try:
            try:
                status, payload = exchange(addr, path, body, timeout=self.config.request_timeout)
            finally:
                with self._lock:
                    self._inflight[addr] = max(0, self._inflight.get(addr, n_reqs) - n_reqs)
                    self._tokens[addr] = max(0, self._tokens.get(addr, 0) - n_prompt)
        except TRANSPORT_ERRORS as e:
            return self._proxy_failed(addr, key, e)
        if self._health is not None and status == 200:
            self._health.report_success(addr)
        return status, payload

    # ------------------------ disaggregated legs ------------------------

    def _leg_post(self, addr: str, body: dict, n_tokens: int) -> Tuple[int, dict]:
        """One /generate leg with the colocated path's in-flight and token
        bookkeeping; a transport failure raises to the caller."""
        with self._lock:
            self._inflight[addr] = self._inflight.get(addr, 0) + 1
            self._routed[addr] = self._routed.get(addr, 0) + 1
            self._tokens[addr] = self._tokens.get(addr, 0) + n_tokens
        try:
            return exchange(addr, "/generate", body, timeout=self.config.request_timeout)
        finally:
            with self._lock:
                self._inflight[addr] = max(0, self._inflight.get(addr, 1) - 1)
                self._tokens[addr] = max(0, self._tokens.get(addr, 0) - n_tokens)

    def _transfer(self, src: str, dst: str, ids: List[int]) -> Tuple[bool, int]:
        """/kv_export on `src` -> /kv_import on `dst`, under the
        backpressure semaphore: (moved, payload bytes)."""
        with self._handoff_sem:
            try:
                status, doc = exchange(src, "/kv_export", {"input_ids": ids},
                                       timeout=self.config.request_timeout)
                if status != 200:
                    return False, 0
                status, _ = exchange(dst, "/kv_import", doc, timeout=self.config.request_timeout)
                return status == 200, int(doc.get("nbytes", 0) or 0)
            except TRANSPORT_ERRORS:
                return False, 0

    def _generate_disagg(self, body: dict, key: str) -> Optional[Reply]:
        """Two-leg /generate: leg 1 on a prefill server, the K/V transfer,
        leg 2 on a decode server.  None sends the caller to colocated
        placement, which is always exact: the counter-keyed sampler makes
        the stream a function of (stream_id, position)."""
        sp = dict(body.get("sampling_params") or {})
        orig_max = int(sp.get("max_new_tokens", 256))
        orig_min = int(sp.get("min_new_tokens", 0) or 0)
        leg1_n = max(1, self.config.handoff_leg1_tokens)
        # backpressure: a transfer slot must be free now (a peek; the
        # transfer takes one for real)
        if not self._handoff_sem.acquire(blocking=False):
            return None
        self._handoff_sem.release()
        with self._lock:
            prefill_pool = self._role_pool("prefill")
            decode_pool = self._role_pool("decode")
            if not prefill_pool or not decode_pool or orig_max <= leg1_n:
                return None
            prefill_addr = self._prefill_for_rid(key, prefill_pool)
            decode_addr = self._decode_pick(decode_pool)

        # --- leg 1 ---
        leg1_body = dict(body, sampling_params=dict(
            sp, max_new_tokens=leg1_n, min_new_tokens=min(orig_min, leg1_n)))
        n_prompt = len(body.get("input_ids", ()))
        try:
            status, leg1 = self._leg_post(prefill_addr, leg1_body, n_prompt)
        except TRANSPORT_ERRORS as e:
            # no token was delivered: nothing is lost, place it colocated
            if self._health is not None:
                self._health.report_failure(prefill_addr, repr(e))
            with self._lock:
                if self._rid_to_addr.get(key) == prefill_addr:
                    del self._rid_to_addr[key]
                    self._failovers += 1
                self._handoff_fallbacks += 1
            return None
        if status != 200:
            with self._lock:
                self._handoff_fallbacks += 1
            return None
        if self._health is not None:
            self._health.report_success(prefill_addr)
        toks = [int(t) for t in leg1.get("output_tokens", [])]
        if leg1.get("stop_reason") != "length" or not toks:
            return 200, leg1  # finished inside leg 1: nothing to hand off

        # --- the K/V transfer ---
        full_ids = [int(t) for t in body["input_ids"]] + toks
        t0 = time.perf_counter()
        moved, nbytes = self._transfer(prefill_addr, decode_addr, full_ids)
        dt = time.perf_counter() - t0
        if moved:
            telemetry.emit("handoff", trace_id=str(body.get("trace_id", "") or "") or None,
                           latency_s=dt, bytes=nbytes, src=prefill_addr, dst=decode_addr)
            with self._lock:
                self._handoffs += 1
                self._handoff_bytes += nbytes
                self._handoff_seconds += dt
        else:
            # a cache miss, a refusing or dead decode server: the tail
            # continues on the prefill server, exact all the same
            decode_addr = prefill_addr
            with self._lock:
                self._handoff_fallbacks += 1

        # --- leg 2 ---
        leg2_body = dict(body, input_ids=full_ids,
                         stream_id=int(leg1.get("stream_id", 0) or 0),
                         sampling_params=dict(sp, max_new_tokens=orig_max - len(toks),
                                              min_new_tokens=max(0, orig_min - len(toks))))
        try:
            status2, leg2 = self._leg_post(decode_addr, leg2_body, len(full_ids))
        except TRANSPORT_ERRORS as e:
            if decode_addr == prefill_addr:
                return self._proxy_failed(prefill_addr, key, e)
            if self._health is not None:
                self._health.report_failure(decode_addr, repr(e))
            # the decode server died in the tail; the prefill server still
            # holds the prefix
            try:
                status2, leg2 = self._leg_post(prefill_addr, leg2_body, len(full_ids))
            except TRANSPORT_ERRORS as e2:
                return self._proxy_failed(prefill_addr, key, e2)
        if status2 != 200:
            return status2, leg2
        if self._health is not None:
            self._health.report_success(decode_addr)
        merged = dict(leg2)
        merged["output_tokens"] = toks + [int(t) for t in leg2.get("output_tokens", [])]
        merged["output_logprobs"] = (list(leg1.get("output_logprobs", []))
                                     + list(leg2.get("output_logprobs", [])))
        merged["output_versions"] = (list(leg1.get("output_versions", []))
                                     + list(leg2.get("output_versions", [])))
        # the admission that counts for warm-start accounting is leg 1's
        merged["cache_hit_tokens"] = leg1.get("cache_hit_tokens", 0)
        merged["handoff"] = moved
        return 200, merged

    def _proxy_failed(self, addr: str, key: str, exc: BaseException) -> Reply:
        """A proxied call died in transport: strike the backend's breaker,
        drop this key's affinity so its resubmission re-places, and answer
        502.  The client's failover owns the resubmit: only it knows the
        tokens generated so far."""
        with self._lock:
            if self._rid_to_addr.get(key) == addr:
                del self._rid_to_addr[key]
                self._failovers += 1
        if self._health is not None:
            self._health.report_failure(addr, repr(exc))
        return 502, {"error": f"backend {addr} unreachable: {exc!r}"}

    def allocate_request(self, body: dict) -> Reply:
        """Admission of one rollout sample: a lease, or 409 while the fleet
        is staleness-bound.  No placement happens here: the client routes
        its own /generate calls, and one-shot qids would evict live rid
        affinities from the LRU."""
        with self._lock:
            cap = self._capacity()
            version = self.version
            if cap is None:
                # gate off: admit without a lease (nothing would prune it)
                return 200, {"version": version, "staled": False, "alloc_id": None}
            if cap <= 0:
                return 409, {"staled": True, "version": version}
            alloc_id = uuid.uuid4().hex
            self._running[alloc_id] = time.monotonic()
        return 200, {"version": version, "staled": False, "alloc_id": alloc_id}

    def finish_request(self, body: dict) -> Reply:
        alloc_id = body.get("alloc_id", "")
        with self._lock:
            if alloc_id in self._running:
                del self._running[alloc_id]
            elif alloc_id:
                # the TTL reclaimed this lease and its admission may be held
                # by someone else now: counting the late finish would
                # double-book the budget
                return 200, {"ok": False, "expired": True}
            elif self._running:
                # a caller without a lease id frees the oldest lease
                self._running.pop(next(iter(self._running)))
            if body.get("accepted", True):
                self._accepted += 1
        return 200, {"ok": True}

    def update_weights(self, body: dict) -> Reply:
        version = self._flush_and_update(body["path"], body.get("version"))
        return 200, {"ok": True, "version": version}

    def set_version(self, body: dict) -> Reply:
        """The trainer's version signal after a transfer publish, which
        leaves no checkpoint for the watcher: without it the gate's budget
        never grows and admission answers 409 forever."""
        version = int(body["version"])
        with self._lock:
            self.version = max(self.version, version)
            version = self.version
        return 200, {"ok": True, "version": version}

    def pause(self, body: dict) -> Reply:
        self._fanout("/pause_generation", {})
        return 200, {"ok": True}

    def resume(self, body: dict) -> Reply:
        self._fanout("/continue_generation", {})
        return 200, {"ok": True}

    def health(self) -> Reply:
        """The checker's cached view; one sweep is forced only while some
        backend was never probed (the start, or no probe thread)."""
        if self._health is None:
            return 503, {"status": "starting", "version": self.version, "servers": {}}
        states = self._health.snapshot()
        if any(s["age_s"] is None for s in states.values()):
            self._health.probe_now()
            states = self._health.snapshot()
        ok = all(s["state"] in ("closed", "draining") for s in states.values())
        freshness = max((s["age_s"] for s in states.values() if s["age_s"] is not None),
                        default=None)
        return (200 if ok else 503,
                {"status": "ok" if ok else "degraded", "version": self.version,
                 "servers": states, "freshness_s": freshness})

    def drain(self, body: dict) -> Reply:
        """Graceful removal: no new placements, fan-outs still reach it."""
        ok = self._health is not None and self._health.drain(body.get("addr", ""))
        return (200 if ok else 404), {"ok": ok}

    def undrain(self, body: dict) -> Reply:
        ok = self._health is not None and self._health.undrain(body.get("addr", ""))
        return (200 if ok else 404), {"ok": ok}

    def metrics(self, prometheus: bool = False) -> Reply:
        # the ledger is read under _lock here, in the handler, and not by a
        # scrape-time collector that would read it without the lock
        with self._lock:
            cap = self._capacity()
            snap = {
                "version": self.version,
                "inflight": dict(self._inflight),
                "requests_routed": dict(self._routed),
                "tokens_inflight": dict(self._tokens),
                "running": len(self._running),
                "accepted": self._accepted,
                "capacity": cap,
                "n_flushes": self.n_flushes,
                "last_flush_s": self.last_flush_s,
                "failovers": self._failovers,
                "publish_partial_failures": self._publish_partial_failures,
                "handoffs": self._handoffs,
                "handoff_fallbacks": self._handoff_fallbacks,
                "handoff_bytes": self._handoff_bytes,
                "handoff_seconds": self._handoff_seconds,
                "roles": dict(self._roles),
            }
        snap["backend_states"] = self._health.snapshot() if self._health is not None else {}
        if not prometheus:
            return 200, snap
        reg = telemetry.ROUTER
        reg.gauge("weight_version", "fleet weight version").set(snap["version"])
        reg.gauge("rollout_running", "leased rollout allocations").set(snap["running"])
        reg.counter("rollout_accepted_total", "accepted rollouts").set_total(snap["accepted"])
        reg.gauge("admission_capacity", "remaining staleness-gate admissions").set(
            -1 if cap is None else cap)
        reg.counter("flushes_total", "fleet weight flushes").set_total(snap["n_flushes"])
        for addr, v in snap["requests_routed"].items():
            reg.counter("requests_routed_total", "requests per backend").set_total(v, server=addr)
        for addr, v in snap["inflight"].items():
            reg.gauge("requests_inflight", "in-flight per backend").set(v, server=addr)
        for addr, v in snap["tokens_inflight"].items():
            reg.gauge("tokens_inflight", "in-flight tokens per backend").set(v, server=addr)
        reg.counter("failovers_total",
                    "rid/group affinities rerouted off failed backends").set_total(
                        snap["failovers"])
        reg.counter("areal_publish_partial_failures_total",
                    "fleet members missed by weight publishes").set_total(
                        snap["publish_partial_failures"])
        reg.counter("handoffs_total", "completed prefill->decode KV handoffs").set_total(
            snap["handoffs"])
        reg.counter("handoff_fallbacks_total",
                    "disaggregated requests that fell back to colocated placement").set_total(
                        snap["handoff_fallbacks"])
        state_gauge = reg.gauge("backend_state", "circuit state per backend "
                                "(0=closed 1=half_open 2=open 3=draining)")
        for addr, st in snap["backend_states"].items():
            state_gauge.set(STATE_CODES[st["state"]], server=addr)
        return 200, reg.render_prometheus()

    # ------------------------ flush + update ----------------------------

    def _one_post(self, addr: str, endpoint: str, payload: dict, timeout: float = 300.0) -> dict:
        status, out = exchange(addr, endpoint, payload, timeout=timeout)
        if status != 200:
            raise RuntimeError(f"POST {addr}{endpoint} -> HTTP {status}: {out}")
        return out

    def _alive_targets(self) -> List[str]:
        """Fan-out recipients: every backend the breaker thinks reachable
        (closed and draining).  Open ones get current weights on rejoin."""
        if self._health is None:
            return self.addresses
        alive = set(self._health.alive_cache)
        return [a for a in self.addresses if a in alive]

    def _fanout(self, endpoint: str, payload: dict, timeout: float = 300.0,
                targets: Optional[List[str]] = None) -> Dict[str, object]:
        """POST to each target in parallel: {addr: response or the
        exception}, so one dead member never holds a fan-out behind its
        timeout."""
        if targets is None:
            targets = self._alive_targets()
        if not targets:
            return {}
        out: Dict[str, object] = {}
        with concurrent.futures.ThreadPoolExecutor(len(targets)) as pool:
            futs = {a: pool.submit(self._one_post, a, endpoint, payload, timeout)
                    for a in targets}
            for a, f in futs.items():
                try:
                    out[a] = f.result()
                except Exception as e:  # noqa: BLE001 — each member's outcome is a value
                    out[a] = e
        return out

    def _flush_and_update(self, path: str, version: Optional[int]) -> int:
        """Pause every backend (in-flight requests abort and the clients
        resume them on the new weights), reload, and always resume.  The
        publish goes on over the reachable part of the fleet: a failed
        member is counted and strikes its breaker, as long as one backend
        took the weights."""
        with self._flush_lock:
            t0 = time.perf_counter()
            targets = self._alive_targets()
            try:
                self._fanout("/pause_generation", {}, targets=targets)
                outcomes = self._fanout("/update_weights_from_disk",
                                        {"path": path, "version": version}, targets=targets)
            finally:
                # a failed pause or reload on one backend must not leave the
                # rest of the fleet parked
                self._fanout("/continue_generation", {}, targets=targets)
            self.last_flush_s = time.perf_counter() - t0
            successes = {a: r for a, r in outcomes.items() if not isinstance(r, BaseException)}
            for a, r in outcomes.items():
                if isinstance(r, BaseException):
                    logger.warning("weight publish to %s failed: %r", a, r)
                    if self._health is not None:
                        self._health.report_failure(a, repr(r))
            if not successes:
                raise RuntimeError(f"weight publish {path} v{version} reached no backend "
                                   f"(targets={targets})")
            missed = len(self.addresses) - len(successes)
            with self._lock:
                self.version = (version if version is not None
                                else max(int(r.get("version", 0)) for r in successes.values()))
                self.n_flushes += 1
                self._last_publish = (path, self.version)
                self._publish_partial_failures += missed
                new_version = self.version
            if missed:
                logger.warning("degraded publish: v%d on %d/%d servers (%d missed; rejoin "
                               "will reload them)", new_version, len(successes),
                               len(self.addresses), missed)
            else:
                logger.info("weights updated to v%d on %d servers", new_version, len(successes))
            return new_version

    def _probe_backend(self, addr: str) -> dict:
        """The checker's probe: GET /health within the probe timeout."""
        status, health = exchange(addr, "/health", method="GET",
                                  timeout=self.config.health_probe_timeout)
        if status != 200:
            raise RuntimeError(f"GET {addr}/health -> HTTP {status}")
        # the role rides the probe: a backend restarted in another role is
        # re-pooled within one sweep
        if health.get("role"):
            self._roles[addr] = str(health["role"])
        return health

    def _poll_decode_occupancy(self) -> None:
        """The decode pool's placement signal: each decode server's occupied
        slots over its slots, from its /metrics."""
        while not self._stop.wait(self.config.occupancy_poll_interval):
            for addr in [a for a in self.addresses if self._roles.get(a) == "decode"]:
                try:
                    status, m = exchange(addr, "/metrics", method="GET", timeout=2)
                except TRANSPORT_ERRORS:
                    continue  # unreachable: no information
                total = sum(m.get("tier_slots") or []) if status == 200 else 0
                if total:
                    self._decode_occ[addr] = float(sum(m.get("tier_occupancy") or [])) / total

    def _verify_rejoin(self, addr: str, health: dict) -> bool:
        """The gate of half_open -> closed: a backend that answers after
        its death may serve stale weights.  Behind the fleet's version, it
        is reloaded from the last disk publish first; False keeps it open
        until the next probe tries again."""
        served = int(health.get("version", -1))
        with self._lock:
            fleet = self.version
            last = self._last_publish
        if served >= fleet:
            return True
        if last is None:
            # no disk publish on record (a transfer fleet, or none yet):
            # admit it; the trainer's next transfer publish catches it up
            logger.warning("rejoining %s serves v%d < fleet v%d but no publish path is "
                           "recorded; admitting as-is", addr, served, fleet)
            return True
        try:
            result = self._one_post(addr, "/update_weights_from_disk",
                                    {"path": last[0], "version": fleet})
        except Exception as e:  # noqa: BLE001 — any failure blocks the rejoin
            logger.warning("rejoin reload of %s failed: %r", addr, e)
            return False
        reloaded = int(result.get("version", -1))
        logger.info("rejoining %s: force-reloaded v%d -> v%d (fleet v%d)", addr, served,
                    reloaded, fleet)
        return reloaded >= fleet

    def _poll_backend_versions(self) -> None:
        """Without a watcher: a transfer commit bumps each server's served
        version (its /health reports it), so adopting the fleet's newest
        keeps the gate's budget moving when no /set_version comes."""
        while not self._stop.wait(self.config.version_poll_interval):
            try:
                newest = max((self._served_version(a) for a in self.addresses), default=0)
                with self._lock:
                    if newest > self.version:
                        logger.info("adopting fleet version v%d from backend health "
                                    "(transfer publish)", newest)
                        self.version = newest
            except Exception:  # noqa: BLE001 — the poller must outlive a blip
                logger.exception("backend version poll failed")

    @staticmethod
    def _served_version(addr: str) -> int:
        try:
            return int(exchange(addr, "/health", method="GET", timeout=5)[1].get("version", 0))
        except Exception:  # noqa: BLE001 — unreachable = no information
            return 0

    def _watch_checkpoints(self) -> None:
        """Poll name_resolve for trainer publishes newer than the fleet's
        version and flush them in (the reference's check_new_params)."""
        root = names.update_weights_from_disk(self.config.experiment_name,
                                              self.config.trial_name, "").rstrip("/")
        while not self._stop.is_set():
            try:
                new = [int(v) for k in name_resolve.find_subtree(root)
                       if (v := k.rsplit("/", 1)[-1]).isdigit() and int(v) > self.version]
                if new:
                    version = max(new)
                    self._flush_and_update(f"{self.config.weights_path}/v{version}", version)
            except Exception:  # noqa: BLE001 — the watcher must outlive a blip
                logger.exception("checkpoint watcher iteration failed")
            self._stop.wait(self.config.poll_interval)

    # ----------------------------- wiring -------------------------------

    def _spawn(self, fn: Callable[[], None], name: str) -> None:
        t = threading.Thread(target=fn, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def start(self) -> None:
        """Discover the backends (unless given), start the health checker,
        and the watcher or the version poller."""
        if not self.addresses:
            self.addresses = self._discover()
        self._inflight = {a: 0 for a in self.addresses}
        self._routed = {a: 0 for a in self.addresses}
        self._tokens = {a: 0 for a in self.addresses}
        self._health = BackendHealthChecker(
            self.addresses, self._probe_backend,
            failure_threshold=self.config.health_failure_threshold,
            interval=self.config.health_check_interval,
            on_death=self._on_backend_death, verify_rejoin=self._verify_rejoin)
        self._health.start()
        if self.config.disagg:
            # know the roles before the first /generate (the probes keep
            # them fresh afterwards)
            for a in self.addresses:
                try:
                    self._probe_backend(a)
                except Exception:  # noqa: BLE001 — not up yet: the probe thread retries
                    continue
            if self.config.occupancy_poll_interval > 0:
                self._spawn(self._poll_decode_occupancy, "decode-occupancy-poller")
            logger.info("disaggregated serving on: roles %s",
                        {a: self._roles.get(a, "?") for a in self.addresses})
        if self.config.weights_path and self.config.experiment_name:
            self._spawn(self._watch_checkpoints, "checkpoint-watcher")
        elif self.config.train_batch_size > 0 and self.config.version_poll_interval > 0:
            # the gate with no disk watcher (a transfer fleet) needs some
            # version source, or admission wedges
            self._spawn(self._poll_backend_versions, "version-poller")
        logger.info("router over %d servers: %s", len(self.addresses), self.addresses)

    def _discover(self, timeout: float = 300.0) -> List[str]:
        key = names.gen_servers(self.config.experiment_name, self.config.trial_name)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            found = name_resolve.get_subtree(key)
            if found:
                return sorted(found)
            time.sleep(0.5)
        raise TimeoutError(f"no generation servers under {key}")

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()
        if self._health is not None:
            self._health.stop()


class _Handler(BaseHTTPRequestHandler):
    server: "RouterHTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # access logs go to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply(self, status: int, payload: Union[dict, str]) -> None:
        if isinstance(payload, str):
            data, ctype = payload.encode(), "text/plain; version=0.0.4; charset=utf-8"
        else:
            data, ctype = json.dumps(payload).encode(), "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        router = self.server.router
        url = urlsplit(self.path)
        try:
            if url.path == "/health":
                self._reply(*router.health())
            elif url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [None])[0]
                self._reply(*router.metrics(
                    telemetry.wants_prometheus(fmt, self.headers.get("Accept", ""))))
            else:
                self._reply(404, {"error": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 — the failure goes to the client as a 500
            logger.warning("%s failed: %r", self.path, e)
            self._reply(500, {"error": f"{self.path} failed: {e}"})

    def do_POST(self):
        router = self.server.router
        routes = {
            "/generate": router.generate,
            "/generate_batch": router.generate_batch,
            "/allocate_request": router.allocate_request,
            "/finish_request": router.finish_request,
            "/update_weights": router.update_weights,
            "/set_version": router.set_version,
            "/pause_generation": router.pause,
            "/continue_generation": router.resume,
            "/drain": router.drain,
            "/undrain": router.undrain,
        }
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"malformed JSON: {e}"})
            return
        handler = routes.get(self.path)
        if handler is None:
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            self._reply(*handler(body))
        except Exception as e:  # noqa: BLE001 — the failure goes to the client as a 500
            logger.warning("%s failed: %r", self.path, e)
            self._reply(500, {"error": f"{self.path} failed: {e}"})


class RouterHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer carrying the Router its handlers use."""

    daemon_threads = True
    # a GRPO rollout opens one connection per sample: a deep listen backlog
    request_queue_size = 1024

    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 0):
        self.router = router
        super().__init__((host, port), _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve(router: Router, host: str = "0.0.0.0", port: int = 0,
          on_ready: Optional[Callable[[RouterHTTPServer], None]] = None) -> None:
    """Blocking serve: start the router, bind, call `on_ready(httpd)`, and
    handle requests until `httpd.shutdown()`; then stop the router."""
    router.start()
    try:
        with RouterHTTPServer(router, host, port) as httpd:
            logger.info("router on %s:%d", host, httpd.port)
            if on_ready is not None:
                on_ready(httpd)
            httpd.serve_forever()
    finally:
        router.stop()


def main(argv: Optional[List[str]] = None,
         on_ready: Optional[Callable[[RouterHTTPServer], None]] = None) -> None:
    """`python -m areal_tpu_torch.gen.router`: the JAX router's flags, plus
    --host, the health checker's and the gate's timings, the handoff's
    leg-1 tokens and occupancy poll, and --exit-with-parent.
    With --experiment-name it finds the servers through name_resolve
    (``AREAL_NAME_RESOLVE``) unless --addrs names them, and registers
    itself under `names.gen_router` once it listens (the host's address
    when it binds every interface, else the one it binds); then it calls
    `on_ready(httpd)`."""
    name_resolve.reconfigure_from_env()
    p = argparse.ArgumentParser()
    p.add_argument("--experiment-name", default="")
    p.add_argument("--trial-name", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--addrs", default="", help="comma-separated backend addrs "
                   "(default: discover through name_resolve)")
    p.add_argument("--schedule-policy", default="least_requests")
    p.add_argument("--train-batch-size", type=int, default=0)
    p.add_argument("--max-head-offpolicyness", type=int, default=0)
    p.add_argument("--weights-path", default="")
    p.add_argument("--poll-interval", type=float, default=1.0,
                   help="seconds between the checkpoint watcher's polls")
    p.add_argument("--health-check-interval", type=float, default=5.0)
    p.add_argument("--health-failure-threshold", type=int, default=3)
    p.add_argument("--health-probe-timeout", type=float, default=2.0)
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode serving: /generate as a prefill "
                        "leg, a K/V handoff and a decode leg when both role pools exist")
    p.add_argument("--handoff-max-inflight", type=int, default=4)
    p.add_argument("--exit-with-parent", action="store_true",
                   help="exit when the process that started this one is gone")
    args = p.parse_args(argv)
    if args.exit_with_parent:
        exit_with_parent(os.getppid())
    cfg = RouterConfig(
        experiment_name=args.experiment_name, trial_name=args.trial_name,
        schedule_policy=args.schedule_policy, train_batch_size=args.train_batch_size,
        max_head_offpolicyness=args.max_head_offpolicyness, weights_path=args.weights_path,
        poll_interval=args.poll_interval,
        health_check_interval=args.health_check_interval,
        health_failure_threshold=args.health_failure_threshold,
        health_probe_timeout=args.health_probe_timeout, disagg=args.disagg,
        handoff_max_inflight=args.handoff_max_inflight)
    router = Router(cfg, addresses=args.addrs.split(",") if args.addrs else None)

    def register(httpd: RouterHTTPServer) -> None:
        if args.experiment_name:
            name_resolve.add(names.gen_router(args.experiment_name, args.trial_name),
                             f"{network.advertised_host(args.host)}:{httpd.port}",
                             replace=True)
        if on_ready is not None:
            on_ready(httpd)

    serve(router, host=args.host, port=args.port, on_ready=register)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
