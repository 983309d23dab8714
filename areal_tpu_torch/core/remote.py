"""HTTP client of remote generation servers (the port of
`areal_tpu/core/remote.py RemoteInfEngine`, on the standard library).

- Discovery: an explicit address list, the `AREAL_LLM_SERVER_ADDRS`
  environment variable (comma-separated host:port) that the launch helper
  (`launcher/local.py`) exports, or the servers registered in
  name_resolve under the config's experiment and trial
  (`names.gen_servers`), polled until `setup_timeout`.  A router found
  through ``AREAL_GEN_ROUTER_ADDR`` or name_resolve (`names.gen_router`)
  turns on the fleet-wide staleness gate (`FleetStalenessGate`): every
  episode of the executor takes one of the router's leases.
- Scheduling: round-robin or least-inflight, with rid (or GRPO group)
  affinity and failover: a server that failed mid-request is kept out of
  re-placement for `failover_cooldown` seconds, and every affinity pinned
  to it moves.
- The interruption loop of `agenerate`: when a server stops a request
  early ("abort" on a weight update, or a chunk cap), the client resubmits
  with the accumulated tokens as the new prompt, the same sampler
  `stream_id` and the budget that is left; every token of a response is
  stamped with the response's `version`, as the reference does.  An HTTP
  failure (a 500 from a failed decode step, a dead server) counts a
  failover; after `failover_retries` the trajectory is lost
  (`TrajectoryLostError`, which the executor settles and counts).
- Weight updates, pause and continue fan out to every server; a fan-out
  that reaches no server raises, and the servers a fan-out missed count in
  `areal_train_publish_partial_failures_total`.
- Telemetry: failover resubmits count in
  `areal_client_resubmissions_total` (and those that warm-started from the
  new server's prefix cache in `areal_client_resubmit_cache_hits_total`);
  with telemetry on, the loop emits `rollout_submit`, `resume`,
  `resubmit`, `resubmit_cache_hit`, `rollout_lost` and `gen_done` events
  under the request's trace id, which travels on the wire.

`http.client` blocks, and each `/generate` call blocks until its request
finishes, so the calls run on a thread pool of the client's own, sized
for the executor's concurrency: asyncio's default pool has `min(32, cpus +
4)` workers and would cap the rollouts in flight without an error.

The gate's calls run on the same pool.
"""

import asyncio
import concurrent.futures
import functools
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Protocol

from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.engine import InferenceEngine
from areal_tpu_torch.api.io_struct import (
    HttpGenerationResult,
    HttpRequest,
    ModelRequest,
    ModelResponse,
    WeightUpdateMeta,
    WeightUpdateRequests,
)
from areal_tpu_torch.core.executor import TrajectoryLostError, WorkflowExecutor
from areal_tpu_torch.utils import name_resolve, names, telemetry
from areal_tpu_torch.utils.http import HttpRequestError, exchange, request_with_retry

logger = logging.getLogger("areal_tpu_torch.remote")

RID_CACHE_SIZE = 128
# /generate calls one rollout may have in flight at once (a GRPO group's
# siblings); the pool starts its threads on demand, so the cap costs
# nothing until the calls are there
REQUESTS_PER_ROLLOUT = 16


class FleetStalenessGate:
    """The client of the router's fleet-wide staleness gate.

    N clients of one fleet share one staleness budget (the reference's
    `GserverManager.is_staled`), not N local ones.  `allocate` polls
    `/allocate_request` until the router grants a lease (409: the fleet is
    staleness-bound, counted in `n_staled`); `finish` returns the lease
    through `/finish_request`.  After `max_failures` failed calls in a row
    the gate degrades to a no-op, so the rollout falls back to the local
    StalenessManager instead of deadlocking; a lease already granted is
    still returned.  The calls run on `pool`, the client's threads.
    """

    def __init__(self, router_addr: str, pool: concurrent.futures.Executor,
                 poll_interval: float = 0.5, max_failures: int = 5):
        self.router_addr = router_addr
        self.poll_interval = poll_interval
        self.max_failures = max_failures
        self.n_staled = 0  # 409s received (the rollout loop's thread only)
        self._pool = pool
        self._failures = 0
        self._disabled = False

    async def _post(self, endpoint: str, payload: dict):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, functools.partial(
            exchange, self.router_addr, endpoint, payload, timeout=60.0))

    async def allocate(self, qid: str) -> Optional[str]:
        """Wait until the fleet grants an admission; the lease id (None
        when the gate is off or unreachable)."""
        while not self._disabled:
            try:
                status, out = await self._post("/allocate_request", {"qid": qid})
                if status == 200:
                    self._failures = 0
                    return out.get("alloc_id")
                if status != 409:
                    raise RuntimeError(f"allocate -> HTTP {status}")
                # staleness-bound: the router answers, so no failure
                self._failures = 0
                self.n_staled += 1
            except Exception as e:  # noqa: BLE001 — degrade, never deadlock
                self._failures += 1
                if self._failures >= self.max_failures:
                    logger.warning("fleet staleness gate unreachable (%s); falling back to "
                                   "the local StalenessManager", e)
                    self._disabled = True
                    return None
            await asyncio.sleep(self.poll_interval)
        return None

    async def finish(self, alloc_id: Optional[str], accepted: bool) -> None:
        # a known lease goes back even after the gate degraded: left to the
        # TTL it would hold a fleet admission for up to an hour
        if alloc_id is None:
            return
        try:
            status, _ = await self._post("/finish_request",
                                         {"alloc_id": alloc_id, "accepted": accepted})
            if status != 200:
                raise RuntimeError(f"finish -> HTTP {status}")
        except Exception as e:  # noqa: BLE001 — the router's TTL reclaims the lease
            logger.warning("finish_request failed (lease will expire): %s", e)


class RemoteInfBackendProtocol(Protocol):
    """Builds and parses the HTTP wire format of a server family."""

    def build_generation_request(self, req: ModelRequest) -> HttpRequest: ...

    def parse_generation_response(self, resp: Dict[str, Any]) -> HttpGenerationResult: ...

    def build_pause_request(self) -> HttpRequest: ...

    def build_resume_request(self) -> HttpRequest: ...

    def build_weight_update_requests(self, meta: WeightUpdateMeta) -> WeightUpdateRequests: ...


class RemoteInfEngine(InferenceEngine):
    """Client of N generation servers; owns the WorkflowExecutor."""

    def __init__(self, config: InferenceEngineConfig, backend: RemoteInfBackendProtocol):
        self.config = config
        self.backend = backend
        self.addresses: List[str] = []
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=(config.max_concurrent_rollouts or 64) * REQUESTS_PER_ROLLOUT,
            thread_name_prefix="remote-http")
        # scheduling and version state, shared between the rollout event
        # loop and the trainer's thread
        self._lock = threading.Lock()
        self._server_idx = 0  # guarded-by: _lock
        self._version = 0  # guarded-by: _lock
        self._rid_to_addr: "OrderedDict[str, str]" = OrderedDict()  # guarded-by: _lock
        self._inflight: Dict[str, int] = {}  # guarded-by: _lock
        # addr -> monotonic time of its last failure
        self._failed: Dict[str, float] = {}  # guarded-by: _lock

        self.executor = WorkflowExecutor(config, inference_engine=self)

    # --- lifecycle / discovery ---
    def initialize(self, addr: Optional[str | List[str]] = None,
                   train_data_parallel_size: Optional[int] = None):
        if addr:
            self.addresses = [addr] if isinstance(addr, str) else list(addr)
        else:
            self.addresses = self._discover_servers()
        if not self.addresses:
            raise RuntimeError("no generation servers found")
        with self._lock:
            self._inflight = {a: 0 for a in self.addresses}
        logger.info("remote engine using servers: %s", self.addresses)
        router_addr = self._discover_router()
        if router_addr:
            logger.info("fleet staleness gate via the router at %s", router_addr)
            self.executor.fleet_gate = FleetStalenessGate(router_addr, self._pool)
        self.executor.initialize()

    def _discover_router(self) -> Optional[str]:
        """The router, if the fleet has one: `AREAL_GEN_ROUTER_ADDR`, then
        name_resolve, without waiting.  A registered router means this
        client may be one of many on the fleet, so admission is gated
        fleet-wide."""
        env = os.environ.get("AREAL_GEN_ROUTER_ADDR")
        if env:
            return env
        try:
            return name_resolve.get(names.gen_router(self.config.experiment_name,
                                                     self.config.trial_name))
        except name_resolve.NameEntryNotFoundError:
            return None

    def _discover_servers(self) -> List[str]:
        env = os.environ.get("AREAL_LLM_SERVER_ADDRS")
        if env:
            return [a for a in env.split(",") if a]
        key = names.gen_servers(self.config.experiment_name, self.config.trial_name)
        deadline = time.monotonic() + self.config.setup_timeout
        while time.monotonic() < deadline:
            found = name_resolve.get_subtree(key)
            if found:
                return sorted(found)
            time.sleep(0.5)
        raise TimeoutError(f"no generation servers registered under {key} within "
                           f"{self.config.setup_timeout}s")

    def destroy(self):
        self.executor.destroy()
        self._pool.shutdown(wait=False, cancel_futures=True)

    # --- versioning ---
    def set_version(self, version: int):
        with self._lock:
            self._version = version

    def get_version(self) -> int:
        with self._lock:
            return self._version

    # --- scheduling ---
    def _choose_locked(self) -> str:  # holds: _lock
        if self.config.schedule_policy == "least_requests":
            inflight = self._inflight
            return min(self.addresses, key=lambda a: inflight.get(a, 0))
        addr = self.addresses[self._server_idx % len(self.addresses)]
        self._server_idx += 1
        return addr

    def _pin_locked(self, key: str, addr: str) -> None:  # holds: _lock
        if len(self._rid_to_addr) >= RID_CACHE_SIZE:
            self._rid_to_addr.popitem(last=False)
        self._rid_to_addr[key] = addr

    def _server_for_rid(self, rid: str) -> str:
        # one critical section: lookup-miss -> choose -> insert must be
        # atomic, or two threads racing on one rid pin it to two servers
        with self._lock:
            if rid in self._rid_to_addr:
                self._rid_to_addr.move_to_end(rid)
                return self._rid_to_addr[rid]
            addr = self._choose_locked()
            self._pin_locked(rid, addr)
            return addr

    def _failover_server(self, dead: str, key: str) -> str:
        """Re-place `key` (group id or rid) after `dead` failed mid-request:
        mark the failure, evict every affinity pinned to the dead server,
        and pin the key to a server that has not failed within the
        cooldown.  When every server is cooling down, place anyway."""
        now = time.monotonic()
        with self._lock:
            self._failed[dead] = now
            for r in [r for r, a in self._rid_to_addr.items() if a == dead]:
                del self._rid_to_addr[r]
            cooldown = self.config.failover_cooldown
            pool = [a for a in self.addresses
                    if (t := self._failed.get(a)) is None or now - t > cooldown] or self.addresses
            if self.config.schedule_policy == "least_requests":
                inflight = self._inflight
                addr = min(pool, key=lambda a: inflight.get(a, 0))
            else:
                addr = pool[self._server_idx % len(pool)]
                self._server_idx += 1
            if key:
                self._pin_locked(key, addr)
            return addr

    async def _call(self, fn: Callable, *args, **kwargs):
        """Run a blocking HTTP call on the client's pool."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, functools.partial(fn, *args, **kwargs))

    # --- generation with the interruption loop ---
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        req = req.copy()
        if not req.trace_id:
            req.trace_id = req.rid
        gconfig = req.gconfig
        if gconfig.n_samples != 1:
            raise ValueError("agenerate handles a single sample; issue n_samples calls")
        max_new = gconfig.max_new_tokens
        if max_new <= 0:
            raise RuntimeError(f"max_new_tokens={max_new} must be positive")

        # a GRPO group's siblings share a server; the group key (when
        # declared) outranks the per-request rid
        addr = self._server_for_rid(req.group_id or req.rid)
        if telemetry.is_enabled():
            telemetry.emit("rollout_submit", trace_id=req.trace_id, rid=req.rid,
                           group_id=req.group_id, input_len=len(req.input_ids), server=addr)
        attempt = 0
        resubmitted = False  # the next /generate is a failover resubmit
        failovers = 0
        start = time.perf_counter()
        out_tokens: List[int] = []
        out_logprobs: List[float] = []
        out_versions: List[int] = []
        input_len = len(req.input_ids)
        stop_reason = None
        ttft = float("inf")
        # the first response pins the counter-keyed sampler stream; resumes
        # and failover resubmits pass it back, so the continuation samples
        # the keys the uninterrupted run would have used
        stream_id = 0
        while stop_reason not in ("stop", "length", "tool_calls") and len(out_tokens) < max_new:
            # back off while the client is paused for a weight update
            while self.executor.is_paused():
                await asyncio.sleep(0.25)
            attempt += 1
            if attempt > 1 and telemetry.is_enabled():
                # a resume after an interruption: the accumulated tokens
                # travel back as the new prompt
                telemetry.emit("resume", trace_id=req.trace_id, attempt=attempt,
                               generated=len(out_tokens), prompt_len=len(req.input_ids))
            http_req = self.backend.build_generation_request(req)
            if stream_id:
                http_req.payload["stream_id"] = stream_id
            next_addr: Optional[str] = None
            with self._lock:
                self._inflight[addr] = self._inflight.get(addr, 0) + 1
            try:
                # /generate is not idempotent: the helper replays only
                # never-sent failures; the rest fails over below, which
                # resubmits with the accumulated tokens
                raw = await self._call(
                    request_with_retry, addr, http_req.endpoint, payload=http_req.payload,
                    method=http_req.method, max_retries=self.config.request_retries,
                    timeout=self.config.request_timeout, idempotent=False)
            except HttpRequestError as e:
                failovers += 1
                if failovers > self.config.failover_retries:
                    if telemetry.is_enabled():
                        telemetry.emit("rollout_lost", trace_id=req.trace_id, rid=req.rid,
                                       group_id=req.group_id, server=addr,
                                       generated=len(out_tokens), failovers=failovers)
                    raise TrajectoryLostError(
                        f"rid {req.rid}: no healthy server after {failovers} failovers "
                        f"(last: {e})") from e
                next_addr = self._failover_server(addr, req.group_id or req.rid)
                logger.warning("rid %s: %s failed (%s); resubmitting to %s with %d tokens "
                               "generated", req.rid, addr, e, next_addr, len(out_tokens))
                if telemetry.is_enabled():
                    # a resubmit span under the original trace id: the
                    # trajectory survives a server's death in one trace
                    telemetry.emit("resubmit", trace_id=req.trace_id, rid=req.rid,
                                   group_id=req.group_id, from_server=addr,
                                   to_server=next_addr, generated=len(out_tokens),
                                   attempt=attempt)
                telemetry.CLIENT_RESUBMISSIONS.inc()
                resubmitted = True
            finally:
                with self._lock:
                    self._inflight[addr] = max(0, self._inflight.get(addr, 1) - 1)
            if next_addr is not None:
                addr = next_addr
                continue
            result = self.backend.parse_generation_response(raw)
            stream_id = int(raw.get("stream_id", stream_id) or stream_id)
            if resubmitted:
                # did the retried trajectory warm-start from the new
                # server's prefix cache instead of prefilling cold?
                resubmitted = False
                if result.cache_hit_tokens > 0:
                    telemetry.CLIENT_RESUBMIT_CACHE_HITS.inc()
                    if telemetry.is_enabled():
                        telemetry.emit("resubmit_cache_hit", trace_id=req.trace_id,
                                       rid=req.rid, server=addr,
                                       hit_tokens=result.cache_hit_tokens)
            stop_reason = result.stop_reason
            version = result.version if result.version >= 0 else self.get_version()
            if ttft == float("inf") and result.output_tokens:
                ttft = time.perf_counter() - start
            out_tokens.extend(result.output_tokens)
            out_logprobs.extend(result.output_logprobs)
            # every token of a response carries the response's version,
            # as in the reference (ROADMAP queue 3 records the quirk)
            out_versions.extend([version] * len(result.output_tokens))
            # interruption: resume with the accumulated tokens as prompt
            req.input_ids = req.input_ids + result.output_tokens
            req.gconfig = req.gconfig.new(max_new_tokens=max_new - len(out_tokens))
        if stop_reason in ("abort", "interrupt"):
            stop_reason = "length"  # left the loop on budget during an interruption
        if telemetry.is_enabled():
            telemetry.emit("gen_done", trace_id=req.trace_id, stop_reason=stop_reason or "length",
                           output_len=len(out_tokens), attempts=attempt,
                           latency_s=time.perf_counter() - start,
                           ttft_s=ttft if ttft != float("inf") else None)
        return ModelResponse(
            input_tokens=req.input_ids[:input_len],
            output_tokens=out_tokens,
            output_logprobs=out_logprobs,
            output_versions=out_versions,
            stop_reason=stop_reason or "length",
            latency=time.perf_counter() - start,
            ttft=ttft,
        )

    # --- weight updates ---
    def _fanout(self, build: Callable[[], WeightUpdateRequests], timeout: float) -> None:
        """Send each request to every server in parallel.  One dead server
        does not stop the others; a fan-out that reaches none raises."""
        pairs = [(a, r) for a in self.addresses for r in build().requests]
        if not pairs:
            return
        failed: Dict[str, BaseException] = {}
        # threads of its own: the control plane never queues behind rollouts
        with concurrent.futures.ThreadPoolExecutor(len(pairs)) as pool:
            futs = [pool.submit(request_with_retry, a, r.endpoint, payload=r.payload,
                                method=r.method, max_retries=self.config.request_retries,
                                timeout=timeout) for a, r in pairs]
            for (a, _), f in zip(pairs, futs):
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 — collected per server, raised below
                    failed[a] = e
        for a, exc in failed.items():
            logger.warning("control-plane fanout to %s failed: %r", a, exc)
        if failed:
            telemetry.PUBLISH_PARTIAL_FAILURES.inc(len(failed))
        if len(failed) == len(self.addresses):
            raise RuntimeError(f"control-plane fanout reached no server: {failed}")

    def pause_generation(self):
        self._fanout(lambda: WeightUpdateRequests(
            requests=[self.backend.build_pause_request()]), timeout=60.0)
        if self.config.pause_grace_period > 0:
            time.sleep(self.config.pause_grace_period)

    def continue_generation(self):
        self._fanout(lambda: WeightUpdateRequests(
            requests=[self.backend.build_resume_request()]), timeout=60.0)

    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Fan the weight-update request out to every server.  The caller
        advances the client's version with `set_version` afterwards, as in
        the reference's examples."""
        self._fanout(lambda: self.backend.build_weight_update_requests(meta),
                     timeout=self.config.request_timeout)

    # --- rollout surface: delegate to the executor ---
    def submit(self, data, workflow=None, workflow_builder=None, should_accept=None):
        self.executor.submit(data, workflow, workflow_builder, should_accept)

    def wait(self, count: int, timeout: Optional[float] = None):
        return self.executor.wait(count, timeout)

    def rollout_batch(self, data, workflow=None, workflow_builder=None, should_accept=None):
        return self.executor.rollout_batch(data, workflow, workflow_builder, should_accept)

    def prepare_batch(self, dataloader, workflow=None, workflow_builder=None,
                      should_accept=None):
        return self.executor.prepare_batch(dataloader, workflow, workflow_builder,
                                           should_accept)

    def pause(self):
        self.executor.pause()

    def resume(self):
        self.executor.resume()
