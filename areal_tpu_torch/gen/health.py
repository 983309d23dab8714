"""Active health checking with a circuit breaker per backend, for the
router (the port of `areal_tpu/gen/health.py`, on a thread instead of
asyncio).

A probe thread feeds one state machine per backend, and placement reads
an immutable snapshot of who is placeable, so a dead backend leaves the
routing within about ``failure_threshold x interval`` seconds instead of
being found out request by request::

    closed ──(failure_threshold consecutive failures)──► open
    open ──(probe succeeds)──► half_open
    half_open ──(rejoin verify ok)──► closed
    half_open ──(probe/verify fails)──► open
    any ──drain()──► draining ──undrain()──► closed

`closed` is the healthy state.  `open` backends get no placements and no
fan-outs.  `half_open` means a probe answered after death: the backend
stays out of placement until ``verify_rejoin`` (the router's: the served
weight version against the fleet's, with a forced reload when it is
behind) passes, so a restarted server never serves stale weights.
`draining` is an operator's graceful removal: no new placements, but the
backend still counts as alive for fan-outs, so in-flight work and the last
weight sync complete.

Locking: `_states` is guarded by `_lock`, a leaf lock: no callback runs
while it is held (``on_death`` and ``verify_rejoin`` are called outside
it), and the router never holds its own lock across a call into this
class.  Placement reads `placeable_cache` / `alive_cache`, immutable
tuples rebuilt on every state change and swapped in one assignment, so
the hot path takes no lock.
"""

import concurrent.futures
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

logger = logging.getLogger("areal_tpu_torch.health")

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
DRAINING = "draining"

# gauge encoding of areal_router_backend_state (pinned in the schema)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2, DRAINING: 3}


@dataclass
class BackendState:
    state: str = CLOSED
    consecutive_failures: int = 0
    last_probe: float = 0.0  # time.monotonic(); 0.0 = never probed
    last_ok: float = 0.0
    version: int = -1  # weight version the backend last reported
    error: str = ""


class BackendHealthChecker:
    """The probe thread and the breaker's bookkeeping for a fixed set of
    addresses.

    ``probe(addr)`` is the router's (GET /health with a short timeout): it
    returns the backend's health payload or raises.  ``on_death(addr)`` is
    called, outside the lock, once per closed/half_open → open transition,
    so the router can evict rid affinities.  ``verify_rejoin(addr,
    health) -> bool`` gates half_open → closed.
    """

    _GUARDED_FIELDS = {"_states": "_lock"}

    def __init__(
        self,
        addresses: Sequence[str],
        probe: Callable[[str], dict],
        *,
        failure_threshold: int = 3,
        interval: float = 5.0,
        on_death: Optional[Callable[[str], None]] = None,
        verify_rejoin: Optional[Callable[[str, dict], bool]] = None,
    ):
        self._lock = threading.Lock()
        self._states: Dict[str, BackendState] = {addr: BackendState() for addr in addresses}
        self._probe = probe
        self._failure_threshold = max(1, failure_threshold)
        self._interval = interval
        self._on_death = on_death
        self._verify_rejoin = verify_rejoin
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # immutable placement views, swapped on every state change; readers
        # take no lock (a reference read is atomic in CPython)
        self.placeable_cache: Tuple[str, ...] = tuple(addresses)
        self.alive_cache: Tuple[str, ...] = tuple(addresses)

    # --- lifecycle ---

    def start(self) -> None:
        if self._thread is None and self._interval > 0:
            self._stop.clear()
            self._thread = threading.Thread(target=self._probe_loop, daemon=True,
                                            name="health-probe")
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_now()
            except Exception:  # noqa: BLE001 — the loop must outlive a failed sweep
                logger.exception("health probe sweep failed")
            self._stop.wait(self._interval)

    def probe_now(self) -> None:
        """One probe sweep over every backend, concurrently."""
        with self._lock:
            addrs = list(self._states)
        if not addrs:
            return
        with concurrent.futures.ThreadPoolExecutor(len(addrs)) as pool:
            for f in [pool.submit(self._probe_one, a) for a in addrs]:
                try:
                    f.result()
                except Exception:  # noqa: BLE001 — one backend's sweep never stops the rest
                    logger.exception("probe sweep of a backend failed")

    # --- probe + breaker transitions ---

    def _probe_one(self, addr: str) -> None:
        try:
            health = self._probe(addr)
        except Exception as e:  # noqa: BLE001 — any probe failure counts
            with self._lock:
                st = self._states.get(addr)
                if st is not None:
                    st.last_probe = time.monotonic()
            self.report_failure(addr, repr(e))
            return

        rejoining = False
        with self._lock:
            st = self._states.get(addr)
            if st is None:
                return
            now = time.monotonic()
            st.last_probe = now
            st.last_ok = now
            st.error = ""
            st.version = int(health.get("version", st.version))
            if st.state == CLOSED:
                st.consecutive_failures = 0
            elif st.state == OPEN:
                # answered after death: a candidate, but re-admission waits
                # for the rejoin check (stale weights must not place)
                st.state = HALF_OPEN
                rejoining = True
                self._rebuild_cache_locked()
            elif st.state == HALF_OPEN:
                rejoining = True
            # DRAINING: record the probe, never change state on our own

        if rejoining:
            self._complete_rejoin(addr, health)

    def _complete_rejoin(self, addr: str, health: dict) -> None:
        ok = True
        if self._verify_rejoin is not None:
            try:
                ok = bool(self._verify_rejoin(addr, health))
            except Exception as e:  # noqa: BLE001 — a failed check blocks the rejoin
                logger.warning("rejoin verify for %s raised: %r", addr, e)
                ok = False
        with self._lock:
            st = self._states.get(addr)
            if st is None or st.state != HALF_OPEN:
                return
            if ok:
                st.state = CLOSED
                st.consecutive_failures = 0
                logger.info("backend %s rejoined the fleet", addr)
            else:
                st.state = OPEN
                st.consecutive_failures = self._failure_threshold
                st.error = "rejoin verification failed"
            self._rebuild_cache_locked()

    def report_failure(self, addr: str, error: str = "") -> None:
        """Count a probe or request failure against `addr`; the breaker
        opens at `failure_threshold` consecutive failures (at once when the
        backend was half-open)."""
        died = False
        with self._lock:
            st = self._states.get(addr)
            if st is None or st.state == DRAINING:
                return
            st.consecutive_failures += 1
            st.error = error
            if st.state == HALF_OPEN or (
                    st.state == CLOSED and st.consecutive_failures >= self._failure_threshold):
                st.state = OPEN
                died = True
                self._rebuild_cache_locked()
        if died:
            logger.warning("backend %s declared dead: %s", addr, error)
            if self._on_death is not None:
                self._on_death(addr)

    def report_success(self, addr: str) -> None:
        """A proxied request succeeded.  Only resets the failure streak of
        a closed backend: recovery from open goes through the probe and
        the rejoin check, so stale weights never slip back in."""
        with self._lock:
            st = self._states.get(addr)
            if st is not None and st.state == CLOSED:
                st.consecutive_failures = 0
                st.last_ok = time.monotonic()
                st.error = ""

    # --- operator drain ---

    def drain(self, addr: str) -> bool:
        with self._lock:
            st = self._states.get(addr)
            if st is None:
                return False
            st.state = DRAINING
            self._rebuild_cache_locked()
            return True

    def undrain(self, addr: str) -> bool:
        with self._lock:
            st = self._states.get(addr)
            if st is None or st.state != DRAINING:
                return False
            st.state = CLOSED
            st.consecutive_failures = 0
            self._rebuild_cache_locked()
            return True

    # --- views ---

    def _rebuild_cache_locked(self) -> None:  # holds: _lock
        self.placeable_cache = tuple(a for a, s in self._states.items() if s.state == CLOSED)
        # alive = answers HTTP: everything not tripped open.  Draining
        # backends stay in fan-outs (they must receive the last publishes)
        # but not in placement; half-open ones are in neither until the
        # rejoin check passes.
        self.alive_cache = tuple(a for a, s in self._states.items()
                                 if s.state in (CLOSED, DRAINING))

    def snapshot(self) -> Dict[str, dict]:
        """The cached state, for the router's /health: issues no probe."""
        now = time.monotonic()
        with self._lock:
            return {
                addr: {
                    "state": st.state,
                    "consecutive_failures": st.consecutive_failures,
                    "version": st.version,
                    "age_s": round(now - st.last_probe, 3) if st.last_probe > 0 else None,
                    "error": st.error,
                }
                for addr, st in self._states.items()
            }
