"""Reward computation off the event loop (the port's copy of
`areal_tpu/api/reward.py`).

Reward functions (sympy math verification, for one) are CPU-heavy and must
not block the rollout event loop, so they run in a shared process pool with
a timeout, retries, and a new pool when a worker dies.  A timeout or a
raising reward function scores 0, the reference's semantics; the wrapper
counts both (`timeouts`, `failures`) so a caller can refuse a run that hit
them.  The workers are spawned: they import the reward function's module
and nothing else, and never touch CUDA.
"""

import asyncio
import logging
import multiprocessing
import threading
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor
from typing import Callable, Optional

logger = logging.getLogger("areal_tpu_torch.reward")

REWARD_TIMEOUT_SECONDS = 15.0
_MAX_WORKERS = 4

_pool_lock = threading.Lock()
_pool: Optional[ProcessPoolExecutor] = None


def _new_pool() -> ProcessPoolExecutor:
    # spawn, not fork: the parent holds a CUDA context and runs threads (the
    # decode stepper, the event loop); a forked child inherits neither safely
    return ProcessPoolExecutor(
        max_workers=_MAX_WORKERS, mp_context=multiprocessing.get_context("spawn")
    )


def _get_pool() -> ProcessPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = _new_pool()
            _warm_async(_pool)
        return _pool


def _warm_async(pool: ProcessPoolExecutor) -> None:
    """Kick one noop per worker and set _pool_warm only when all complete,
    and only if `pool` is still the current pool."""
    remaining = [_MAX_WORKERS]
    lock = threading.Lock()

    def _done(fut):
        global _pool_warm
        if fut.cancelled() or fut.exception() is not None:
            return  # a dead pool's noop proves nothing
        with lock:
            remaining[0] -= 1
            if remaining[0] == 0:
                with _pool_lock:
                    if _pool is pool:
                        _pool_warm = True

    try:
        for _ in range(_MAX_WORKERS):
            pool.submit(_noop).add_done_callback(_done)
    except Exception:  # noqa: BLE001 — pool may be shutting down
        pass


def _noop() -> int:
    return 0


# set once a pool task has completed: before that, per-call timeouts get a
# bootstrap allowance (spawned workers import the reward fn's module, which
# can take longer than the steady-state timeout)
_pool_warm = False
BOOTSTRAP_TIMEOUT_SECONDS = 120.0


def prewarm_reward_pool(timeout: float = 120.0) -> None:
    """Start the spawned workers ahead of the first real reward call."""
    global _pool_warm
    pool = _get_pool()
    futs = [pool.submit(_noop) for _ in range(_MAX_WORKERS)]
    for f in futs:
        f.result(timeout=timeout)
    _pool_warm = True


def _recreate_pool():
    global _pool, _pool_warm
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown(wait=False, cancel_futures=True)
        _pool = _new_pool()
        _pool_warm = False
        pool = _pool
    _warm_async(pool)  # outside the lock
    return pool


class AsyncRewardWrapper:
    """Wraps a sync `reward_fn(...) -> float` as `await wrapper(...)`."""

    def __init__(
        self,
        reward_fn: Callable[..., float],
        timeout: float = REWARD_TIMEOUT_SECONDS,
        max_retries: int = 2,
    ):
        self.reward_fn = reward_fn
        self.timeout = timeout
        self.max_retries = max_retries
        # calls scored 0 because the reward fn timed out / raised
        self.timeouts = 0
        self.failures = 0

    async def __call__(self, *args, **kwargs) -> float:
        loop = asyncio.get_running_loop()
        for _ in range(self.max_retries):
            pool = _get_pool()
            # cold pool: allow for the spawned workers' start on the first call
            timeout = (
                self.timeout
                if _pool_warm
                else max(self.timeout, BOOTSTRAP_TIMEOUT_SECONDS)
            )
            try:
                fut = pool.submit(self.reward_fn, *args, **kwargs)
                return float(
                    await asyncio.wait_for(
                        asyncio.wrap_future(fut, loop=loop), timeout=timeout
                    )
                )
            except asyncio.TimeoutError:
                # no retry: a running pool task cannot be cancelled, so a
                # resubmit would occupy a second worker
                fut.cancel()
                self.timeouts += 1
                logger.warning("reward fn timed out after %ss; returning 0", timeout)
                return 0.0
            except BrokenExecutor:
                logger.warning("reward process pool broke; recreating")
                _recreate_pool()
            except Exception as e:  # noqa: BLE001 — a bad reward is reward 0
                self.failures += 1
                logger.warning("reward fn raised %r; returning 0", e)
                return 0.0
        self.failures += 1
        return 0.0


def shutdown_reward_pool():
    global _pool
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown(wait=False, cancel_futures=True)
            _pool = None
