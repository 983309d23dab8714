"""Background asyncio task runner (the port's copy of
`areal_tpu/core/runner.py`).

A daemon thread owns an asyncio event loop; the main thread feeds
async-task factories through a bounded queue and collects results from an
output queue.

Lock-discipline audit (areal-lint C1): this class deliberately declares no
`_GUARDED_FIELDS` — cross-thread handoff rides the two `queue.Queue`s and
`threading.Event`s (self-synchronizing), and `_exception` is write-once before the loop exits and read only by
`health_check` afterwards.
"""

import asyncio
import logging
import queue
import threading
import time
from typing import Any, Awaitable, Callable, List, Optional

logger = logging.getLogger("areal_tpu_torch.runner")

_POLL_INTERVAL = 0.02


class TaskQueueFullError(RuntimeError):
    pass


class RunnerDeadError(RuntimeError):
    pass


class AsyncTaskRunner:
    """Runs `async def` task factories on a dedicated event-loop thread.

    Results (including raised-exception placeholders) appear on the output
    queue in completion order.  `pause()` stops *new* tasks from starting and
    is also visible to in-flight tasks via `paused` (cooperative back-off
    during weight updates).
    """

    def __init__(self, max_queue_size: int = 4096):
        self.max_queue_size = max_queue_size
        self._input: queue.Queue = queue.Queue(maxsize=max_queue_size)
        self._output: queue.Queue = queue.Queue()
        self.paused = threading.Event()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._exception: Optional[BaseException] = None
        self._started = threading.Event()

    # --- lifecycle ---
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._thread_main, daemon=True, name="async-task-runner"
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RunnerDeadError("runner event loop failed to start")

    def stop(self, timeout: float = 10.0):
        if self._thread is None:
            return
        self._shutdown.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            logger.warning("runner thread did not exit cleanly")
        self._thread = None

    def health_check(self):
        if self._exception is not None:
            raise RunnerDeadError(
                f"runner event loop died: {self._exception!r}"
            ) from self._exception
        if self._thread is not None and not self._thread.is_alive():
            raise RunnerDeadError("runner thread is not alive")

    # --- submission / collection (main thread) ---
    def submit(self, task_fn: Callable[[], Awaitable[Any]]):
        self.health_check()
        try:
            self._input.put_nowait(task_fn)
        except queue.Full:
            raise TaskQueueFullError(
                f"input queue full ({self.max_queue_size})"
            )

    def wait(self, count: int, timeout: Optional[float] = None) -> List[Any]:
        """Collect up to... exactly `count` results; raises TimeoutError with
        nothing consumed beyond what's returned."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        while len(out) < count:
            self.health_check()
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                if out:
                    # push back is impossible for a queue; return what we have
                    # via exception payload is worse — so re-queue results
                    for r in out:
                        self._output.put(r)
                raise TimeoutError(f"collected {len(out)}/{count} results")
            try:
                item = self._output.get(
                    timeout=min(0.05, remaining) if remaining is not None else 0.05
                )
            except queue.Empty:
                continue
            out.append(item)
        return out

    def get_input_queue_size(self) -> int:
        return self._input.qsize()

    def pause(self):
        self.paused.set()

    def resume(self):
        self.paused.clear()

    # --- event-loop thread ---
    def _thread_main(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._main())
        except BaseException as e:  # noqa: BLE001 — surfaced via health_check
            self._exception = e
            logger.error(f"runner loop crashed: {e!r}")
        finally:
            try:
                self._loop.close()
            except Exception:
                pass

    async def _main(self):
        self._started.set()
        pending: set = set()

        def _done(task: asyncio.Task):
            pending.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                logger.error(f"rollout task failed: {exc!r}")
                self._output.put(TaskError(exc))
            else:
                self._output.put(task.result())

        while not self._shutdown.is_set():
            launched = False
            while not self.paused.is_set():
                try:
                    fn = self._input.get_nowait()
                except queue.Empty:
                    break
                task = asyncio.ensure_future(fn())
                task.add_done_callback(_done)
                pending.add(task)
                launched = True
            await asyncio.sleep(0 if launched else _POLL_INTERVAL)
        for task in pending:
            task.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)


class TaskError:
    """Wrapper marking a failed task on the output queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc

    def __repr__(self):
        return f"TaskError({self.exc!r})"
