"""Preemption-aware shutdown for train loops (the port's copy of
`areal_tpu/utils/shutdown.py`).

Schedulers announce an eviction with SIGTERM (operators with SIGINT) some
grace period before the SIGKILL.  `PreemptionGuard` turns that signal into
a flag the train loop polls at its step boundary; `preempt_exit` then
retreats in order:

    pause rollout submission -> park the servers' generation ->
    force-dump a recover generation -> exit(RESUME_EXIT_CODE)

`RESUME_EXIT_CODE` (75, EX_TEMPFAIL) is the contract with the launcher's
relaunch loop (`launcher/local.py`): a trainer that exits with it is
relaunched at once, without using up a crash retry, because its dump is
known to be good.  The relaunched trainer's recover load reloads the
servers' weights (aborting what they still hold) and resumes their
generation.

The guard sets a flag instead of raising from the handler: a signal
raised in the middle of a kernel launch or a dump would tear the state
the dump protects.  The second signal gets the default disposition, so a
stuck dump can still be interrupted.

`exit_with_parent` is the watch a launched process keeps on its
launcher: the process exits once the launcher is gone.
"""

import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

logger = logging.getLogger("areal_tpu_torch.shutdown")

RESUME_EXIT_CODE = 75


class PreemptionGuard:
    """SIGTERM/SIGINT -> a step-boundary flag."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._flag = threading.Event()
        self.signum: Optional[int] = None
        self._prev = {}

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        self.signum = signum
        self._flag.set()
        # a second signal kills for real instead of waiting for the dump
        signal.signal(signum, signal.SIG_DFL)
        logger.warning("received signal %d; will dump and exit at the next step boundary "
                       "(send again to kill at once)", signum)

    @property
    def requested(self) -> bool:
        return self._flag.is_set()


def preempt_exit(recover, engine, step_info, *, rollout_engines=(), dump_kwargs=None) -> None:
    """The orderly retreat; does not return.  `rollout_engines` are paused
    (no new submissions) and their servers' generation parked, best
    effort, before the force-dump, so the dumped staleness ledger is
    quiescent; `dump_kwargs` go to `recover.dump`."""
    for r in rollout_engines:
        if r is None:
            continue
        try:
            r.pause()
        except Exception as e:  # noqa: BLE001 — the retreat must not crash
            logger.warning("pause on preemption failed: %r", e)
        try:
            r.pause_generation()
        except Exception as e:  # noqa: BLE001
            logger.warning("parking generation on preemption failed: %r", e)
    path = recover.dump(engine, step_info, **(dump_kwargs or {}))
    logger.warning("preemption dump complete (%s); exiting with resume code %d", path,
                   RESUME_EXIT_CODE)
    sys.exit(RESUME_EXIT_CODE)


def exit_with_parent(ppid: int) -> None:
    """Exit this process once `ppid` is no longer its parent (the parent
    died and the process was reparented)."""
    def watch():
        while os.getppid() == ppid:
            time.sleep(1.0)
        logger.warning("parent process %d is gone; exiting", ppid)
        os._exit(0)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()
