"""Named fault points for trainer-kill chaos (the port's copy of the
fault-point half of `areal_tpu/utils/faults.py`).

A fault point is a marker in a crash-critical code path:
``fault_point("train_step")`` at the end of each train step of the
example, ``fault_point("recover_mid_dump")`` between a recover dump's
staging and its atomic rename.  Arming one, in process through
`arm_fault_point` or from outside through ``AREAL_FAULT_POINTS``, makes
its Nth hit act:

- ``kill``  SIGKILL this process (no flush, no goodbye: an OOM kill or a
            lost machine);
- ``term``  SIGTERM this process (the eviction notice a scheduler sends,
            which `utils/shutdown.py PreemptionGuard` turns into a dump and
            the resume exit code at the step boundary);
- ``raise`` raise `InjectedFault` (the in-process form for unit tests).

``AREAL_FAULT_POINTS="name[@N][:action],..."`` is read lazily, at the
first hit of any point, so a launcher arms the points of a trainer it
starts through the environment alone.  An unarmed point costs a dict
lookup.  The transport fault plans of the reference (`FaultPlan`,
`FaultProxy`) are not ported.
"""

import os
import signal
import threading
import time
from typing import Dict

FAULT_POINT_ACTIONS = ("kill", "term", "raise")


class InjectedFault(RuntimeError):
    """Raised by a fault point armed with action='raise'."""


# {name: {"action": ..., "at_hit": int, "hits": int}}
_FAULT_POINTS: Dict[str, Dict] = {}
_FAULT_LOCK = threading.Lock()
_ENV_PARSED = False


def arm_fault_point(name: str, action: str = "kill", at_hit: int = 1) -> None:
    """Arm `name` to act on its `at_hit`-th hit."""
    if action not in FAULT_POINT_ACTIONS:
        raise ValueError(f"unknown fault-point action {action!r}")
    if at_hit < 1:
        raise ValueError(f"at_hit must be >= 1, got {at_hit}")
    with _FAULT_LOCK:
        _FAULT_POINTS[name] = {"action": action, "at_hit": at_hit, "hits": 0}


def reset_fault_points() -> None:
    """Disarm everything and forget the environment's parse (tests)."""
    global _ENV_PARSED
    with _FAULT_LOCK:
        _FAULT_POINTS.clear()
        _ENV_PARSED = False


def kill_trainer_at_step(step: int, start_step: int = 0) -> None:
    """Arm ``train_step`` so the process is SIGKILLed at the end of
    absolute step `step` (counted from `start_step`, the step a resumed
    run starts at)."""
    arm_fault_point("train_step", action="kill", at_hit=step - start_step + 1)


def _parse_env_fault_points() -> None:  # holds: _FAULT_LOCK
    global _ENV_PARSED
    _ENV_PARSED = True
    spec = os.environ.get("AREAL_FAULT_POINTS", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        action = "kill"
        if ":" in item:
            item, action = item.rsplit(":", 1)
        at_hit = 1
        if "@" in item:
            item, n = item.rsplit("@", 1)
            at_hit = int(n)
        if action not in FAULT_POINT_ACTIONS:
            raise ValueError(f"AREAL_FAULT_POINTS: unknown action {action!r}")
        _FAULT_POINTS[item] = {"action": action, "at_hit": at_hit, "hits": 0}


def fault_point(name: str) -> None:
    """A named crash marker: a no-op unless armed; on the armed hit it
    kills, signals or raises."""
    with _FAULT_LOCK:
        if not _ENV_PARSED:
            _parse_env_fault_points()
        entry = _FAULT_POINTS.get(name)
        if entry is None:
            return
        entry["hits"] += 1
        if entry["hits"] != entry["at_hit"]:
            return
        action = entry["action"]
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        # the signal is asynchronous: never run past the crash point
        while True:
            time.sleep(1.0)
    if action == "term":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    raise InjectedFault(name)
