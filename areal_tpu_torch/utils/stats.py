"""Scoped, denominator-normalized statistics tracking (the port's copy of
`areal_tpu/utils/stats.py`, logging through the standard library).

Values are numpy arrays or floats; a CUDA tensor handed in is copied to
the host.  `PendingTrainStats` is kept for the actor's interface; the
port's engine returns plain dicts (`async_stats` is not ported).
"""

import logging
import math
import time
from collections import defaultdict
from contextlib import contextmanager
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger("areal_tpu_torch.stats")


class ReduceType(Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"


def _asarray(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class PendingTrainStats:
    """Train-step stats whose fetch is deferred (Mapping-like): reading any
    key materialises them and runs the registered finalizers."""

    def __init__(self, device_stats: Dict[str, Any], fetch: Callable):
        self._device_stats = device_stats
        self._fetch = fetch
        self._finalizers: List[Callable] = []
        self._result: Optional[Dict[str, float]] = None

    def then(self, fn: Callable) -> "PendingTrainStats":
        """Register `fn(stats_dict) -> stats_dict` to run at materialisation."""
        if self._result is not None:
            self._result = fn(self._result)
        else:
            self._finalizers.append(fn)
        return self

    def materialize(self) -> Dict[str, float]:
        if self._result is None:
            out = self._fetch(self._device_stats)
            self._device_stats = None
            for fn in self._finalizers:
                out = fn(out)
            self._finalizers = []
            self._result = out
        return self._result

    def __getitem__(self, key):
        return self.materialize()[key]

    def __contains__(self, key):
        return key in self.materialize()

    def __iter__(self):
        return iter(self.materialize())

    def __len__(self):
        return len(self.materialize())

    def keys(self):
        return self.materialize().keys()

    def values(self):
        return self.materialize().values()

    def items(self):
        return self.materialize().items()

    def get(self, key, default=None):
        return self.materialize().get(key, default)

    def pop(self, key, *default):
        return self.materialize().pop(key, *default)

    def __setitem__(self, key, value):
        self.materialize()[key] = value

    def __repr__(self):
        state = "pending" if self._result is None else repr(self._result)
        return f"PendingTrainStats({state})"


class StatsTracker:
    """Accumulates masked statistics under hierarchical scopes.

    - `denominator(name=mask)` registers boolean masks.
    - `stat(denominator="mask", key=value, ...)` records per-element values
      normalized by a mask at reduce time.
    - `scalar(key=value)` records plain scalars (averaged over records).
    - `scope(name)` nests key prefixes.
    - `export()` reduces everything to flat {key: float} and clears.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._scopes: List[str] = []
        self._denoms: Dict[str, List[np.ndarray]] = defaultdict(list)
        self._stats: Dict[str, List[tuple]] = defaultdict(list)
        self._reduce: Dict[str, ReduceType] = {}
        self._scalars: Dict[str, List[float]] = defaultdict(list)
        self._timing: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def scope(self, name: str):
        self._scopes.append(name)
        try:
            yield self
        finally:
            self._scopes.pop()

    def _key(self, key: str) -> str:
        return "/".join(p for p in ([self.name] + self._scopes + [key]) if p)

    def denominator(self, **kwargs):
        for key, mask in kwargs.items():
            arr = _asarray(mask)
            if arr.dtype != np.bool_:
                raise ValueError(f"denominator {key!r} must be boolean, got {arr.dtype}")
            self._denoms[self._key(key)].append(arr.reshape(-1))

    def stat(self, denominator: str, reduce_type: ReduceType = ReduceType.AVG, **kwargs):
        denom_key = self._key(denominator)
        if denom_key not in self._denoms:
            raise ValueError(f"unknown denominator {denominator!r}")
        for key, value in kwargs.items():
            arr = _asarray(value).astype(np.float32).reshape(-1)
            full = self._key(key)
            mask = self._denoms[denom_key][-1]
            if arr.shape != mask.shape:
                raise ValueError(
                    f"stat {key!r} shape {arr.shape} != denominator shape {mask.shape}")
            self._stats[full].append((arr, mask))
            self._reduce[full] = reduce_type

    def scalar(self, **kwargs):
        for key, value in kwargs.items():
            self._scalars[self._key(key)].append(float(value))

    @contextmanager
    def record_timing(self, key: str):
        tik = time.perf_counter()
        try:
            yield
        finally:
            self._timing[self._key(key)].append(time.perf_counter() - tik)

    def export(self, key: Optional[str] = None,
               reduce_hook: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
               reset: bool = True) -> Dict[str, float]:
        """Reduce to flat floats."""
        out: Dict[str, float] = {}
        for full, records in self._stats.items():
            if key is not None and not full.startswith(key):
                continue
            vals = np.concatenate([v for v, _ in records])
            mask = np.concatenate([m for _, m in records])
            if mask.sum() == 0:
                continue
            sel = vals[mask]
            rt = self._reduce[full]
            if rt == ReduceType.AVG:
                out[full] = float(sel.mean())
            elif rt == ReduceType.SUM:
                out[full] = float(sel.sum())
            elif rt == ReduceType.MIN:
                out[full] = float(sel.min())
            else:
                out[full] = float(sel.max())
        for full, masks in self._denoms.items():
            if key is None or full.startswith(key):
                out.setdefault(f"{full}/count", float(sum(int(m.sum()) for m in masks)))
        for full, vals in self._scalars.items():
            if key is None or full.startswith(key):
                out[full] = float(np.mean(vals))
        for full, vals in self._timing.items():
            if key is None or full.startswith(key):
                out[f"time_perf/{full}"] = float(np.sum(vals))
        if reduce_hook is not None:
            out = reduce_hook(out)
        if reset:
            stores = (self._denoms, self._stats, self._scalars, self._timing, self._reduce)
            for d in stores:
                for k in [k for k in d if key is None or k.startswith(key)]:
                    del d[k]
        return {k: (0.0 if (isinstance(v, float) and math.isnan(v)) else v)
                for k, v in out.items()}


DEFAULT_TRACKER = StatsTracker()
denominator = DEFAULT_TRACKER.denominator
stat = DEFAULT_TRACKER.stat
scalar = DEFAULT_TRACKER.scalar
scope = DEFAULT_TRACKER.scope
record_timing = DEFAULT_TRACKER.record_timing
export = DEFAULT_TRACKER.export
