"""Distribution summaries of latency samples (the port's copy of
`dist_summary` from `areal_tpu/obs/trace.py`, which is standard library
only).  The event-log readers and trace stitching of that module are not
ported; the port emits the same event names (`utils/telemetry.py`), which
`tests/test_lint.py` holds to the names that analyzer parses."""

import math
from typing import Dict, Iterable, Optional


def dist_summary(values: Iterable[float]) -> Optional[Dict[str, float]]:
    """{count, mean, min, p50, p90, p99, max} or None for no samples.
    Non-finite values are dropped; percentiles are linear-interpolated on
    the sorted sample."""
    vals = sorted(float(v) for v in values
                  if v is not None and math.isfinite(v))
    if not vals:
        return None

    def pct(q: float) -> float:
        if len(vals) == 1:
            return vals[0]
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    return {
        "count": len(vals),
        "mean": sum(vals) / len(vals),
        "min": vals[0],
        "p50": pct(0.50),
        "p90": pct(0.90),
        "p99": pct(0.99),
        "max": vals[-1],
    }
