"""Length bucketing (the port's copy of `areal_tpu/utils/datapack.py`
`round_up_to_bucket`)."""

from typing import Optional


def round_up_to_bucket(n: int, quantum: int, max_len: Optional[int] = None) -> int:
    """Round a length up to the next power-of-two multiple of `quantum`
    ({1,2,4,...}*quantum), capped at `max_len`.  The engine's prompt
    buckets and decode key windows ride this ladder."""
    if n <= 0:
        return quantum
    bucket = quantum
    while bucket < n:
        bucket *= 2
    if max_len is not None:
        bucket = min(bucket, max_len)
    return bucket
