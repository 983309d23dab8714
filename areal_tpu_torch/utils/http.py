"""HTTP with retry on the standard library (the port of
`areal_tpu/utils/http.py`, which is built on `aiohttp`; the card's machine
has no `aiohttp`).

Failures fall into three classes, as in the reference, and only two of
them are always safe to retry:

- *never sent* (connection refused, name resolution, a failed connect):
  the handler provably did not run, so the request is always replayed;
- *retryable status* (408/425/429/5xx): the server answered, but for 5xx
  the handler may have partly run, so only an idempotent request is
  replayed;
- *ambiguous* (read timeout, a disconnect mid-response): the request may
  have taken effect, so a non-idempotent one is not replayed.

Callers declare ``idempotent=`` honestly: `/generate` is not (slot and
version accounting per call), and the remote client runs its own failover
for it.  Other 4xx raise at once with ``.status`` set.

The calls block.  The async client (`core/remote.py`) runs them on a
thread pool of its own.
"""

import http.client
import json
import random
import socket
import time
from typing import Any, Dict, Optional, Tuple, Union

# Statuses worth retrying besides 5xx: request-timeout, too-early,
# rate-limited.  Everything else in 4xx is the caller's bug or an
# application-level rejection and must surface at once.
RETRYABLE_STATUSES = frozenset({408, 425, 429})

Body = Union[bytes, bytearray, memoryview]


def is_retryable_status(status: int) -> bool:
    return status in RETRYABLE_STATUSES or status >= 500


def _backoff(retry_delay: float, attempt: int) -> float:
    # Full jitter: uniform over [0, cap) so a killed backend's clients
    # don't re-converge on the survivor in synchronized waves.
    return random.uniform(0, retry_delay * (2**attempt))


class HttpRequestError(RuntimeError):
    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class _ConnectFailed(OSError):
    """The connection was never established: nothing was sent."""


def _never_sent(exc: BaseException) -> bool:
    """True when the request provably never reached a handler."""
    return isinstance(exc, (_ConnectFailed, ConnectionRefusedError, socket.gaierror))


def _once(addr: str, method: str, endpoint: str, body: Optional[Body],
          headers: Dict[str, str], timeout: float):
    """One request on a fresh connection -> (status, content type, body)."""
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        try:
            conn.connect()
        except OSError as e:
            raise _ConnectFailed(f"connect to {addr} failed: {e!r}") from e
        conn.request(method, endpoint, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), resp.read()
    finally:
        conn.close()


def exchange(addr: str, endpoint: str, payload: Optional[Dict[str, Any]] = None,
             method: str = "POST", timeout: float = 3600) -> Tuple[int, Dict[str, Any]]:
    """One JSON request on a fresh connection, without retry: (status,
    JSON body, or {"text": ...} when the body is not JSON) whatever the
    status.  A transport failure raises (`OSError`,
    `http.client.HTTPException`): the router proxies with it and decides
    on each failure itself."""
    body = None if method == "GET" else json.dumps(payload if payload is not None else {}).encode()
    hdrs = {} if body is None else {"Content-Type": "application/json"}
    status, ctype, raw = _once(addr, method, endpoint, body, hdrs, timeout)
    if "application/json" in ctype:
        return status, json.loads(raw)
    return status, {"text": raw.decode(errors="replace")}


def request_with_retry(
    addr: str,
    endpoint: str,
    payload: Optional[Dict[str, Any]] = None,
    method: str = "POST",
    max_retries: int = 3,
    timeout: float = 3600,
    retry_delay: float = 0.5,
    data: Optional[Body] = None,
    headers: Optional[Dict[str, str]] = None,
    idempotent: bool = True,
) -> Dict[str, Any]:
    """JSON request (default) or raw-bytes upload (`data` + `headers`) with
    retry and backoff; returns the JSON body of a 200 (or {"text": ...}).
    `timeout` bounds the connect and each socket read.  With
    ``idempotent=False`` only never-sent failures are retried; ambiguous
    failures and 5xx raise, so the caller can decide (fail over)."""
    url = f"http://{addr}{endpoint}"
    hdrs = dict(headers or {})
    if data is not None:
        body: Optional[Body] = data
        hdrs.setdefault("Content-Type", "application/octet-stream")
    elif method != "GET":
        body = json.dumps(payload if payload is not None else {}).encode()
        hdrs["Content-Type"] = "application/json"
    else:
        body = None
    last_exc: Optional[BaseException] = None
    for attempt in range(max_retries):
        try:
            status, ctype, raw = _once(addr, method, endpoint, body, hdrs, timeout)
            if status == 200:
                if "application/json" in ctype:
                    return json.loads(raw)
                return {"text": raw.decode(errors="replace")}
            last_exc = HttpRequestError(
                f"{method} {url} -> HTTP {status}: {raw[:200].decode(errors='replace')}",
                status=status,
            )
            if not is_retryable_status(status) or not idempotent:
                # a non-idempotent handler ran (5xx may have side
                # effects): replaying it is the caller's decision
                raise last_exc
        except (OSError, http.client.HTTPException) as e:
            last_exc = e
            if not idempotent and not _never_sent(e):
                raise HttpRequestError(
                    f"{method} {url} failed ambiguously "
                    f"(non-idempotent, not retried): {e!r}"
                ) from e
        if attempt < max_retries - 1:
            time.sleep(_backoff(retry_delay, attempt))
    raise HttpRequestError(
        f"request to {url} failed after {max_retries} attempts: {last_exc!r}",
        status=getattr(last_exc, "status", None),
    ) from last_exc


def post_bytes_with_retry(
    addr: str,
    endpoint: str,
    data: Body,
    headers: Optional[Dict[str, str]] = None,
    max_retries: int = 3,
    timeout: float = 3600,
    retry_delay: float = 0.5,
    idempotent: bool = True,
) -> Dict[str, Any]:
    """POST a raw `application/octet-stream` body (the weight-chunk path:
    metadata in X-Weight-* headers, no base64, no JSON per chunk)."""
    return request_with_retry(
        addr, endpoint, method="POST", max_retries=max_retries, timeout=timeout,
        retry_delay=retry_delay, data=data, headers=headers, idempotent=idempotent)
