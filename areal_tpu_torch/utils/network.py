"""Host and port helpers (the port's copy of `areal_tpu/utils/network.py`).

`gethostip` differs from the JAX package's in one respect: that copy asks
the routing table for the outbound interface with a UDP socket aimed at a
public address; this one opens no socket at all and returns the address
the host's name resolves to (the loopback when it resolves to nothing).
A process that binds one interface registers that interface's address
instead (`gen/server.py`, `gen/router.py`)."""

import socket
from typing import List


def gethostip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def advertised_host(bind_host: str) -> str:
    """The address a process bound to `bind_host` registers for others:
    the host's own address when it listens on every interface."""
    return gethostip() if bind_host in ("", "0.0.0.0") else bind_host


def find_free_ports(count: int, low: int = 1024, high: int = 65535) -> List[int]:
    """Reserve `count` distinct currently-free TCP ports."""
    ports: List[int] = []
    socks = []
    try:
        while len(ports) < count:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            port = s.getsockname()[1]
            if low <= port <= high and port not in ports:
                ports.append(port)
                socks.append(s)
            else:
                s.close()
    finally:
        for s in socks:
            s.close()
    return ports


def find_free_port(**kw) -> int:
    return find_free_ports(1, **kw)[0]
