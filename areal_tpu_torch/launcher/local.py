"""Local launcher: generation servers as subprocesses of this host (the
part of `areal_tpu/launcher/local.py` that the remote GRPO loop needs).

`LocalLauncher.start_gen_servers` spawns `python -m
areal_tpu_torch.gen.server` once per server with the flags of a
`GenServerConfig` (the port's counterpart of `GenServerConfig.build_cmd`),
each in a process group of its own with its output in
`log_dir/gen_server_{i}.log` and `--exit-with-parent`, so a killed
caller leaves no server behind; waits for every `/health` to answer, and
fails when a server exits or the deadline passes first; and exports the
addresses as `AREAL_LLM_SERVER_ADDRS`, where the remote client and the
trainer's transfer publish find them.  `stop_all` stops every process it
started: SIGTERM to each group, then SIGKILL after a grace period.

Left out: the trainer subprocess, the babysitting loop and the
relaunch-on-failure recovery of the reference, and allocation-mode
parsing.  All servers run on the device the caller names (on one H100,
trainer and servers share the card).
"""

import http.client
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from areal_tpu_torch.api.config import GenServerConfig

logger = logging.getLogger("areal_tpu_torch.launcher")

# the directory holding the `areal_tpu_torch` package
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_server_cmd(config: GenServerConfig, port: int,
                     device: Optional[str] = None) -> List[str]:
    """The command that starts one port server with `config`'s flags."""
    cmd = [
        sys.executable, "-m", "areal_tpu_torch.gen.server",
        f"--host={config.host}",
        f"--port={port}",
        f"--n-slots={config.max_seqs}",
        f"--max-seq-len={config.max_context_len}",
        f"--page-size={config.page_size}",
        f"--dtype={config.dtype}",
        f"--seed={config.random_seed}",
        "--exit-with-parent",
    ]
    if config.model_path:
        cmd.append(f"--model-path={config.model_path}")
    if device is not None:
        cmd.append(f"--device={device}")
    return cmd


def _healthy(addr: str) -> bool:
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=2)
    try:
        conn.request("GET", "/health")
        return conn.getresponse().status == 200
    except OSError:
        return False
    finally:
        conn.close()


class LocalLauncher:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.procs: List[subprocess.Popen] = []
        self.server_addrs: List[str] = []

    def __enter__(self) -> "LocalLauncher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()

    def _spawn(self, cmd: List[str], tag: str) -> subprocess.Popen:
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"{tag}.log")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        logger.info("spawn [%s]: %s (log: %s)", tag, " ".join(cmd), log_path)
        with open(log_path, "ab") as log_f:
            p = subprocess.Popen(cmd, env=env, cwd=_PKG_PARENT, stdout=log_f,
                                 stderr=subprocess.STDOUT, start_new_session=True)
        self.procs.append(p)
        return p

    def _log_tail(self, tag: str, n: int = 40) -> str:
        path = os.path.join(self.log_dir, f"{tag}.log")
        try:
            with open(path, errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return ""

    def start_gen_servers(self, config: GenServerConfig, n_servers: int = 1,
                          device: Optional[str] = None, timeout: float = 600.0) -> List[str]:
        """Start `n_servers` servers and wait until each answers /health;
        returns and exports their addresses.  Raises (after stopping what
        it started) when one exits or `timeout` seconds pass first."""
        started = []
        for idx in range(n_servers):
            port = config.port + idx if config.port else find_free_port()
            tag = f"gen_server_{idx}"
            started.append((tag, self._spawn(build_server_cmd(config, port, device), tag),
                            f"{config.host}:{port}"))
        deadline = time.monotonic() + timeout
        try:
            for tag, proc, addr in started:
                while not _healthy(addr):
                    if proc.poll() is not None:
                        raise RuntimeError(f"{tag} exited with {proc.returncode} before it "
                                           f"served:\n{self._log_tail(tag)}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{tag} at {addr} did not answer /health within "
                                           f"{timeout:.0f} s:\n{self._log_tail(tag)}")
                    time.sleep(0.25)
        except BaseException:
            self.stop_all()
            raise
        self.server_addrs += [addr for _, _, addr in started]
        os.environ["AREAL_LLM_SERVER_ADDRS"] = ",".join(self.server_addrs)
        return [addr for _, _, addr in started]

    def stop_all(self, grace: float = 10.0) -> None:
        """SIGTERM every process group started here, then SIGKILL what is
        still alive after `grace` seconds; forget the addresses."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        self.procs.clear()
        if self.server_addrs and os.environ.get("AREAL_LLM_SERVER_ADDRS") == ",".join(
                self.server_addrs):
            del os.environ["AREAL_LLM_SERVER_ADDRS"]
        self.server_addrs = []
