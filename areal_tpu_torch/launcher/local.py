"""Local launcher: generation servers and the trainer as subprocesses of
this host (the port of `areal_tpu/launcher/local.py`).

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

`run` is the reference's relaunch loop.  It starts the servers once
(or takes those `AREAL_LLM_SERVER_ADDRS` already names) and they outlive
the trainer: the trainer is a subprocess (`start_trainer`) with
`AREAL_LLM_SERVER_ADDRS` and `AREAL_RUN_ID` in its environment, and
`_babysit` waits for it.  When it exits:

- 0: the run is done;
- `RESUME_EXIT_CODE` (75, a preemption retreat with a known-good dump):
  relaunched at once with the next run id, using up no retry;
- anything else (a crash): relaunched after `relaunch_delay` seconds with
  the next run id while `recover.mode` is `auto` or `fault`, at most
  `recover.retries` times.

The relaunched trainer finds its recover generation (`check_if_recover`)
and reloads the servers' weights at the recovered version before it
generates.  ``AREAL_FAULT_POINTS`` reaches the first launch only, so a
relaunch does not crash at the same point again.  A server that dies
ends the run (rc 1).  Each start and exit of a trainer is a JSON line in
`log_dir/launcher.jsonl` (`event`, `run_id`, `pid` or `rc`, wall-clock
`ts`), and so is each started server's last `/metrics` before the
launcher stops it.

The number of servers can come from an allocation mode
(`servers_for_allocation`: the data-parallel size of its generation part,
as the JAX launcher reads it).  Given an experiment and a trial, each
server starts with `--experiment-name`, `--trial-name` and its
`--server-idx` and registers itself in name_resolve once it listens.
Every spawned process inherits this process's environment,
``AREAL_NAME_RESOLVE`` included, so servers, router and trainer
rendezvous in one store.  All servers run on
the device the caller names (on one H100, trainer and servers share the
card).
"""

import http.client
import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from areal_tpu_torch.api.alloc import AllocationMode
from areal_tpu_torch.api.config import GenServerConfig, RecoverConfig
from areal_tpu_torch.utils.network import find_free_port
from areal_tpu_torch.utils.shutdown import RESUME_EXIT_CODE

logger = logging.getLogger("areal_tpu_torch.launcher")

RECOVER_TIME_INTERVAL = 10.0  # seconds before a crashed trainer is relaunched
# the directory holding the `areal_tpu_torch` package
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def servers_for_allocation(allocation_mode: str) -> int:
    """Generation servers an allocation mode asks for: its gen part's
    data-parallel size (1 without a gen part or a mode)."""
    if not allocation_mode:
        return 1
    alloc = AllocationMode.from_str(allocation_mode)
    return max(1, alloc.gen.dp_size) if alloc.gen is not None else 1


def build_server_cmd(config: GenServerConfig, port: int, device: Optional[str] = None,
                     experiment_name: str = "", trial_name: str = "",
                     server_idx: int = 0) -> List[str]:
    """The command that starts one port server with `config`'s flags;
    with an experiment name, the flags under which it registers."""
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
    if config.spec_decode:
        cmd.append("--spec-decode")
        if config.spec_ladder:
            cmd.append("--spec-ladder=" + ",".join(str(d) for d in config.spec_ladder))
        if config.spec_draft_len:
            cmd.append(f"--spec-draft-len={config.spec_draft_len}")
    if device is not None:
        cmd.append(f"--device={device}")
    if experiment_name:
        cmd += [f"--experiment-name={experiment_name}", f"--trial-name={trial_name}",
                f"--server-idx={server_idx}"]
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

    def _spawn(self, cmd: List[str], tag: str,
               env_extra: Optional[Dict[str, Optional[str]]] = None) -> subprocess.Popen:
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"{tag}.log")
        env = dict(os.environ)
        for k, v in (env_extra or {}).items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = v
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
                          device: Optional[str] = None, timeout: float = 600.0,
                          experiment_name: str = "", trial_name: str = "") -> List[str]:
        """Start `n_servers` servers (registered under the experiment and
        trial when given) and wait until each answers /health; returns and
        exports their addresses.  Raises (after stopping what it started)
        when one exits or `timeout` seconds pass first."""
        started = []
        for idx in range(n_servers):
            port = config.port + idx if config.port else find_free_port()
            tag = f"gen_server_{idx}"
            cmd = build_server_cmd(config, port, device, experiment_name, trial_name, idx)
            started.append((tag, self._spawn(cmd, tag), f"{config.host}:{port}"))
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

    # ------------------------------------------------------------------
    # the trainer and the relaunch loop
    # ------------------------------------------------------------------

    def _event(self, **rec) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "launcher.jsonl"), "a") as f:
            f.write(json.dumps({**rec, "ts": time.time()}) + "\n")

    def start_trainer(self, cmd: List[str], run_id: int,
                      server_addrs: List[str]) -> subprocess.Popen:
        """Spawn the trainer `cmd` with the servers' addresses and its run
        id; the fault points of the environment reach run 0 only."""
        env = {"AREAL_LLM_SERVER_ADDRS": ",".join(server_addrs),
               "AREAL_RUN_ID": str(run_id)}
        if run_id > 0:
            env["AREAL_FAULT_POINTS"] = None
        p = self._spawn(cmd, f"trainer_run{run_id}", env)
        self._event(event="trainer_start", run_id=run_id, pid=p.pid)
        return p

    def run(self, trainer_cmd: List[str], recover: RecoverConfig,
            server_config: Optional[GenServerConfig] = None, n_servers: int = 1,
            device: Optional[str] = None, relaunch_delay: float = RECOVER_TIME_INTERVAL,
            trainer_timeout: Optional[float] = None, setup_timeout: float = 600.0,
            experiment_name: str = "", trial_name: str = "") -> int:
        """Start the servers (unless `AREAL_LLM_SERVER_ADDRS` names them),
        then the trainer, relaunched as the module docstring says; returns
        the last trainer's exit code.  A trainer that runs longer than
        `trainer_timeout` seconds is killed (rc -9).  Stops everything it
        started before it returns."""
        run_id = int(os.environ.get("AREAL_RUN_ID", 0))
        failures = 0  # crash relaunches used; preemptions use none
        try:
            addrs = [a for a in os.environ.get("AREAL_LLM_SERVER_ADDRS", "").split(",") if a]
            if not addrs:
                if server_config is None:
                    raise ValueError("no AREAL_LLM_SERVER_ADDRS and no server_config")
                addrs = self.start_gen_servers(server_config, n_servers, device, setup_timeout,
                                               experiment_name, trial_name)
            while True:
                trainer = self.start_trainer(trainer_cmd, run_id, addrs)
                rc = self._babysit(trainer, trainer_timeout)
                self._event(event="trainer_exit", run_id=run_id, rc=rc)
                self._reap(trainer)
                if rc == 0:
                    logger.info("trainer finished")
                    return 0
                if recover.mode == "disabled" or self._server_died():
                    return rc
                run_id += 1
                if rc == RESUME_EXIT_CODE:
                    logger.warning("trainer preempted (rc %d); relaunching at once (run %d)",
                                   rc, run_id)
                    continue
                failures += 1
                if recover.mode not in ("auto", "fault") or failures > recover.retries:
                    return rc
                logger.warning("trainer exited with rc %d; relaunching (run %d) in %.1f s "
                               "[crash %d/%d]", rc, run_id, relaunch_delay, failures,
                               recover.retries)
                time.sleep(relaunch_delay)
        finally:
            self._record_server_metrics()
            self.stop_all()

    def _record_server_metrics(self) -> None:
        """Each started server's `/metrics`, best effort, as an event."""
        for addr in self.server_addrs:
            host, _, port = addr.rpartition(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            try:
                conn.request("GET", "/metrics")
                metrics = json.loads(conn.getresponse().read())
            except (OSError, ValueError):
                continue
            finally:
                conn.close()
            self._event(event="server_metrics", addr=addr, metrics=metrics)

    def _server_died(self) -> bool:
        """Did a server this launcher started exit?  (Between trainers,
        the processes left are the servers.)"""
        return any(p.poll() is not None for p in self.procs)

    def _babysit(self, trainer: subprocess.Popen, timeout: Optional[float] = None) -> int:
        """Wait for the trainer; if a server dies first, kill it and
        return 1."""
        deadline = None if timeout is None else time.monotonic() + timeout
        servers = [p for p in self.procs if p is not trainer]
        while True:
            try:
                return trainer.wait(timeout=0.1)
            except subprocess.TimeoutExpired:
                pass
            if any(p.poll() is not None for p in servers):
                logger.error("a generation server died; stopping the trainer")
                self._reap(trainer)
                return 1
            if deadline is not None and time.monotonic() > deadline:
                logger.error("the trainer ran past %.0f s; killing it", timeout)
                self._reap(trainer)
                return trainer.wait()

    def _reap(self, trainer: subprocess.Popen) -> None:
        """SIGKILL the trainer's process group (its reward workers outlive
        a killed trainer otherwise) and forget it."""
        try:
            os.killpg(trainer.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        trainer.wait()
        self.procs = [p for p in self.procs if p is not trainer]
