"""Distributed key-value rendezvous, "name resolve" (the port's copy of
`areal_tpu/utils/name_resolve.py`).

Two backends: the in-process memory store (tests, one process) and NFS,
where every key is a file under a root on a filesystem the fleet shares
(`ENTRY` in the key's directory, written to a temporary file and renamed).
`reconfigure_from_env` picks the backend from ``AREAL_NAME_RESOLVE``
(``memory`` or ``nfs:<root>``), which the launcher passes to every process
it starts.  Left out: the ``http`` backend, which rides the JAX package's
aiohttp key-value service for fleets of several hosts (`reconfigure` raises
for it, as it does for etcd3).
"""


import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from abc import ABC, abstractmethod
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.api.config import NameResolveConfig

logger = logging.getLogger("areal_tpu_torch.name_resolve")


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository(ABC):
    @abstractmethod
    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ): ...

    @abstractmethod
    def get(self, name: str) -> str: ...

    @abstractmethod
    def get_subtree(self, name_root: str) -> List[str]: ...

    @abstractmethod
    def find_subtree(self, name_root: str) -> List[str]: ...

    @abstractmethod
    def delete(self, name: str): ...

    @abstractmethod
    def clear_subtree(self, name_root: str): ...

    @abstractmethod
    def reset(self): ...

    # --- shared conveniences ---
    def add_subentry(self, name: str, value: str, **kwargs) -> str:
        sub = f"{name}/{uuid.uuid4().hex[:8]}"
        self.add(sub, value, **kwargs)
        return sub

    def wait(
        self,
        name: str,
        timeout: Optional[float] = None,
        poll_frequency: float = 0.1,
    ) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"name_resolve.wait({name!r}) timed out")
                time.sleep(poll_frequency)

    def watch_names(
        self,
        names: List[str],
        call_back: Callable[[], None],
        poll_frequency: float = 2.0,
        wait_timeout: float = 300.0,
    ) -> threading.Thread:
        """Fire `call_back` once any watched name disappears (reference:
        name_resolve.py:141-181 — used for peer-death detection)."""

        def _watch():
            try:
                for n in names:
                    self.wait(n, timeout=wait_timeout, poll_frequency=poll_frequency)
            except TimeoutError:
                # a peer that never registered is as dead as one that vanished
                logger.warning("watched names %s did not appear within %ss; treating peer as dead",
                               names, wait_timeout)
                call_back()
                return
            while True:
                try:
                    for n in names:
                        self.get(n)
                except NameEntryNotFoundError:
                    call_back()
                    return
                time.sleep(poll_frequency)

        t = threading.Thread(target=_watch, daemon=True)
        t.start()
        return t


class MemoryNameRecordRepository(NameRecordRepository):
    """Process-local dict; the default for unit tests and single-process runs."""

    def __init__(self):
        self._store: Dict[str, str] = {}
        self._lock = threading.Lock()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = name.rstrip("/")
        with self._lock:
            if name in self._store and not replace:
                raise NameEntryExistsError(name)
            self._store[name] = str(value)

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            return self._store[name]

    def get_subtree(self, name_root):
        prefix = name_root.rstrip("/") + "/"
        with self._lock:
            return [
                v
                for k, v in sorted(self._store.items())
                if k.startswith(prefix) or k == name_root.rstrip("/")
            ]

    def find_subtree(self, name_root):
        prefix = name_root.rstrip("/") + "/"
        with self._lock:
            return sorted(
                k
                for k in self._store
                if k.startswith(prefix) or k == name_root.rstrip("/")
            )

    def delete(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            del self._store[name]

    def clear_subtree(self, name_root):
        prefix = name_root.rstrip("/") + "/"
        with self._lock:
            for k in [
                k
                for k in self._store
                if k.startswith(prefix) or k == name_root.rstrip("/")
            ]:
                del self._store[k]

    def reset(self):
        with self._lock:
            self._store.clear()


class NfsNameRecordRepository(NameRecordRepository):
    """Every key is a file under `record_root` on a shared filesystem.

    Works on any POSIX shared mount (NFS/GCSfuse/Lustre); atomicity via
    write-to-temp + rename (reference: name_resolve.py:282-410).
    """

    def __init__(self, record_root: str = ""):
        record_root = record_root or default_nfs_root()
        self.record_root = record_root
        self._to_delete: List[str] = []
        os.makedirs(record_root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.record_root, name.strip("/"), "ENTRY")

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        path = self._path(name)
        if os.path.exists(path) and not replace:
            raise NameEntryExistsError(name)
        # retry once: a concurrent delete() may prune our freshly-made dir
        for attempt in range(2):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
                break
            except FileNotFoundError:
                if attempt == 1:
                    raise
        with os.fdopen(fd, "w") as f:
            f.write(str(value))
        os.replace(tmp, path)
        if delete_on_exit:
            self._to_delete.append(name)

    def get(self, name):
        path = self._path(name)
        # Retry around NFS rename visibility races.
        for _ in range(2):
            try:
                with open(path) as f:
                    return f.read()
            except FileNotFoundError:
                time.sleep(0.005)
        raise NameEntryNotFoundError(name)

    def _walk(self, name_root):
        root = os.path.join(self.record_root, name_root.strip("/"))
        if not os.path.isdir(root):
            return []
        found = []
        for dirpath, _, filenames in os.walk(root):
            if "ENTRY" in filenames:
                rel = os.path.relpath(dirpath, self.record_root)
                found.append(rel.replace(os.sep, "/"))
        return sorted(found)

    def get_subtree(self, name_root):
        out = []
        for key in self._walk(name_root):
            try:
                out.append(self.get(key))
            except NameEntryNotFoundError:
                pass
        return out

    def find_subtree(self, name_root):
        return self._walk(name_root)

    def delete(self, name):
        path = self._path(name)
        if not os.path.exists(path):
            raise NameEntryNotFoundError(name)
        os.unlink(path)
        # best-effort prune of now-empty dirs; a concurrent add() may be
        # racing us between its makedirs and file write, so rmdir failures
        # (or listdir on a dir another process just removed) just stop the walk
        d = os.path.dirname(path)
        while d != self.record_root:
            try:
                if os.listdir(d):
                    break
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def clear_subtree(self, name_root):
        root = os.path.join(self.record_root, name_root.strip("/"))
        if os.path.isdir(root):
            shutil.rmtree(root, ignore_errors=True)

    def reset(self):
        for name in list(self._to_delete):
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self._to_delete.clear()


def default_nfs_root() -> str:
    """The NFS backend's root when none is named: under the temp dir."""
    return os.path.join(tempfile.gettempdir(), "areal_tpu_torch", "name_resolve")


# --- module-level singleton, mirroring the reference's module API ---
DEFAULT_REPOSITORY: NameRecordRepository = MemoryNameRecordRepository()


def reconfigure(config: NameResolveConfig):
    global DEFAULT_REPOSITORY
    if config.type == "memory":
        DEFAULT_REPOSITORY = MemoryNameRecordRepository()
    elif config.type == "nfs":
        DEFAULT_REPOSITORY = NfsNameRecordRepository(config.nfs_record_root)
    elif config.type in ("http", "etcd3"):
        raise NotImplementedError(
            f"name_resolve backend {config.type!r} is not ported: the http backend "
            "rides an aiohttp key-value service that the port does not carry; use "
            "memory (one process) or nfs:<root> (a filesystem the fleet shares)")
    else:
        raise ValueError(f"unknown name_resolve backend {config.type!r}")


def reconfigure_from_env(fallback: "NameResolveConfig" = None):
    """Pick the backend from AREAL_NAME_RESOLVE ("memory" | "nfs:<root>"),
    falling back to the given config.  Launchers set the env var so every
    spawned process (gen servers, trainers on other hosts) rendezvouses in
    the same store."""
    spec = os.environ.get("AREAL_NAME_RESOLVE", "")
    if spec.startswith("nfs:"):
        reconfigure(NameResolveConfig(type="nfs", nfs_record_root=spec[4:]))
    elif spec.startswith("http:"):
        reconfigure(NameResolveConfig(type="http"))
    elif spec == "memory":
        reconfigure(NameResolveConfig(type="memory"))
    elif fallback is not None and fallback.type != "memory":
        reconfigure(fallback)


def export_env(config: "NameResolveConfig") -> str:
    """Name `config`'s store in AREAL_NAME_RESOLVE unless the env var
    already names one, so that the processes this one spawns rendezvous
    in it too; returns the spec in force ("" = each process's own memory
    store)."""
    if not os.environ.get("AREAL_NAME_RESOLVE") and config.type == "nfs":
        os.environ["AREAL_NAME_RESOLVE"] = "nfs:" + (config.nfs_record_root
                                                     or default_nfs_root())
    return os.environ.get("AREAL_NAME_RESOLVE", "")


def add(name, value, **kwargs):
    return DEFAULT_REPOSITORY.add(name, value, **kwargs)


def add_subentry(name, value, **kwargs):
    return DEFAULT_REPOSITORY.add_subentry(name, value, **kwargs)


def get(name):
    return DEFAULT_REPOSITORY.get(name)


def get_subtree(name_root):
    return DEFAULT_REPOSITORY.get_subtree(name_root)


def find_subtree(name_root):
    return DEFAULT_REPOSITORY.find_subtree(name_root)


def wait(name, **kwargs):
    return DEFAULT_REPOSITORY.wait(name, **kwargs)


def delete(name):
    return DEFAULT_REPOSITORY.delete(name)


def clear_subtree(name_root):
    return DEFAULT_REPOSITORY.clear_subtree(name_root)


def watch_names(names, call_back, **kwargs):
    if isinstance(names, str):
        names = [names]
    return DEFAULT_REPOSITORY.watch_names(names, call_back, **kwargs)


def reset():
    return DEFAULT_REPOSITORY.reset()
