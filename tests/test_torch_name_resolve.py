"""The port's copy of name_resolve (`areal_tpu_torch/utils/name_resolve.py`)
against the cases of tests/test_name_resolve.py, on the memory and NFS
backends (the JAX package's http backend is not ported), plus the env
switch and the key layout shared with the JAX package's `names`."""

import os
import threading
import time

import pytest

from areal_tpu_torch.utils import name_resolve, names
from areal_tpu_torch.utils.name_resolve import (
    MemoryNameRecordRepository,
    NameEntryExistsError,
    NameEntryNotFoundError,
    NfsNameRecordRepository,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(params=["memory", "nfs"])
def repo(request, tmp_path):
    if request.param == "memory":
        return MemoryNameRecordRepository()
    return NfsNameRecordRepository(str(tmp_path / "nr"))


def test_add_get_delete(repo):
    repo.add("a/b/c", "v1")
    assert repo.get("a/b/c") == "v1"
    with pytest.raises(NameEntryExistsError):
        repo.add("a/b/c", "v2")
    repo.add("a/b/c", "v2", replace=True)
    assert repo.get("a/b/c") == "v2"
    repo.delete("a/b/c")
    with pytest.raises(NameEntryNotFoundError):
        repo.get("a/b/c")


def test_subtree(repo):
    repo.add("root/x/1", "a")
    repo.add("root/x/2", "b")
    repo.add("root/y", "c")
    assert sorted(repo.get_subtree("root/x")) == ["a", "b"]
    assert repo.find_subtree("root/x") == ["root/x/1", "root/x/2"]
    repo.clear_subtree("root")
    assert repo.get_subtree("root") == []


def test_add_subentry(repo):
    k1 = repo.add_subentry("servers", "addr1")
    k2 = repo.add_subentry("servers", "addr2")
    assert k1 != k2
    assert sorted(repo.get_subtree("servers")) == ["addr1", "addr2"]


def test_wait_blocks_until_added(repo):
    def adder():
        time.sleep(0.2)
        repo.add("late/key", "done")

    t = threading.Thread(target=adder)
    t.start()
    assert repo.wait("late/key", timeout=5, poll_frequency=0.02) == "done"
    t.join()
    with pytest.raises(TimeoutError):
        repo.wait("never", timeout=0.2, poll_frequency=0.05)


def test_watch_names_fires_on_delete(repo):
    repo.add("watched/a", "1")
    fired = threading.Event()
    repo.watch_names(["watched/a"], fired.set, poll_frequency=0.02, wait_timeout=1)
    time.sleep(0.1)
    assert not fired.is_set()
    repo.delete("watched/a")
    assert fired.wait(timeout=2)


def test_module_level_api():
    name_resolve.add(names.gen_server("e", "t", "0"), "addr:1234")
    try:
        assert name_resolve.get_subtree(names.gen_servers("e", "t")) == ["addr:1234"]
    finally:
        name_resolve.clear_subtree(names.gen_servers("e", "t"))


def test_nfs_reset_removes_own_entries(tmp_path):
    repo = NfsNameRecordRepository(str(tmp_path / "nr"))
    repo.add("a/1", "x", delete_on_exit=True)
    repo.add("a/2", "y", delete_on_exit=False)
    repo.reset()
    with pytest.raises(NameEntryNotFoundError):
        repo.get("a/1")
    assert repo.get("a/2") == "y"


def test_watch_names_fires_when_peer_never_appears():
    repo = MemoryNameRecordRepository()
    fired = threading.Event()
    repo.watch_names(["never/appears"], fired.set, poll_frequency=0.02, wait_timeout=0.1)
    assert fired.wait(timeout=2)


def test_env_switch_selects_the_backend(monkeypatch, tmp_path):
    """AREAL_NAME_RESOLVE=nfs:<root> shares keys between two processes'
    stores (here: a second repository on the same root, and the JAX
    package's NFS backend, which reads the same files); memory resets;
    unset leaves the store alone; http raises."""
    from areal_tpu.utils.name_resolve import NfsNameRecordRepository as JaxNfs

    saved = name_resolve.DEFAULT_REPOSITORY
    root = str(tmp_path / "shared")
    try:
        monkeypatch.setenv("AREAL_NAME_RESOLVE", f"nfs:{root}")
        name_resolve.reconfigure_from_env()
        assert isinstance(name_resolve.DEFAULT_REPOSITORY, NfsNameRecordRepository)
        name_resolve.add(names.gen_router("e", "t"), "127.0.0.1:9", delete_on_exit=False)
        assert NfsNameRecordRepository(root).get(names.gen_router("e", "t")) == "127.0.0.1:9"
        assert JaxNfs(root).get(names.gen_router("e", "t")) == "127.0.0.1:9"
        assert name_resolve.find_subtree(names.trial_root("e", "t")) == [
            names.gen_router("e", "t")]
        monkeypatch.setenv("AREAL_NAME_RESOLVE", "memory")
        name_resolve.reconfigure_from_env()
        assert isinstance(name_resolve.DEFAULT_REPOSITORY, MemoryNameRecordRepository)
        with pytest.raises(NameEntryNotFoundError):
            name_resolve.get(names.gen_router("e", "t"))
        kept = name_resolve.DEFAULT_REPOSITORY
        monkeypatch.delenv("AREAL_NAME_RESOLVE")
        name_resolve.reconfigure_from_env()
        assert name_resolve.DEFAULT_REPOSITORY is kept
        monkeypatch.setenv("AREAL_NAME_RESOLVE", "http:127.0.0.1:1")
        with pytest.raises(NotImplementedError, match="not ported"):
            name_resolve.reconfigure_from_env()
    finally:
        name_resolve.DEFAULT_REPOSITORY = saved


def test_key_layout_matches_the_jax_package():
    from areal_tpu.utils import names as jax_names

    for fn, args in (("trial_root", ("e", "t")), ("gen_servers", ("e", "t")),
                     ("gen_server", ("e", "t", "3")), ("gen_router", ("e", "t")),
                     ("update_weights_from_disk", ("e", "t", 7)),
                     ("update_weights_from_disk", ("e", "t", "")),
                     ("weight_version", ("e", "t")), ("trainer_master", ("e", "t")),
                     ("distributed_lock", ("e", "t", "l")), ("worker", ("e", "t", "w", 2)),
                     ("worker_root", ("e", "t", "w")), ("experiment_status", ("e", "t"))):
        assert getattr(names, fn)(*args) == getattr(jax_names, fn)(*args), fn


def test_launch_with_an_nfs_config_registers_the_servers_in_that_store(tmp_path, monkeypatch):
    """`gsm8k_grpo --launch` with `cluster.name_resolve.type=nfs` and no
    AREAL_NAME_RESOLVE: both servers of a `jax:d2+d1` allocation register
    under `names.gen_servers` in the configured NFS store, and the trainer
    the launcher spawns inherits that store."""
    import subprocess
    import sys

    from areal_tpu_torch.examples.math import gsm8k_grpo
    from areal_tpu_torch.launcher.local import LocalLauncher

    root = tmp_path / "nr"
    seen = {}

    def start_trainer(self, cmd, run_id, server_addrs):
        # in place of the trainer: what a process of the configured store finds
        store = NfsNameRecordRepository(str(root))
        key = names.gen_servers("gsm8k-grpo", "trial0")
        deadline = time.monotonic() + 30
        while len(store.get_subtree(key)) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        seen.update(registered=sorted(store.get_subtree(key)), started=sorted(server_addrs),
                    spec=os.environ.get("AREAL_NAME_RESOLVE"))
        return subprocess.Popen([sys.executable, "-c", "pass"])

    monkeypatch.setattr(LocalLauncher, "start_trainer", start_trainer)
    monkeypatch.setenv("AREAL_NAME_RESOLVE", "")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("AREAL_LLM_SERVER_ADDRS", raising=False)
    monkeypatch.delenv("AREAL_RUN_ID", raising=False)
    rc = gsm8k_grpo.main(["--device", "cpu", "--model", "tiny", "--launch",
                          "--relaunch-delay", "0", "--trainer-timeout", "60",
                          f"cluster.fileroot={tmp_path}", "cluster.name_resolve.type=nfs",
                          f"cluster.name_resolve.nfs_record_root={root}",
                          "allocation_mode=jax:d2+d1", "rollout.setup_timeout=120"])
    assert rc == 0
    assert seen["spec"] == f"nfs:{root}"
    assert len(seen["started"]) == 2
    assert seen["registered"] == seen["started"]
