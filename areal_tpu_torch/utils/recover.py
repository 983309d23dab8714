"""Crash-safe checkpoint and resume of an interrupted run (the port's copy
of `areal_tpu/utils/recover.py`).  The trainer may die at any instant, a
SIGKILL in the middle of a dump included, and the relaunch resumes from
the last good state, losing at most one step:

- `dump` stages the whole generation in ``recover/.tmp-<step>``: the
  engine's checkpoint with its optimizer state (`TorchTrainEngine.save`),
  the pickled `RecoverInfo` (step, saver, evaluator, stats logger and
  dataloader states) and a ``manifest.json`` with the step, the weight
  version, the config fingerprint, the async state (staleness ledger,
  seed, the fleet's version) and a size and blake2b digest per file.  It
  fsyncs every file, passes the ``recover_mid_dump`` fault point, renames
  the staging dir to ``recover/gen-<step>`` (the commit point), prunes to
  `RecoverConfig.keep_generations` and rewrites the ``recover_info.json``
  sidecar.  The previous generation stays until the new one is durable.
- `load` walks the generations newest first, validates each manifest
  (schema, every file's size and digest) and falls back past a torn or
  tampered generation.  A config fingerprint that differs is refused
  (`RecoverConfigMismatch`): resuming under another config corrupts the
  run worse than starting over.  It restores the engine and the states,
  sets the version to the recovered step + 1, replays the weight upload
  with that version pinned, so the servers (which outlive the trainer)
  serve the recovered policy and not a newer one that survived the crash,
  and settles the trajectories in flight at the crash as rejected.  The
  replay retires what the servers still generate for the dead trainer: a
  disk reload aborts in-flight requests, and a transfer replay commits
  with `live_commit=False`, which aborts them too.

`extra_engines` ({"critic": engine, ...}) are dumped beside the main
engine, each with its optimizer state, in ``checkpoint_<name>``, listed in
the manifest, and restored with it; a generation without one's checkpoint
leaves that engine at its initial weights, with a warning.  The digests are computed file by file on a thread pool (hashlib releases
the GIL on large buffers); `last_dump` and `last_load` keep the wall times
of each part, the digests' apart.  A load counts in
`areal_train_recover_total` and emits a `run_restart` event.

`check_if_recover` decides whether a launch resumes.
"""

import concurrent.futures
import hashlib
import json
import logging
import os
import pickle
import re
import shutil
import time
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.config import RecoverConfig
from areal_tpu_torch.api.io_struct import RolloutStat, SaveLoadMeta, StepInfo, WeightUpdateMeta
from areal_tpu_torch.utils import seeding, telemetry
from areal_tpu_torch.utils.faults import fault_point

logger = logging.getLogger("areal_tpu_torch.recover")

MANIFEST_SCHEMA = "areal-recover/v1"

_GEN_RE = re.compile(r"gen-(\d{8})")


class RecoverCorruptError(RuntimeError):
    """A generation failed validation (a torn rename, a tampered or
    truncated file).  `load` falls back to the previous generation."""


class RecoverConfigMismatch(RuntimeError):
    """The generation was written under another config fingerprint:
    refused, never fallen back from."""


def config_fingerprint(obj: Any) -> str:
    """blake2b over the canonical JSON of a config's dict form; leaves
    that JSON cannot hold degrade to repr()."""
    blob = json.dumps(obj, sort_keys=True, default=repr).encode("utf-8")
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _file_digest(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _digests(paths: List[str]) -> Dict[str, str]:
    """{path: digest}, the files hashed in parallel."""
    with concurrent.futures.ThreadPoolExecutor(max(1, min(8, len(paths)))) as pool:
        return dict(zip(paths, pool.map(_file_digest, paths)))


def _fsync_path(path: str) -> None:
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0) if os.path.isdir(path) else os.O_RDONLY
    try:
        fd = os.open(path, flags)
    except OSError:  # O_DIRECTORY unsupported: durability is best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(root: str) -> None:
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            _fsync_path(os.path.join(dirpath, fn))
        _fsync_path(dirpath)


def _walk_files(root: str) -> List[str]:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs)


@dataclass
class RecoverInfo:
    recover_start: StepInfo
    last_step_info: StepInfo
    saver_info: Dict[str, Any] = field(default_factory=dict)
    evaluator_info: Dict[str, Any] = field(default_factory=dict)
    stats_logger_info: Dict[str, Any] = field(default_factory=dict)
    dataloader_info: Dict[str, Any] = field(default_factory=dict)


class RecoverHandler:
    def __init__(self, config: RecoverConfig, ft_spec=None, fingerprint: Optional[str] = None):
        self.config = config
        self.ft_spec = ft_spec
        # stamped into every manifest; load refuses a generation written
        # under another one
        self.fingerprint = fingerprint
        self.last_dump: Dict[str, Any] = {}
        self.last_load: Dict[str, Any] = {}

    def recover_root(self) -> str:
        return os.path.join(self.config.fileroot, self.config.experiment_name,
                            self.config.trial_name, "recover")

    def generations(self) -> List[str]:
        """Completed generation dirs, oldest first.  Staging dirs are
        invisible here: only the rename makes a generation visible."""
        root = self.recover_root()
        if not os.path.isdir(root):
            return []
        out = []
        for d in os.listdir(root):
            m = _GEN_RE.fullmatch(d)
            if m:
                out.append((int(m.group(1)), os.path.join(root, d)))
        return [p for _, p in sorted(out)]

    # ------------------------------------------------------------------
    # dump
    # ------------------------------------------------------------------

    def dump(self, engine, step_info: StepInfo, saver=None, evaluator=None, stats_logger=None,
             dataloader=None, inference_engine=None, extra_engines=None) -> str:
        """Write the generation of `step_info` (module docstring); returns
        its path.  `inference_engine`'s ledger and version go into the
        manifest; `extra_engines` are saved beside `engine`."""
        t_start = time.perf_counter()
        root = self.recover_root()
        os.makedirs(root, exist_ok=True)
        step = step_info.global_step
        staging = os.path.join(root, f".tmp-{step:08d}")
        final = os.path.join(root, f"gen-{step:08d}")
        for stale in (staging, final):
            if os.path.isdir(stale):
                shutil.rmtree(stale)

        engine.save(SaveLoadMeta(path=os.path.join(staging, "checkpoint"), with_optim=True))
        for name, eng in (extra_engines or {}).items():
            eng.save(SaveLoadMeta(path=os.path.join(staging, f"checkpoint_{name}"),
                                  with_optim=True))

        info = RecoverInfo(
            recover_start=StepInfo(
                epoch=step_info.epoch,
                epoch_step=step_info.epoch_step + 1,
                global_step=step_info.global_step + 1,
                steps_per_epoch=step_info.steps_per_epoch,
            ),
            last_step_info=step_info,
            saver_info=saver.state_dict() if saver else {},
            evaluator_info=evaluator.state_dict() if evaluator else {},
            stats_logger_info=stats_logger.state_dict() if stats_logger else {},
            dataloader_info=dataloader.state_dict() if dataloader else {},
        )
        with open(os.path.join(staging, "recover_state.pkl"), "wb") as f:
            pickle.dump(info, f)
        t_written = time.perf_counter()

        manifest = {
            "schema": MANIFEST_SCHEMA,
            "recover_start": asdict(info.recover_start),
            "last_step_info": asdict(info.last_step_info),
            "weight_version": self._maybe_version(engine),
            "run_id": int(os.environ.get("AREAL_RUN_ID", 0)),
            "created_ts": time.time(),
            "config_fingerprint": self.fingerprint,
            "extra_engines": sorted(extra_engines or {}),
            "async_state": self._async_state(inference_engine),
            "files": {},
        }
        files = _walk_files(staging)
        digests = _digests(files)
        t_digested = time.perf_counter()
        for p in files:
            manifest["files"][os.path.relpath(p, staging)] = {
                "size": os.path.getsize(p), "blake2b": digests[p]}
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        _fsync_tree(staging)
        t_synced = time.perf_counter()

        # a SIGKILL here leaves only a .tmp-* dir, which load() never sees
        fault_point("recover_mid_dump")

        os.rename(staging, final)  # the commit point: atomic on one filesystem
        _fsync_path(root)
        self._prune()
        self._write_sidecar(manifest, final)  # after the prune: it shows the disk
        self.last_dump = {
            "generation": final,
            "bytes": sum(v["size"] for v in manifest["files"].values()),
            "seconds": time.perf_counter() - t_start,
            "write_seconds": t_written - t_start,
            "digest_seconds": t_digested - t_written,
            "fsync_seconds": t_synced - t_digested,
        }
        logger.info("dumped recover generation @ step %d -> %s", step, final)
        return final

    @staticmethod
    def _maybe_version(engine) -> Optional[int]:
        try:
            return int(engine.get_version())
        except (AttributeError, TypeError):
            return None

    @staticmethod
    def _async_state(inference_engine) -> Dict[str, Any]:
        """The staleness ledger, the seed base and the fleet's weight
        version, best effort: a dump never fails because the rollout side
        is degraded."""
        state: Dict[str, Any] = {"rollout_stat": None, "seed": None,
                                 "fleet_weight_version": None}
        try:
            state["seed"] = seeding.get_seed()
        except RuntimeError:
            pass
        if inference_engine is None:
            return state
        executor = getattr(inference_engine, "executor", None)
        if executor is not None:
            state["rollout_stat"] = asdict(executor.staleness_manager.get_stats())
        try:
            state["fleet_weight_version"] = int(inference_engine.get_version())
        except (AttributeError, TypeError):
            pass
        return state

    def _write_sidecar(self, manifest: Dict[str, Any], latest: str) -> None:
        """``recover_info.json`` beside the generations, the manifest's
        summary for people, written tmp + rename."""
        root = self.recover_root()
        doc = {
            "schema": MANIFEST_SCHEMA,
            "experiment_name": self.config.experiment_name,
            "trial_name": self.config.trial_name,
            "run_id": manifest["run_id"],
            "last_step_info": manifest["last_step_info"],
            "recover_start": manifest["recover_start"],
            "weight_version": manifest["weight_version"],
            "config_fingerprint": manifest["config_fingerprint"],
            "updated_ts": time.time(),
            "latest": latest,
            "generations": self.generations(),
        }
        tmp = os.path.join(root, ".recover_info.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(root, "recover_info.json"))

    def _prune(self) -> None:
        keep = max(1, self.config.keep_generations)
        for old in self.generations()[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
        # staging leftovers of crashed dumps are dead weight
        root = self.recover_root()
        for d in os.listdir(root):
            if d.startswith(".tmp-"):
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------

    def validate_generation(self, gen_dir: str) -> Dict[str, Any]:
        """The generation's manifest, once every file's size and digest
        check out and the fingerprint matches; raises otherwise."""
        mpath = os.path.join(gen_dir, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise RecoverCorruptError(f"{gen_dir}: unreadable manifest: {e}")
        if manifest.get("schema") != MANIFEST_SCHEMA:
            raise RecoverCorruptError(f"{gen_dir}: unknown manifest schema "
                                      f"{manifest.get('schema')!r}")
        specs = manifest.get("files", {})
        for rel, spec in specs.items():
            p = os.path.join(gen_dir, rel)
            if not os.path.isfile(p):
                raise RecoverCorruptError(f"{gen_dir}: missing file {rel}")
            if os.path.getsize(p) != spec["size"]:
                raise RecoverCorruptError(f"{gen_dir}: size mismatch for {rel}")
        digests = _digests([os.path.join(gen_dir, rel) for rel in specs])
        for rel, spec in specs.items():
            if digests[os.path.join(gen_dir, rel)] != spec["blake2b"]:
                raise RecoverCorruptError(f"{gen_dir}: digest mismatch for {rel}")
        fp = manifest.get("config_fingerprint")
        if self.fingerprint is not None and fp is not None and fp != self.fingerprint:
            raise RecoverConfigMismatch(
                f"{gen_dir} was written under config fingerprint {fp}, this run has "
                f"{self.fingerprint}; refusing to resume: move the recover dir aside or "
                f"fix the config")
        return manifest

    def load(self, engine, saver=None, evaluator=None, stats_logger=None, dataloader=None,
             inference_engine=None, weight_update_meta: Optional[WeightUpdateMeta] = None,
             extra_engines=None) -> Optional[RecoverInfo]:
        """Restore from the newest intact generation (module docstring),
        `extra_engines` too; None when there is none."""
        t_start = time.perf_counter()
        manifest = gen_dir = None
        for cand in reversed(self.generations()):
            try:
                manifest = self.validate_generation(cand)
                gen_dir = cand
                break
            except RecoverCorruptError as e:
                logger.warning("skipping corrupt recover generation: %s", e)
        if gen_dir is None:
            return None
        t_valid = time.perf_counter()

        with open(os.path.join(gen_dir, "recover_state.pkl"), "rb") as f:
            info: RecoverInfo = pickle.load(f)
        engine.load(SaveLoadMeta(path=os.path.join(gen_dir, "checkpoint"), with_optim=True))
        for name, eng in (extra_engines or {}).items():
            sub = os.path.join(gen_dir, f"checkpoint_{name}")
            if os.path.isdir(sub):
                eng.load(SaveLoadMeta(path=sub, with_optim=True))
            else:
                logger.warning("recover generation %s has no %s engine state; it resumes from "
                               "its initial weights", gen_dir, name)
        if saver is not None and info.saver_info:
            saver.load_state_dict(info.saver_info)
        if evaluator is not None and info.evaluator_info:
            evaluator.load_state_dict(info.evaluator_info)
        if stats_logger is not None and info.stats_logger_info:
            stats_logger.load_state_dict(info.stats_logger_info)
        if dataloader is not None and info.dataloader_info:
            dataloader.load_state_dict(info.dataloader_info)
        version = info.last_step_info.global_step + 1
        engine.set_version(version)
        t_loaded = time.perf_counter()
        settled = 0
        if inference_engine is not None and weight_update_meta is not None:
            # the servers must serve the recovered policy, not a newer
            # snapshot that survived the crash, and stop what they still
            # generate for the dead trainer
            if weight_update_meta.type == "disk":
                pinned = replace(weight_update_meta, version=version)
            else:
                pinned = replace(weight_update_meta, live_commit=False)
            engine.update_weights(pinned)
            inference_engine.update_weights(pinned)
            inference_engine.set_version(version)
        t_replayed = time.perf_counter()
        if inference_engine is not None:
            settled = self._restore_async_state(inference_engine, manifest)
        self.last_load = {
            "generation": gen_dir,
            "recovered_step": info.last_step_info.global_step,
            "resume_step": info.recover_start.global_step,
            "weight_version": version,
            "settled_inflight": settled,
            "seconds": time.perf_counter() - t_start,
            "validate_seconds": t_valid - t_start,
            "restore_seconds": t_loaded - t_valid,
            "replay_seconds": t_replayed - t_loaded,
        }
        telemetry.TRAIN_RECOVER.inc()
        telemetry.emit("run_restart", run_id=int(os.environ.get("AREAL_RUN_ID", 0)),
                       recovered_step=info.last_step_info.global_step,
                       resume_step=info.recover_start.global_step, weight_version=version,
                       settled_inflight=settled, generation=gen_dir)
        logger.info("recovered from step %d (%s); resuming at %d",
                    info.last_step_info.global_step, gen_dir, info.recover_start.global_step)
        return info

    @staticmethod
    def _restore_async_state(inference_engine, manifest: Dict[str, Any]) -> int:
        executor = getattr(inference_engine, "executor", None)
        stat = (manifest.get("async_state") or {}).get("rollout_stat")
        if executor is None or stat is None:
            return 0
        settled = executor.restore_staleness(RolloutStat(**stat))
        if settled:
            logger.warning("settled %d in-flight-at-crash trajectories as rejected (counted "
                           "in lost_trajectories)", settled)
        return settled


def check_if_recover(config: RecoverConfig, run_id: int = 0) -> bool:
    """Does this launch resume from a recover generation?

    - ``disabled``: never.
    - ``auto``: when a generation exists.
    - ``resume``: the user asked to continue, so a missing generation is
      an error, not a silent fresh start.
    - ``fault``: only on a relaunch (run_id > 0), the launcher's
      crash-recovery loop.
    """
    if config.mode == "disabled":
        return False
    root = os.path.join(config.fileroot, config.experiment_name, config.trial_name, "recover")
    exists = os.path.isdir(root) and any(
        _GEN_RE.fullmatch(d) and os.path.isfile(os.path.join(root, d, "manifest.json"))
        for d in os.listdir(root))
    if config.mode == "resume":
        if not exists:
            raise FileNotFoundError(f"recover.mode='resume' but no recover generation "
                                    f"exists under {root}")
        return True
    if config.mode == "auto":
        return exists
    if config.mode == "fault":
        return exists and run_id > 0
    return False
