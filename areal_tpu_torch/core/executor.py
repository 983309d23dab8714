"""Rollout workflow execution gated by staleness capacity (the port's copy
of `areal_tpu/core/executor.py`).

Episodes are submitted to the AsyncTaskRunner only when the
StalenessManager grants capacity; finished trajectories are validated,
filtered through `should_accept`, shuffled, and concatenated into a padded
batch.  `prepare_batch` keeps rollouts in flight while the trainer
consumes.  A trajectory the remote client could not finish on any server
(`TrajectoryLostError`) is settled as rejected and counted in
`lost_trajectories`; any other episode exception stays fatal.
`restore_staleness` adopts a recovered ledger, counting the trajectories
in flight at the crash as lost.  With telemetry on, each episode emits an
`episode` event and each loss a `trajectory_lost` one.

`fleet_gate` is the router's fleet-wide admission gate
(`core/remote.py FleetStalenessGate`), which the remote client sets when
it finds a router: each episode takes a lease before it runs and returns
it on every exit path, errors included, with `accepted` as decided, so a
crashed episode never holds a fleet admission until the lease's TTL.
Left out: the rollout tracing logs.
"""

import logging
import queue
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from areal_tpu_torch.api.config import InferenceEngineConfig
from areal_tpu_torch.api.workflow import RolloutWorkflow
from areal_tpu_torch.core.runner import AsyncTaskRunner, TaskError, TaskQueueFullError
from areal_tpu_torch.core.staleness import StalenessManager
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.data import concat_padded_tensors
from areal_tpu_torch.utils.dataloader import StatefulDataLoader, cycle_dataloader

logger = logging.getLogger("areal_tpu_torch.executor")


class TrajectoryLostError(RuntimeError):
    """A rollout's generation could not be completed on any server (the
    failover budget ran out mid-trajectory).  Unlike an ordinary episode
    exception, a workflow bug that stays fatal, a lost trajectory is an
    expected fleet-failure outcome: the executor settles its staleness
    accounting (submitted -> rejected), counts it, and the run goes on."""


def check_trajectory_format(
    traj: Dict[str, Any], expected_keys: Optional[Set[str]] = None
):
    """Validate a workflow's output."""
    if not isinstance(traj, dict):
        raise TypeError(f"trajectory must be a dict, got {type(traj)}")
    if "input_ids" not in traj or "attention_mask" not in traj:
        raise ValueError(
            f"trajectory must contain input_ids and attention_mask, "
            f"got {sorted(traj.keys())}"
        )
    B, L = np.asarray(traj["attention_mask"]).shape
    for k, v in traj.items():
        arr = np.asarray(v)
        if arr.shape[:1] != (B,):
            raise ValueError(f"trajectory key {k!r} batch dim {arr.shape} != {B}")
    if expected_keys is not None and set(traj.keys()) != expected_keys:
        raise ValueError(
            f"trajectory keys {sorted(traj.keys())} != expected "
            f"{sorted(expected_keys)}"
        )


@dataclass
class _TaskInput:
    data: Dict[str, Any]
    workflow: RolloutWorkflow
    should_accept: Optional[Callable]


class WorkflowExecutor:
    def __init__(
        self,
        config: InferenceEngineConfig,
        inference_engine,
        staleness_manager: Optional[StalenessManager] = None,
        runner: Optional[AsyncTaskRunner] = None,
    ):
        self.config = config
        self.inference_engine = inference_engine
        self.runner = runner or AsyncTaskRunner(
            max_queue_size=(config.max_concurrent_rollouts or 64) * 16)
        self.staleness_manager = staleness_manager or StalenessManager(
            max_concurrent_rollouts=config.max_concurrent_rollouts or 64,
            consumer_batch_size=config.consumer_batch_size,
            max_staleness=config.max_head_offpolicyness,
        )
        self._pending_inputs: List[_TaskInput] = []
        self._pending_results: List[Dict[str, Any]] = []
        self._expected_keys: Optional[Set[str]] = None
        self._data_generator = None
        # trajectories abandoned after the failover budget ran out
        self.lost_trajectories = 0
        # the router's fleet-wide admission gate (set by the remote client
        # when it finds a router): N clients of one fleet share one
        # staleness budget instead of applying N local ones
        self.fleet_gate = None

    # --- lifecycle ---
    def initialize(self):
        self.runner.start()

    def destroy(self):
        self.runner.stop()

    # --- capacity ---
    def get_capacity(self) -> int:
        version = self.inference_engine.get_version()
        return self.staleness_manager.get_capacity(version)

    # --- episode wrapper ---
    def _make_task(self, ti: _TaskInput):
        async def _run():
            alloc_id = None
            if self.fleet_gate is not None:
                qid = str(ti.data.get("query_id", "")) if isinstance(ti.data, dict) else ""
                alloc_id = await self.fleet_gate.allocate(qid)
            # the lease goes back on every exit path (format check and
            # should_accept errors included), or it holds a fleet admission
            # until its TTL
            accept = False
            try:
                try:
                    traj = await ti.workflow.arun_episode(self.inference_engine, ti.data)
                except TrajectoryLostError as e:
                    # a fleet failure, not a code bug: the reject below
                    # settles submitted -> rejected, and the run goes on
                    self.lost_trajectories += 1
                    logger.warning("trajectory lost to fleet failure: %s", e)
                    if telemetry.is_enabled():
                        telemetry.emit("trajectory_lost", lost_total=self.lost_trajectories)
                    traj = None
                except BaseException:
                    # the submit-side increment must be balanced even on
                    # failure, or every crashed episode eats one capacity slot
                    self.staleness_manager.on_rollout_rejected()
                    raise
                if traj is not None and self.config.check_trajectory_format:
                    check_trajectory_format(traj, self._expected_keys)
                    if self._expected_keys is None and "input_ids" in traj:
                        self._expected_keys = set(traj.keys())
                accept = traj is not None and (
                    ti.should_accept is None or ti.should_accept(traj)
                )
            finally:
                if self.fleet_gate is not None:
                    await self.fleet_gate.finish(alloc_id, accepted=accept)
            if telemetry.is_enabled():
                telemetry.emit("episode", accepted=accept,
                               version=self.inference_engine.get_version())
            if accept:
                self.staleness_manager.on_rollout_accepted()
                return traj
            self.staleness_manager.on_rollout_rejected()
            return None

        return _run

    # --- public surface (mirrors InferenceEngine) ---
    def submit(
        self,
        data: Dict[str, Any],
        workflow: Optional[RolloutWorkflow] = None,
        workflow_builder: Optional[Callable] = None,
        should_accept: Optional[Callable] = None,
    ) -> None:
        if workflow is None:
            if workflow_builder is None:
                raise ValueError("need workflow or workflow_builder")
            workflow = workflow_builder()
        self._pending_inputs.append(_TaskInput(data, workflow, should_accept))

    def _commit_one(self):
        ti = self._pending_inputs.pop(0)
        try:
            self.runner.submit(self._make_task(ti))
        except TaskQueueFullError:
            self._pending_inputs.insert(0, ti)
            raise queue.Full("runner input queue full")
        self.staleness_manager.on_rollout_submitted()

    def _drain_capacity(self):
        capacity = self.get_capacity()
        for _ in range(max(0, capacity)):
            if not self._pending_inputs:
                break
            try:
                self._commit_one()
            except queue.Full:
                break

    def wait(self, count: int, timeout: Optional[float] = None) -> Dict[str, Any]:
        start = time.perf_counter()
        timeout = timeout if timeout is not None else 7 * 24 * 3600.0
        while True:
            self._drain_capacity()
            if len(self._pending_results) >= count:
                break
            remaining = timeout - (time.perf_counter() - start)
            if remaining <= 0:
                raise TimeoutError(
                    f"timed out waiting for {count} rollouts "
                    f"({len(self._pending_results)} ready)"
                )
            try:
                batch = self.runner.wait(
                    count=max(1, count - len(self._pending_results)),
                    timeout=min(0.1, remaining),
                )
            except TimeoutError:
                continue
            # collect good results before surfacing any failure, so accepted
            # trajectories from the same runner batch are not dropped
            first_error: Optional[TaskError] = None
            for item in batch:
                if isinstance(item, TaskError):
                    first_error = first_error or item
                elif item is not None:
                    self._pending_results.append(item)
            if first_error is not None:
                raise RuntimeError("rollout task failed") from first_error.exc
        results = self._pending_results[:count]
        self._pending_results = self._pending_results[count:]
        random.shuffle(results)
        return concat_padded_tensors(results)

    def rollout_batch(
        self,
        data: List[Dict[str, Any]],
        workflow: Optional[RolloutWorkflow] = None,
        workflow_builder: Optional[Callable] = None,
        should_accept: Optional[Callable] = None,
    ) -> Dict[str, Any]:
        for item in data:
            self.submit(item, workflow, workflow_builder, should_accept)
        return self.wait(count=len(data))

    def prepare_batch(
        self,
        dataloader: StatefulDataLoader,
        workflow: Optional[RolloutWorkflow] = None,
        workflow_builder: Optional[Callable] = None,
        should_accept: Optional[Callable] = None,
    ) -> Dict[str, Any]:
        """Async-RL batch assembly: keep the rollout pipeline saturated while
        returning as soon as one consumer batch is ready."""
        if self._data_generator is None:
            self._data_generator = cycle_dataloader(dataloader)
        bs = dataloader.batch_size
        while True:
            if (
                self.get_capacity() + bs > 0
                and self.runner.get_input_queue_size() + bs < self.runner.max_queue_size
            ):
                for item in next(self._data_generator):
                    self.submit(item, workflow, workflow_builder, should_accept)
            try:
                return self.wait(bs, timeout=1)
            except TimeoutError:
                continue

    def pause(self):
        self.runner.pause()

    def resume(self):
        self.runner.resume()

    def is_paused(self) -> bool:
        return self.runner.paused.is_set()

    # --- crash recovery (utils/recover.py) ---
    def restore_staleness(self, stat) -> int:
        """Adopt a recovered ledger snapshot.  Trajectories that were in
        flight when the trainer died are settled as rejected by the
        manager and counted here as lost, as a failover-budget exhaustion
        is, so loss counts stay honest across restarts.  Returns the
        number settled."""
        settled = self.staleness_manager.restore(stat)
        self.lost_trajectories += settled
        if settled and telemetry.is_enabled():
            telemetry.emit("trajectory_lost", lost_total=self.lost_trajectories,
                           reason="trainer_crash", settled=settled)
        return settled
