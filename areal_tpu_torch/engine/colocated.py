"""Colocated serving and training: one card, shared in one process (the
port of `areal_tpu/engine/colocated.py`).

- A `GenEngine` serves rollouts on a background decode thread, the
  stepper; the caller's thread trains.
- `train_phase()` parks the stepper and frees the engine's device memory
  (KV cache, and the serving weights unless `drop_params=False`), so a
  train step can use it; `publish_weights` re-arms serving with the
  trainer's weights handed over in memory (`restage`).
- `update_weights_in_memory` publishes with both sides resident (the
  async regime): park the stepper between decode chunks, swap, restart.
  The default swap is live (`GenEngine.swap_weights_live`): in-flight
  requests keep decoding under the new weights.  `interrupt=True` aborts
  them instead (`GenEngine.load_weights`), and `agenerate` resubmits.
- While a train phase or a publish holds serving parked, `agenerate`
  waits for it; it starts serving itself only when nothing holds it.

Workflows run unmodified: `ColocatedEngine` implements the agenerate /
rollout_batch surface of `api/engine.py` with the remote client's
interruption contract (an aborted request is resubmitted with the tokens
it accumulated, and its retained prefix makes the resubmit a suffix
prefill).  A request's `group_id`/`group_n` reach the engine, whose
admission prefills a GRPO group's prompt once (`share_prefix`, a
`GenEngine` keyword like every other in `gen_kwargs`).

Unlike the reference's stepper, which logs a failed decode step and
steps again, the port's stops: it keeps the error, finishes every request
with "error" (now and until it is parked), and `agenerate` and
`start_serving` raise it.  A failure on the card is not retried over.
"""

import asyncio
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from areal_tpu_torch.api.engine import InferenceEngine
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.utils.data import concat_padded_tensors

logger = logging.getLogger("areal_tpu_torch.colocated")


class ColocatedEngine(InferenceEngine):
    """Time-shared serving facade over an in-process GenEngine."""

    def __init__(self, model_config, params: Optional[Transformer] = None,
                 model_path: Optional[str] = None, **gen_kwargs):
        self.engine = GenEngine(model_config, params=params, model_path=model_path,
                                **gen_kwargs)
        self._stop = threading.Event()
        self._stepper: Optional[threading.Thread] = None
        self._serving = False
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()  # serializes spawning and parking the stepper
        # set while a train phase or a publish holds serving parked: agenerate
        # waits instead of restarting it; only start_serving clears it
        self._held = False  # guarded-by: _lock

    # ----------------------------- lifecycle ---------------------------

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("the decode stepper failed") from self._error

    def start_serving(self) -> None:
        with self._lock:
            self._held = False
            self._spawn_locked()

    def _auto_start(self) -> bool:
        """agenerate's start: serve unless a train phase or a publish holds
        serving parked, or the engine has no cache.  -> serving now."""
        with self._lock:
            if not self._serving and not self._held and self.engine.cache is not None:
                self._spawn_locked()
            return self._serving

    def _hold(self) -> None:
        """Park the stepper and keep agenerate from restarting it until the
        next start_serving."""
        with self._lock:
            self._held = True
        self.stop_serving()

    def _spawn_locked(self) -> None:
        self._raise_if_failed()
        if self._serving:
            return
        if self._stepper is not None and self._stepper.is_alive():
            # a previous stop_serving timed out and left its thread in
            # step(); a second stepper would race it on the engine
            raise RuntimeError("previous serving stepper is still in a decode step; "
                               "cannot start a second one")
        self._stop.clear()
        device = self.engine.device

        def _loop():
            if device.type == "cuda":
                torch.cuda.set_device(device)  # the device is per thread
            try:
                while not self._stop.is_set():
                    # nothing delivered: idle, or admission waits out a
                    # group hold or an abort reservation
                    if not (self.engine.active_count() and self.engine.step()):
                        time.sleep(0.001)
            except Exception as e:  # noqa: BLE001 — surfaced to every caller
                logger.exception("decode step failed; serving stops")
                self._error = e
                # finish what is in flight and whatever arrives until parked
                while not self._stop.is_set():
                    self.engine.abort_all("error")
                    time.sleep(0.01)

        self._stepper = threading.Thread(target=_loop, daemon=True, name="decode-stepper")
        self._stepper.start()
        self._serving = True

    def stop_serving(self) -> None:
        with self._lock:
            stepper = self._stepper
            if not self._serving and not (stepper is not None and stepper.is_alive()):
                return
            self._stop.set()
        if stepper is not None:
            # the stepper MUST be parked before callers change engine state
            # (weight swap, memory release); wait for an in-flight step as
            # long as it takes, loudly, and give up only after ten minutes
            deadline = time.monotonic() + 600
            while stepper.is_alive():
                stepper.join(timeout=30)
                if stepper.is_alive():
                    if time.monotonic() > deadline:
                        # _stepper stays set so start_serving refuses to
                        # spawn a second thread beside it
                        with self._lock:
                            self._serving = False
                        raise RuntimeError("serving stepper failed to park within 600s; "
                                           "refusing to change engine state under a "
                                           "live decode thread")
                    logger.warning("waiting for an in-flight decode step to finish "
                                   "before parking the stepper")
        with self._lock:
            self._stepper = None
            self._serving = False

    def train_phase(self, drop_params: bool = True):
        """Context manager bracketing a train step: serving parked and its
        device memory released on entry.  With `drop_params=True` the
        serving weights are freed too and re-arming needs
        `publish_weights(model, version)`; with `drop_params=False` (cache
        only) a same-weights `resume_serving()` works afterwards."""
        outer = self

        class _Phase:
            def __enter__(self):
                outer._hold()
                outer.engine.release_memory(drop_params=drop_params)
                return outer

            def __exit__(self, *exc):
                return False

        return _Phase()

    def publish_weights(self, model: Transformer, version: Optional[int] = None) -> None:
        """In-memory weight handoff after a train phase, then serve."""
        self.engine.restage(model=model, version=version)
        self.start_serving()

    def update_weights_in_memory(self, model: Transformer, version: int,
                                 interrupt: bool = False) -> float:
        """Publish without releasing serving memory: park the stepper
        between decode chunks, swap weights, restart.  Returns the
        generation-idle window in seconds.  Live by default; with
        `interrupt=True` in-flight requests are aborted and resubmitted."""
        self._hold()
        t0 = time.perf_counter()
        if interrupt:
            self.engine.load_weights(model=model, version=version)
        else:
            self.engine.swap_weights_live(model, version=version)
        pause = time.perf_counter() - t0
        self.start_serving()
        return pause

    def resume_serving(self) -> None:
        """Re-arm with the SAME weights (cache-only restage)."""
        self.engine.restage()
        self.start_serving()

    def destroy(self) -> None:
        self.stop_serving()
        self.engine.abort_all("abort")

    # ----------------------------- serving -----------------------------

    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Generate with the remote client's interruption contract: an
        abort (weight update, memory release) resubmits the accumulated
        tokens once serving is back."""
        # a train phase or a publish in progress: wait for its start_serving
        while not self._auto_start():
            self._raise_if_failed()
            await asyncio.sleep(0.01)
        g = req.gconfig
        accumulated: List[int] = []
        logprobs: List[float] = []
        versions: List[int] = []
        input_ids = list(req.input_ids)
        t0 = time.perf_counter()
        first_token_ts: Optional[float] = None
        while True:
            self._raise_if_failed()
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()

            def _done(gr: GenRequest, fut=fut, loop=loop):
                try:
                    loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(gr))
                except RuntimeError:
                    pass  # the caller's event loop is gone: nothing to wake

            budget = g.max_new_tokens - len(accumulated)
            gr = GenRequest(
                rid=req.rid,
                group_id=req.group_id,
                group_n=req.group_n,
                input_ids=input_ids + accumulated,
                max_new_tokens=budget,
                min_new_tokens=min(g.min_new_tokens, budget),
                temperature=0.0 if g.greedy else g.temperature,
                top_p=g.top_p,
                top_k=g.top_k,
                stop_token_ids=list(g.stop_token_ids),
                trace_id=req.trace_id,
                on_done=_done,
            )
            self.engine.submit(gr)
            gr = await fut
            if gr.stop_reason == "error":
                self._raise_if_failed()
            if first_token_ts is None and gr.first_token_ts > 0.0:
                first_token_ts = gr.first_token_ts
            accumulated.extend(gr.output_tokens)
            logprobs.extend(gr.output_logprobs)
            versions.extend(gr.output_versions)
            if gr.stop_reason != "abort":
                break
            while not self._serving:  # a train phase is in progress
                self._raise_if_failed()
                await asyncio.sleep(0.01)
        return ModelResponse(
            input_tokens=list(req.input_ids),
            output_tokens=accumulated,
            output_logprobs=logprobs,
            output_versions=versions,
            stop_reason=gr.stop_reason,
            latency=time.perf_counter() - t0,
            ttft=(first_token_ts - t0 if first_token_ts is not None else float("inf")),
        )

    def rollout_batch(
        self,
        data: List[Dict[str, Any]],
        workflow=None,
        workflow_builder: Optional[Callable] = None,
        should_accept: Optional[Callable] = None,
    ) -> Dict[str, Any]:
        """Run one episode per item concurrently against the in-process
        engine and concatenate the results (the sync loop: rollouts and
        train steps alternate, they never overlap)."""
        self.start_serving()

        async def _run():
            wfs = [workflow if workflow is not None else workflow_builder() for _ in data]
            return await asyncio.gather(
                *[wf.arun_episode(self, item) for wf, item in zip(wfs, data)])

        results = [r for r in asyncio.run(_run()) if r is not None]
        if should_accept is not None:
            results = [r for r in results if should_accept(r)]
        if not results:
            raise RuntimeError("colocated rollout produced no trajectories")
        return concat_padded_tensors(results)

    def get_version(self) -> int:
        return self.engine.version
