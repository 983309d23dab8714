"""RLVR (RL with verifiable rewards) rollout workflow (the port's copy of
`areal_tpu/workflow/rlvr.py`).

Generate `n_samples` completions per prompt concurrently, score each with
a (sync) reward function run off the event loop, and emit one padded
trajectory batch with the keys `TorchPPOActor` consumes: input_ids,
logprobs (the behaviour policy's, 0 on the prompt), loss_mask, versions
(the weight version of each output token, -1 on the prompt), rewards and
attention_mask.  The siblings of a GRPO group declare it (`group_id`,
`group_n`): a remote client keeps them on one server and the engine
prefills their prompt once.  With telemetry on, each scored sample emits
a `reward` event and its trajectory carries `trace_keys` (the trace id's
int64 hash), which the trainer strips at consumption and joins its
`train_consume` events on.  Left out with what they serve: per-query text
dumps (`dump_dir`) and `enable_thinking`.
"""

import asyncio
import uuid
from typing import Any, Callable, Dict

import numpy as np

from areal_tpu_torch.api.config import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.reward import AsyncRewardWrapper
from areal_tpu_torch.api.workflow import RolloutWorkflow
from areal_tpu_torch.utils import telemetry
from areal_tpu_torch.utils.data import pad_sequences_to_tensors


class RLVRWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer=None,
    ):
        self.reward_fn = AsyncRewardWrapper(reward_fn)
        self.gconfig = gconfig
        self.tokenizer = tokenizer

    def _tokenize_prompt(self, data: Dict[str, Any]):
        if "input_ids" in data:
            return list(data["input_ids"])
        if self.tokenizer is None:
            raise ValueError("need tokenizer or pre-tokenized input_ids")
        if "messages" in data:
            return self.tokenizer.apply_chat_template(
                data["messages"], add_generation_prompt=True, tokenize=True)
        return self.tokenizer.encode(data["prompt"])

    def _build_request(self, data: Dict[str, Any]) -> ModelRequest:
        """A dataset item may carry its own `max_new_tokens` to cap this
        prompt's generation budget below the workflow default."""
        overrides = {"n_samples": 1}
        if "max_new_tokens" in data:
            overrides["max_new_tokens"] = min(
                int(data["max_new_tokens"]), self.gconfig.max_new_tokens
            )
        return ModelRequest(
            rid=str(uuid.uuid4()),
            input_ids=self._tokenize_prompt(data),
            gconfig=self.gconfig.new(**overrides),
            tokenizer=self.tokenizer,
        )

    async def arun_episode(self, engine, data: Dict[str, Any]):
        n = self.gconfig.n_samples
        req = self._build_request(data)
        reqs = [req.copy() for _ in range(n)]
        if n > 1:
            # a GRPO group: declare the siblings so routing keeps them on one
            # server and the engine admits them as one prefix-sharing cluster
            for k, r in enumerate(reqs):
                r.rid = f"{req.rid}-{k}"
                r.group_id = req.rid
                r.group_n = n
        # the lifecycle trace id is pinned here, so reward and trainer
        # consumption events join the generation-side spans
        for r in reqs:
            r.trace_id = r.rid
        resps = await asyncio.gather(*[engine.agenerate(r) for r in reqs])
        results = []
        for r, resp in zip(reqs, resps):
            completion_str = (
                self.tokenizer.decode(resp.output_tokens)
                if self.tokenizer is not None
                else ""
            )
            prompt_str = (
                self.tokenizer.decode(resp.input_tokens)
                if self.tokenizer is not None
                else ""
            )
            reward = await self.reward_fn(
                prompt_str,
                completion_str,
                resp.input_tokens,
                resp.output_tokens,
                **data,
            )
            seq = resp.input_tokens + resp.output_tokens
            logprobs = [0.0] * resp.input_len + resp.output_logprobs
            loss_mask = [0] * resp.input_len + [1] * resp.output_len
            versions = [-1] * resp.input_len + resp.output_versions
            result = dict(
                input_ids=np.array(seq, dtype=np.int32),
                logprobs=np.array(logprobs, dtype=np.float32),
                loss_mask=np.array(loss_mask, dtype=np.int32),
                versions=np.array(versions, dtype=np.int32),
                rewards=np.float32(reward),
            )
            if telemetry.is_enabled():
                out_v = [v for v in resp.output_versions if v >= 0]
                telemetry.emit("reward", trace_id=r.trace_id, reward=float(reward),
                               output_len=resp.output_len, stop_reason=resp.stop_reason,
                               version_min=min(out_v) if out_v else -1,
                               version_max=max(out_v) if out_v else -1)
                # a 0-d scalar, stacked to [B]; keyed only when telemetry
                # is on, so a run's batches have one key set
                result["trace_keys"] = np.int64(telemetry.trace_key(r.trace_id))
            results.append(result)
        return pad_sequences_to_tensors(results)
