"""Multi-turn retry-until-correct workflow (the port's copy of
`areal_tpu/workflow/multi_turn.py`).

Ask again with a feedback suffix appended until the reward function
accepts or the turn budget runs out; an episode is one trajectory whose
reward is discounted by `turn_discount` per failed turn.  Every turn's
prompt extends the previous turn's transcript, so on an engine with prefix
reuse each turn prefills only its new tokens (the feedback and the pending
token) over the retained K/V of the turns before.
"""

import uuid
from typing import Any, Callable, Dict, List

import numpy as np

from areal_tpu_torch.api.config import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.reward import AsyncRewardWrapper
from areal_tpu_torch.api.workflow import RolloutWorkflow
from areal_tpu_torch.utils.data import pad_sequences_to_tensors

DEFAULT_FEEDBACK = (
    "\nYour answer is either wrong or not parsable. "
    "Please try to answer it again."
)


class MultiTurnWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer,
        max_turns: int = 3,
        turn_discount: float = 0.9,
        feedback_text: str = DEFAULT_FEEDBACK,
    ):
        self.reward_fn = AsyncRewardWrapper(reward_fn)
        self.gconfig = gconfig.new(n_samples=1)
        self.tokenizer = tokenizer
        self.max_turns = max_turns
        self.turn_discount = turn_discount
        self.feedback_text = feedback_text

    async def arun_episode(self, engine, data: Dict[str, Any]):
        if "messages" in data:
            input_ids = self.tokenizer.apply_chat_template(
                data["messages"], add_generation_prompt=True, tokenize=True
            )
        else:
            input_ids = list(data["input_ids"])
        seq: List[int] = list(input_ids)
        logprobs: List[float] = [0.0] * len(input_ids)
        loss_mask: List[int] = [0] * len(input_ids)
        versions: List[int] = [-1] * len(input_ids)
        reward, discount = 0.0, 1.0
        for turn in range(self.max_turns):
            req = ModelRequest(
                rid=str(uuid.uuid4()),
                input_ids=seq,
                gconfig=self.gconfig,
                tokenizer=self.tokenizer,
            )
            resp = await engine.agenerate(req)
            seq = seq + resp.output_tokens
            logprobs += resp.output_logprobs
            loss_mask += [1] * resp.output_len
            versions += resp.output_versions
            completion_str = self.tokenizer.decode(resp.output_tokens)
            prompt_str = self.tokenizer.decode(input_ids)
            reward = await self.reward_fn(
                prompt_str, completion_str, resp.input_tokens, resp.output_tokens,
                **data,
            )
            if reward > 0 or turn == self.max_turns - 1:
                break
            # a wrong answer: append the feedback (not trained on) and retry
            feedback_ids = self.tokenizer.encode(
                self.feedback_text, add_special_tokens=False
            )
            seq += feedback_ids
            logprobs += [0.0] * len(feedback_ids)
            loss_mask += [0] * len(feedback_ids)
            versions += [-1] * len(feedback_ids)
            discount *= self.turn_discount
        return pad_sequences_to_tensors(
            [
                dict(
                    input_ids=np.array(seq, dtype=np.int32),
                    logprobs=np.array(logprobs, dtype=np.float32),
                    loss_mask=np.array(loss_mask, dtype=np.int32),
                    versions=np.array(versions, dtype=np.int32),
                    rewards=np.float32(reward * discount),
                )
            ]
        )
