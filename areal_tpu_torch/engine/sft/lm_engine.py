"""Supervised finetuning engine (the port of
`areal_tpu/engine/sft/lm_engine.py` `JaxLMEngine`): token cross-entropy
over the completion tokens, normalised by the whole batch's valid-token
count, through the actor's row-packed path and flash kernels."""

from typing import Dict

import numpy as np

from areal_tpu_torch.engine.torch_train import TorchTrainEngine
from areal_tpu_torch.ops.functional import sft_loss_fn


def _weight(batch: Dict[str, np.ndarray]) -> float:
    return float(np.sum(batch["loss_mask"]))


def _ppl(stats: Dict[str, float]) -> float:
    n = max(stats.get("n_valid_tokens", 1.0), 1.0)
    return float(np.exp(min(stats["loss_sum"] / n, 30.0)))


class TorchLMEngine(TorchTrainEngine):
    """Trajectory convention: `loss_mask[t] = 1` iff token t is a completion
    token; the engine shifts it to predictor alignment itself."""

    @staticmethod
    def _predictor_align(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        mask = np.roll(batch["loss_mask"].astype(np.float32), -1, axis=-1)
        mask[:, -1] = 0.0
        out["loss_mask"] = mask * batch["attention_mask"]
        return out

    def train_lm(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        stats = self.train_batch(self._predictor_align(batch), sft_loss_fn, _weight)
        stats["ppl"] = _ppl(stats)
        stats["token_acc"] = (stats.get("correct_tokens", 0.0)
                              / max(stats.get("n_valid_tokens", 1.0), 1.0))
        return stats

    def evaluate_lm(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        stats = self.eval_batch(self._predictor_align(batch), sft_loss_fn, _weight)
        stats["ppl"] = _ppl(stats)
        return stats
