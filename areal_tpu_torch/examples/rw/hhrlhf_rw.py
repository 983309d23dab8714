"""Bradley-Terry reward-model training: the port of `examples/rw/hhrlhf_rw.py`.

    python -m areal_tpu_torch.examples.rw.hhrlhf_rw                   # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.examples.rw.hhrlhf_rw --device cpu --model tiny total_train_steps=3
    python -m areal_tpu_torch.examples.rw.hhrlhf_rw train_dataset.type=hhrlhf \\
        train_dataset.path=pairs.jsonl

A batch interleaves its pairs, rows 2i chosen and 2i + 1 rejected, which
`TorchRewardModelEngine.train_rw` lays out one sequence a row and scores
at each sequence's last token; a step is one `train_rw` (loss, pair
accuracy, margin), the saver's check and one StatsLogger line, also
printed as JSON (the SFT example's loop).  The config is an `RWConfig`
with the values of `examples/rw/hhrlhf_rw.yaml`.  The HH-RLHF pairs are
not in the repository: by default the pairs are gsm8k-synth problems, the
correct solution chosen and the same with a wrong final answer rejected
(`dataset/gsm8k_synth.py preference_pair`), under the `WordTokenizer`;
`train_dataset.type=hhrlhf` reads a local .jsonl of chosen/rejected texts
instead.  The weights are random from a seed unless `model.path` names a
checkpoint.
"""

import logging
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.config import (
    ClusterSpecConfig,
    DatasetConfig,
    MicroBatchSpec,
    OptimizerConfig,
    RWConfig,
    SaverConfig,
    StatsLoggerConfig,
    TrainEngineConfig,
)
from areal_tpu_torch.examples.math.gsm8k_grpo import model_config_for
from areal_tpu_torch.examples.sft.gsm8k_sft import parse_args, train_loop



def default_config() -> RWConfig:
    """`examples/rw/hhrlhf_rw.yaml`, on gsm8k-synth pairs with random weights."""
    return RWConfig(
        experiment_name="hhrlhf-rw", trial_name="trial0", seed=1, total_train_epochs=1,
        cluster=ClusterSpecConfig(fileroot=""),
        train_dataset=DatasetConfig(path="gsm8k-synth", type="gsm8k-synth", batch_size=4,
                                    shuffle=True, drop_last=True, max_length=1024),
        model=TrainEngineConfig(
            path="", init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
            mb_spec=MicroBatchSpec(n_mbs=2),
            optimizer=OptimizerConfig(lr=5e-6, lr_scheduler_type="cosine",
                                      warmup_steps_proportion=0.03)),
        saver=SaverConfig(freq_steps=200),
        stats_logger=StatsLoggerConfig(),
    )


def synth_pairs(n: int, seed: int, tokenizer) -> List[Dict[str, List[int]]]:
    """`n` preference pairs from the gsm8k-synth problems drawn under `seed`."""
    from areal_tpu_torch.dataset.gsm8k_synth import generate_problems, preference_pair

    rng = np.random.default_rng(seed)
    return [preference_pair(tokenizer, item, rng) for item in generate_problems(n, seed=seed)]


def collate(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Interleave the pairs: row 2i chosen, row 2i + 1 rejected."""
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    rows = [{"input_ids": np.asarray(s[k], np.int32)}
            for s in samples for k in ("chosen_ids", "rejected_ids")]
    return pad_sequences_to_tensors(rows)


def run(config: RWConfig, device: Optional[str] = None, model: str = "qwen2.5-1.5b",
        on_step: Optional[Callable] = None) -> List[Dict[str, float]]:
    """The reward-model loop; returns each step's `train_rw` stats."""
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.dataset import get_custom_dataset
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer
    from areal_tpu_torch.engine.rw import TorchRewardModelEngine
    from areal_tpu_torch.utils import seeding

    seeding.set_random_seed(config.seed, "rw")
    tokenizer = WordTokenizer()
    ds = config.train_dataset
    if ds.type == "gsm8k-synth":
        dataset = [p for p in synth_pairs(1024, config.seed, tokenizer)
                   if max(map(len, p.values())) <= (ds.max_length or 1 << 30)]
    else:
        dataset = get_custom_dataset(ds.path, ds.type, "train", tokenizer, ds.max_length)
    ft_spec = FinetuneSpec(total_train_epochs=config.total_train_epochs,
                           dataset_size=len(dataset), train_batch_size=ds.batch_size)
    engine = TorchRewardModelEngine(
        config.model, model_config=None if config.model.path else model_config_for(model),
        device=device)
    engine.initialize(ft_spec=ft_spec)
    try:
        return train_loop(config, engine, dataset, collate, engine.train_rw, "rw", ft_spec,
                          on_step)
    finally:
        engine.destroy()


def main(argv: Optional[List[str]] = None) -> int:
    config, args = parse_args(argv, default_config, __doc__.split("\n\n")[0])
    run(config, device=args.device, model=args.model)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
