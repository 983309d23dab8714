"""GSM8K-style supervised finetuning: the port of `examples/sft/gsm8k_sft.py`.

    python -m areal_tpu_torch.examples.sft.gsm8k_sft                  # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.examples.sft.gsm8k_sft --device cpu --model tiny total_train_steps=3

Each (prompt, solution) pair becomes one row whose loss mask covers the
solution and its eos only (`dataset/gsm8k_synth.py sft_example`); a step
is one `TorchLMEngine.train_lm` (the token cross-entropy, ppl and token
accuracy), then the saver's check and one StatsLogger line, also printed
as JSON; the last step's weights are saved under "final".  The config is
an `SFTConfig` with the values of `examples/sft/gsm8k_sft.yaml`, with the
in-repo gsm8k-synth problems and their `WordTokenizer` in place of
openai/gsm8k and a tokenizer, and random weights from a seed unless
`model.path` names a checkpoint; `key.sub=value` overrides change any
field.
"""

import argparse
import json
import logging
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.config import (
    ClusterSpecConfig,
    DatasetConfig,
    MicroBatchSpec,
    OptimizerConfig,
    SaverConfig,
    SFTConfig,
    StatsLoggerConfig,
    TrainEngineConfig,
)
from areal_tpu_torch.examples.math.gsm8k_grpo import (
    MODELS,
    apply_overrides,
    model_config_for,
    resolve_fileroot,
)



def default_config() -> SFTConfig:
    """`examples/sft/gsm8k_sft.yaml`, on gsm8k-synth with random weights."""
    return SFTConfig(
        experiment_name="gsm8k-sft", trial_name="trial0", seed=1, total_train_epochs=1,
        cluster=ClusterSpecConfig(fileroot=""),
        train_dataset=DatasetConfig(path="gsm8k-synth", type="gsm8k-synth", batch_size=8,
                                    shuffle=True, drop_last=True, max_length=1024),
        model=TrainEngineConfig(
            path="", init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
            mb_spec=MicroBatchSpec(n_mbs=2),
            optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="cosine",
                                      warmup_steps_proportion=0.03, weight_decay=0.01)),
        saver=SaverConfig(freq_steps=100),
        stats_logger=StatsLoggerConfig(),
    )


def parse_args(argv: Optional[List[str]], default: Callable[[], Any], description: str):
    """`--device`, `--model` and `key.sub=value` overrides; the tiny model
    runs in f32 on 256-token row quanta."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--model", default="qwen2.5-1.5b", choices=MODELS,
                   help="the model shape when model.path is empty")
    p.add_argument("overrides", nargs="*", help="key.sub=value, e.g. total_train_steps=2")
    args = p.parse_intermixed_args(argv)
    config = default()
    if args.model == "tiny":
        config.model.dtype = "float32"
        config.model.pack_length_quantum = 256
        config.model.max_pack_length = 1024
    apply_overrides(config, args.overrides)
    return config, args


def collate(samples: List[Dict[str, Any]], tokenizer) -> Dict[str, np.ndarray]:
    from areal_tpu_torch.dataset.gsm8k_synth import sft_example
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    return pad_sequences_to_tensors([sft_example(tokenizer, s) for s in samples])


def train_loop(config, engine, dataset, collate_fn: Callable, step_fn: Callable, scope: str,
               ft_spec, on_step: Optional[Callable] = None) -> List[Dict[str, float]]:
    """The SFT and reward-model loops: a step a batch of the dataloader
    (`collate_fn` -> `step_fn` on the engine), the saver's check, a
    StatsLogger line (also printed as JSON), until `total_train_steps` or
    the epochs end; then the weights under "final".  Returns each step's
    stats."""
    from areal_tpu_torch.api.config import propagate_names
    from areal_tpu_torch.api.io_struct import SaveLoadMeta, StepInfo
    from areal_tpu_torch.utils import stats
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader
    from areal_tpu_torch.utils.saver import Saver
    from areal_tpu_torch.utils.stats_logger import StatsLogger

    propagate_names(config, resolve_fileroot(config))
    dataloader = StatefulDataLoader(dataset, batch_size=config.train_dataset.batch_size,
                                    shuffle=config.train_dataset.shuffle,
                                    drop_last=config.train_dataset.drop_last, seed=config.seed)
    steps_per_epoch = len(dataloader)
    total_steps = config.total_train_steps or config.total_train_epochs * steps_per_epoch
    saver = Saver(config.saver, ft_spec)
    stats_logger = StatsLogger(config.stats_logger)
    out: List[Dict[str, float]] = []
    step_info = StepInfo(global_step=0, epoch=0, epoch_step=0, steps_per_epoch=steps_per_epoch)
    try:
        global_step = 0
        for epoch in range(config.total_train_epochs):
            for epoch_step, samples in enumerate(dataloader):
                if global_step >= total_steps:
                    break
                with stats.DEFAULT_TRACKER.scope(scope):
                    st = step_fn(collate_fn(samples))
                    stats.DEFAULT_TRACKER.scalar(**{k: v for k, v in st.items()
                                                    if np.isscalar(v)})
                step_info = StepInfo(global_step=global_step, epoch=epoch,
                                     epoch_step=epoch_step, steps_per_epoch=steps_per_epoch)
                saver.save(engine, epoch, epoch_step, global_step)
                stats_logger.commit(epoch, epoch_step, global_step, [stats.export()])
                print(json.dumps({"step": global_step + 1, **st}), flush=True)
                out.append(st)
                if on_step is not None:
                    on_step(global_step, engine, st)
                global_step += 1
        engine.save(SaveLoadMeta(path=saver.save_path(step_info, "final")))
    finally:
        stats_logger.close()
    return out


def run(config: SFTConfig, device: Optional[str] = None, model: str = "qwen2.5-1.5b",
        on_step: Optional[Callable] = None) -> List[Dict[str, float]]:
    """The SFT loop; returns each step's stats (`train_lm`'s: loss, ppl,
    token_acc, grad_norm, step_time, mfu on the card)."""
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.dataset import get_custom_dataset
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer
    from areal_tpu_torch.engine.sft import TorchLMEngine
    from areal_tpu_torch.utils import seeding

    seeding.set_random_seed(config.seed, "sft")
    tokenizer = WordTokenizer()
    ds = config.train_dataset
    dataset = get_custom_dataset(ds.path, ds.type, "train", tokenizer, ds.max_length,
                                 seed=config.seed)
    ft_spec = FinetuneSpec(total_train_epochs=config.total_train_epochs,
                           dataset_size=len(dataset), train_batch_size=ds.batch_size)
    engine = TorchLMEngine(config.model,
                           model_config=None if config.model.path else model_config_for(model),
                           device=device)
    engine.initialize(ft_spec=ft_spec)
    try:
        return train_loop(config, engine, dataset, lambda s: collate(s, tokenizer),
                          engine.train_lm, "sft", ft_spec, on_step)
    finally:
        engine.destroy()


def main(argv: Optional[List[str]] = None) -> int:
    config, args = parse_args(argv, default_config, __doc__.split("\n\n")[0])
    run(config, device=args.device, model=args.model)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
