"""HH-RLHF-style preference pairs for reward-model training (the port of
`areal_tpu/dataset/hhrlhf.py`): a local `.jsonl` of {"chosen": str,
"rejected": str} rows becomes {"chosen_ids", "rejected_ids"} token lists,
each ending in the tokenizer's eos, the pairwise format
`engine/rw/rw_engine.py` interleaves.  The reference also takes an HF
dataset id through HF `datasets`; the port reads local files only."""

from typing import Optional

from areal_tpu_torch.dataset import register_dataset
from areal_tpu_torch.dataset.jsonl import read_jsonl


def _encode(tokenizer, text: str):
    ids = list(tokenizer.encode(text))
    eos = getattr(tokenizer, "eos_token_id", None)
    return ids + [eos] if eos is not None else ids


@register_dataset("hhrlhf")
def get_hhrlhf_rw_dataset(path: str, split: str = "train", tokenizer=None,
                          max_length: Optional[int] = None, **kwargs):
    if tokenizer is None:
        raise ValueError("hhrlhf needs a tokenizer to build preference pairs")
    if not path.endswith((".jsonl", ".json")):
        raise ValueError(f"hhrlhf reads a local .jsonl file of chosen/rejected rows, not {path!r}")
    rows = [{"chosen_ids": _encode(tokenizer, r["chosen"]),
             "rejected_ids": _encode(tokenizer, r["rejected"])} for r in read_jsonl(path)]
    if max_length is not None:
        rows = [r for r in rows
                if len(r["chosen_ids"]) <= max_length and len(r["rejected_ids"]) <= max_length]
    return rows
