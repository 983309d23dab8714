"""Generic JSONL prompt dataset (the port of `areal_tpu/dataset/jsonl.py`):
each line {prompt | messages, answer?, ...}; a row without a `query_id`
gets its line number."""

import json
from typing import Optional

from areal_tpu_torch.dataset import register_dataset


def read_jsonl(path: str):
    """The JSON objects of a .jsonl file's non-empty lines."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def prompt_ids(tokenizer, row):
    """A row's prompt tokens: the chat template over `messages`, else
    `prompt` encoded."""
    if "messages" in row:
        return tokenizer.apply_chat_template(row["messages"], add_generation_prompt=True,
                                             tokenize=True)
    return tokenizer.encode(row["prompt"])


@register_dataset("jsonl")
def load_jsonl(path: str, split: str = "train", tokenizer=None,
               max_length: Optional[int] = None, **kwargs):
    rows = read_jsonl(path)
    for i, row in enumerate(rows):
        row.setdefault("query_id", str(i))
    if max_length is not None and tokenizer is not None:
        rows = [r for r in rows if len(prompt_ids(tokenizer, r)) <= max_length]
    return rows
