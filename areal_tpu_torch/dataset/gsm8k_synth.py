"""GSM8K-style synthetic math word problems + a closed-vocabulary tokenizer
(the port's copy of `areal_tpu/dataset/gsm8k_synth.py`), registered as
the `gsm8k-synth` dataset, with the SFT row builder `sft_example` and the
reward model's `preference_pair` (the port's own: a problem's correct
solution against the same with a wrong final answer).

Purpose (VERDICT r4 #1): the primary metric's quality half needs a
reward-vs-wall-clock curve from the REAL async GRPO loop.  This rig has
zero network egress — `openai/gsm8k` and pretrained checkpoints are both
unreachable (the reference trains Qwen on HF GSM8K,
areal/examples/math/gsm8k_grpo.py) — so the honest substitute is a
generator of grade-school word problems in GSM8K's shape (1-3 arithmetic
steps, natural-language surface, numeric answer) that a small from-scratch
model can genuinely learn: SFT teaches the format, then GRPO against the
real math reward (`reward/math_parser.py gsm8k_reward_fn`, exact-match on
\\boxed{}) must move accuracy.  Everything downstream is the production
path: RLVRWorkflow, the reward pool, the serving engine, decoupled PPO.

The tokenizer is word-level over the generator's closed vocabulary with
digits split per character (so arithmetic is learnable), and decode
re-spaces punctuation so the math parser sees literal `\\boxed{N}` syntax.
"""

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from areal_tpu_torch.dataset import register_dataset

NAMES = [
    "Alex", "Sara", "Ben", "Mia", "Leo", "Ana", "Tom", "Lily",
    "Omar", "Nina", "Sam", "Ruth", "Ivan", "Ada", "Hugo", "Vera",
]
OBJECTS = [
    "apples", "coins", "books", "pens", "cards", "shells", "stamps",
    "beads", "rocks", "cups", "kites", "rings", "seeds", "stars",
    "notes", "gems",
]

PROMPT_SUFFIX = (
    " Please reason step by step , and put your final answer within "
    "\\boxed{} ."
)

_TEMPLATE_WORDS = """
User: Assistant: has buys more How many does have now gives away There are
in each box boxes total shares equally among friends friend get and then
left loses of so Buying Giving leaves Each holds there starts with The
answer is Then gets Please reason step by put your final within
""".split()

_PUNCT = [".", ",", "?", "+", "-", "x", "/", "=", "\\boxed{", "}", "\n"]


class WordTokenizer:
    """Closed-vocabulary word tokenizer: words are atomic, numbers are
    digit sequences, `\\boxed{` and `}` are atomic so decode reproduces the
    exact syntax `extract_answer` parses.  Surface-compatible with the
    HF-tokenizer subset the workflows use (encode / decode /
    apply_chat_template / eos_token_id / pad_token_id)."""

    def __init__(self):
        vocab: List[str] = ["<pad>", "<eos>", "<unk>"]
        vocab += [str(d) for d in range(10)]
        vocab += _PUNCT
        seen = set(vocab)
        for w in _TEMPLATE_WORDS + NAMES + OBJECTS:
            if w not in seen:
                vocab.append(w)
                seen.add(w)
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.unk_token_id = 2

    def __len__(self):
        return len(self.vocab)

    def _chunk_tokens(self, chunk: str) -> List[str]:
        """Split one whitespace-delimited chunk into vocab symbols:
        longest-match over (boxed marker | word | digit | single char)."""
        out: List[str] = []
        i = 0
        while i < len(chunk):
            if chunk.startswith("\\boxed{", i):
                out.append("\\boxed{")
                i += len("\\boxed{")
                continue
            m = re.match(r"[A-Za-z]+:?", chunk[i:])
            if m and m.group(0) in self.token_to_id:
                out.append(m.group(0))
                i += len(m.group(0))
                continue
            out.append(chunk[i])
            i += 1
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for part in text.replace("\n", " \n ").split(" "):
            if not part:
                continue
            for tok in self._chunk_tokens(part):
                ids.append(self.token_to_id.get(tok, self.unk_token_id))
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, token_ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for t in token_ids:
            t = int(t)
            if 0 <= t < len(self.vocab):
                tok = self.vocab[t]
                if skip_special_tokens and t in (
                    self.pad_token_id, self.eos_token_id, self.unk_token_id
                ):
                    continue
                toks.append(tok)
        out: List[str] = []
        for i, tok in enumerate(toks):
            if not out:
                out.append(tok)
                continue
            prev = toks[i - 1]
            no_space = (
                (tok.isdigit() and prev.isdigit())  # digit runs: "3","7"->37
                or prev == "\\boxed{"
                or tok == "}"
            )
            out.append(tok if no_space else " " + tok)
        return "".join(out)

    def apply_chat_template(
        self,
        messages: List[Dict[str, str]],
        add_generation_prompt: bool = True,
        tokenize: bool = True,
        **kw,
    ):
        text = ""
        for m in messages:
            role = "User:" if m["role"] == "user" else "Assistant:"
            text += f"{role} {m['content']}\n"
        if add_generation_prompt:
            text += "Assistant:"
        if not tokenize:
            return text
        return self.encode(text)


@dataclass
class SynthProblem:
    question: str
    solution: str  # CoT ending in \boxed{answer}
    answer: str


def _gen_one(rng: np.random.Generator) -> SynthProblem:
    name = NAMES[int(rng.integers(len(NAMES)))]
    obj = OBJECTS[int(rng.integers(len(OBJECTS)))]
    kind = int(rng.integers(6))
    if kind == 0:  # add
        a, b = int(rng.integers(3, 60)), int(rng.integers(3, 60))
        s = a + b
        q = (f"{name} has {a} {obj} . {name} buys {b} more {obj} . "
             f"How many {obj} does {name} have now ?")
        sol = (f"{name} starts with {a} {obj} . Buying {b} more gives "
               f"{a} + {b} = {s} {obj} . The answer is \\boxed{{{s}}} .")
    elif kind == 1:  # sub
        a = int(rng.integers(10, 95))
        b = int(rng.integers(2, a))
        s = a - b
        q = (f"{name} has {a} {obj} . {name} gives away {b} {obj} . "
             f"How many {obj} does {name} have left ?")
        sol = (f"{name} starts with {a} {obj} . Giving away {b} leaves "
               f"{a} - {b} = {s} {obj} . The answer is \\boxed{{{s}}} .")
    elif kind == 2:  # mul
        a, b = int(rng.integers(2, 10)), int(rng.integers(3, 25))
        s = a * b
        q = (f"There are {a} {obj} in each box . {name} has {b} boxes . "
             f"How many {obj} in total ?")
        sol = (f"Each box holds {a} {obj} and there are {b} boxes , so "
               f"{a} x {b} = {s} {obj} . The answer is \\boxed{{{s}}} .")
    elif kind == 3:  # div
        b = int(rng.integers(2, 10))
        s = int(rng.integers(2, 13))
        a = b * s
        q = (f"{name} shares {a} {obj} equally among {b} friends . "
             f"How many {obj} does each friend get ?")
        sol = (f"{a} / {b} = {s} , so each friend gets {s} {obj} . "
               f"The answer is \\boxed{{{s}}} .")
    elif kind == 4:  # add then sub
        a, b = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        t = a + b
        c = int(rng.integers(2, t))
        s = t - c
        q = (f"{name} has {a} {obj} . {name} buys {b} more and then "
             f"gives away {c} . How many {obj} are left ?")
        sol = (f"{a} + {b} = {t} . Then {t} - {c} = {s} . "
               f"The answer is \\boxed{{{s}}} .")
    else:  # mul then sub
        a, b = int(rng.integers(2, 10)), int(rng.integers(3, 15))
        t = a * b
        c = int(rng.integers(2, t))
        s = t - c
        q = (f"{name} buys {b} boxes of {a} {obj} each and then loses "
             f"{c} . How many {obj} are left ?")
        sol = (f"{a} x {b} = {t} . Then {t} - {c} = {s} . "
               f"The answer is \\boxed{{{s}}} .")
    return SynthProblem(question=q, solution=sol, answer=str(s))


def generate_problems(n: int, seed: int = 0) -> List[Dict]:
    """n dataset items in the gsm8k loader's shape (dataset/gsm8k.py):
    {messages, query_id, answer} plus `solution` for SFT warm-starts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = _gen_one(rng)
        out.append({
            "messages": [
                {"role": "user", "content": p.question + PROMPT_SUFFIX}
            ],
            "query_id": str(i),
            "answer": p.answer,
            "solution": p.solution,
        })
    return out


@register_dataset("gsm8k-synth")
def get_gsm8k_synth_dataset(path: str = "", split: str = "train", tokenizer=None,
                            max_length: Optional[int] = None, n: int = 1024, seed: int = 1,
                            **kwargs) -> List[Dict]:
    """`n` problems drawn under `seed` for the train split and `seed + 1`
    for any other (the generator has no fixed test split), each with its
    prompt's `input_ids` when a tokenizer is given; with `max_length`,
    only prompts that fit."""
    rows = generate_problems(n, seed=seed if split == "train" else seed + 1)
    if tokenizer is not None:
        for r in rows:
            r["input_ids"] = tokenizer.apply_chat_template(r["messages"],
                                                           add_generation_prompt=True)
        if max_length is not None:
            rows = [r for r in rows if len(r["input_ids"]) <= max_length]
    return rows


def sft_example(tokenizer: WordTokenizer, item: Dict) -> Dict[str, np.ndarray]:
    """(input_ids, loss_mask) for one SFT row: the loss on the assistant's
    solution and eos only, the convention `TorchLMEngine.train_lm` reads."""
    prompt_ids = tokenizer.apply_chat_template(item["messages"], add_generation_prompt=True)
    sol_ids = tokenizer.encode(" " + item["solution"]) + [tokenizer.eos_token_id]
    ids = np.asarray(prompt_ids + sol_ids, np.int32)
    mask = np.asarray([0] * len(prompt_ids) + [1] * len(sol_ids), np.int32)
    return {"input_ids": ids, "loss_mask": mask, "attention_mask": np.ones_like(ids)}


_BOXED = re.compile(r"\\boxed\{(\d+)\}")


def preference_pair(tokenizer: WordTokenizer, item: Dict,
                    rng: np.random.Generator) -> Dict[str, List[int]]:
    """A reward model's pair from one problem: chosen, the prompt with its
    correct solution; rejected, the same with the final answer moved by 1
    to 9.  Both end in eos."""
    prompt = tokenizer.apply_chat_template(item["messages"], add_generation_prompt=True)
    wrong = str(int(item["answer"]) + int(rng.integers(1, 10)))
    rejected = _BOXED.sub(lambda m: "\\boxed{" + wrong + "}", item["solution"])
    eos = [tokenizer.eos_token_id]
    return {"chosen_ids": prompt + tokenizer.encode(" " + item["solution"]) + eos,
            "rejected_ids": prompt + tokenizer.encode(" " + rejected) + eos}
