"""η-staleness ablation of the port: decoupled PPO against naive PPO under
stale rollouts.

    python -m areal_tpu_torch.scripts.staleness_ablation --steps 120 --seeds 0 1   # on the card
    python -m areal_tpu_torch.scripts.staleness_ablation --device cpu --steps 2 \\
        --sft-steps 2 --etas 0 1

The counterpart of `scripts/staleness_ablation.py`, which reproduces the
*shape* of AReaL's ablation: with the decoupled objective, training
quality stays near the zero-staleness oracle for η ≤ 4, while naive PPO
(the ratio against the stale behaviour policy) degrades as η grows.

A 4-layer / 256-wide Qwen2-class transformer learns single-digit-sum
arithmetic ("Q: 3 + 4 = ? A:").  A short SFT warm start gives the policy a
format prior; GRPO then improves accuracy with rollouts that are η policy
versions stale: a FIFO holds the last η batches, so at step t the trainer
consumes the batch *generated by the policy of step t - η*, while
generation always uses the newest policy.  `--interrupts k` adds the second
axis: every k-th training batch is generated interrupted, its first half by
the η-old policy and the rest under the current one (per-token versions).

The reference's tokenizer is a byte-level BPE trained on the fly
(`tokenizers` and `transformers`); this script carries its own,
`ArithmeticTokenizer`, one token a character of the task's closed
alphabet.  Both spell an answer as a space token and a digit token, so the
SFT mask and the reward read the same positions.  Every function that
touches text takes the tokenizer as an argument.

Sampling draws from an explicit `torch.Generator` (seeded per run), one
full forward per generated token, as the reference does with its JAX key.

Writes STALENESS_ABLATION_torch.json (and prints a summary table).
"""

import argparse
import collections
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.config import (
    MeshConfig,
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
)
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.models.transformer import build_model, forward
from areal_tpu_torch.ops.functional import sft_loss_fn

GROUP = 4
PROMPTS_PER_BATCH = 32  # x GROUP samples = 128 rows
GEN = 3  # enough for " 7" style answers


class ArithmeticTokenizer:
    """Character tokenizer over the task's closed alphabet (the subset of
    the HF tokenizer surface the task uses: `encode`, `decode`,
    `vocab_size`).  Id 0 pads and decodes to nothing; a character outside
    the alphabet encodes as `<unk>`."""

    SPECIAL = ("<pad>", "<unk>")
    ALPHABET = " 0123456789QA:+=?"

    def __init__(self):
        self.vocab = list(self.SPECIAL) + list(self.ALPHABET)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        self.pad_token_id = 0
        self.unk_token_id = 1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return [self.token_to_id.get(c, self.unk_token_id) for c in text]

    def decode(self, token_ids) -> str:
        return "".join(self.vocab[int(t)] for t in token_ids
                       if len(self.SPECIAL) <= int(t) < len(self.vocab))


def _problems(rng: np.random.Generator, n: int):
    # sums capped at 9: single-digit answers keep the reward surface sharp
    # for a scratch model (the ablation is about off-policy dynamics, not
    # arithmetic depth)
    a = rng.integers(0, 10, n)
    b = np.array([rng.integers(0, 10 - x) for x in a])
    return a, b, a + b


def _encode_prompts(tok, a, b):
    return [tok.encode(f"Q: {x} + {y} = ? A:", add_special_tokens=False) for x, y in zip(a, b)]


class Task:
    """Tokenised arithmetic episodes + reward."""

    def __init__(self, tok, max_prompt: int, L: int):
        self.tok = tok
        self.max_prompt = max_prompt
        self.L = L

    def batch_prompts(self, rng):
        a, b, ans = _problems(rng, PROMPTS_PER_BATCH)
        enc = _encode_prompts(self.tok, a, b)
        return enc, np.repeat(ans, GROUP)

    def reward(self, completion_text: str, answer: int) -> float:
        digits = "".join(c for c in completion_text if c.isdigit() or c == " ")
        toks = digits.split()
        return 1.0 if toks and toks[0] == str(answer) else 0.0


def _model_cfg(vocab: int, L: int):
    return tiny_config(
        vocab_size=vocab,
        hidden_size=256,
        intermediate_size=704,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        qkv_bias=True,
        max_position_embeddings=2 * L,
        dtype="float32",
        eos_token_id=None,
        hf_architecture="Qwen2ForCausalLM",
    )


@torch.no_grad()
def _sample_batch(actor, mcfg, task, rng_np, gen: torch.Generator, temperature=1.0,
                  phases=None):
    """Generate GEN tokens per row; returns the trajectory dict with
    behaviour logprobs, rewards, loss masks and per-token versions.

    `phases` = [(model, n_tokens, version), ...] models INTERRUPTED
    generation: a weight update lands mid-trajectory, so the first tokens
    come from an older policy and the rest from a newer one.  Default: one
    phase under the actor's current model."""
    enc, answers = task.batch_prompts(rng_np)
    enc = [e[: task.max_prompt] for e in enc]
    plens = np.array([len(e) for e in enc]).repeat(GROUP)
    B = PROMPTS_PER_BATCH * GROUP
    L = task.L
    ids = np.zeros((B, L), np.int64)
    for i, e in enumerate(np.repeat(np.arange(PROMPTS_PER_BATCH), GROUP)):
        ids[i, : len(enc[e])] = enc[e]
    logps = np.zeros((B, L), np.float32)
    versions = np.zeros((B, L), np.int32)
    if phases is None:
        phases = [(actor.model, GEN, 0)]
    assert sum(n for _, n, _ in phases) == GEN
    dev = actor.device
    pos = torch.arange(L, device=dev).expand(B, L)
    seg = torch.zeros((B, L), dtype=torch.int32, device=dev)
    row = torch.arange(B, device=dev)
    plens_d = torch.from_numpy(plens).to(dev)
    ids_d = torch.from_numpy(ids).to(dev)
    t = 0
    for model, n_tokens, ver in phases:
        for _ in range(n_tokens):
            logits = forward(model, ids_d, pos, seg).float()
            cur = logits[row, plens_d + t - 1] / temperature
            lsm = torch.log_softmax(cur, dim=-1)
            tok = torch.multinomial(lsm.exp(), 1, generator=gen)[:, 0]
            ids_d[row, plens_d + t] = tok
            logps[np.arange(B), plens + t] = lsm[row, tok].cpu().numpy()
            versions[np.arange(B), plens + t] = ver
            t += 1
    ids = ids_d.cpu().numpy()

    rewards = np.zeros(B, np.float32)
    for i in range(B):
        comp = task.tok.decode(ids[i, plens[i]: plens[i] + GEN].tolist())
        rewards[i] = task.reward(comp, int(answers[i]))
    mask = np.zeros((B, L), bool)
    loss_mask = np.zeros((B, L), np.float32)
    for i in range(B):
        mask[i, : plens[i] + GEN] = True
        loss_mask[i, plens[i]: plens[i] + GEN] = 1.0
    return {
        "input_ids": ids.astype(np.int32),
        "attention_mask": mask,
        "loss_mask": loss_mask,
        "logprobs": logps,
        "rewards": rewards,
        "versions": versions,
    }


def _sft_warmstart(actor, task, steps: int, rng_np):
    """Teach the answer format (and some arithmetic) supervised, so RL
    starts from a model whose samples earn nonzero reward — the ablation
    compares RL dynamics, not exploration from noise.  The mask is the
    reference's: 1 on the answer's tokens, token-aligned, straight into
    `train_batch` with `sft_loss_fn`."""
    L = task.L
    for _ in range(steps):
        a, b, ans = _problems(rng_np, PROMPTS_PER_BATCH)
        rows, masks, lmask = [], [], []
        for x, y, z in zip(a, b, ans):
            e = task.tok.encode(f"Q: {x} + {y} = ? A: {z}", add_special_tokens=False)[:L]
            p = task.tok.encode(f"Q: {x} + {y} = ? A:", add_special_tokens=False)
            row = np.zeros(L, np.int32)
            row[: len(e)] = e
            m = np.zeros(L, bool)
            m[: len(e)] = True
            lm = np.zeros(L, np.float32)
            lm[len(p): len(e)] = 1.0
            rows.append(row)
            masks.append(m)
            lmask.append(lm)
        batch = {
            "input_ids": np.stack(rows),
            "attention_mask": np.stack(masks),
            "loss_mask": np.stack(lmask),
        }
        actor.train_batch(batch, sft_loss_fn, lambda b: float(np.sum(b["loss_mask"])))


def _task_setup(tok):
    max_prompt = max(
        len(e) for e in _encode_prompts(tok, *_problems(np.random.default_rng(0), 64)[:2]))
    L = max_prompt + GEN
    return Task(tok, max_prompt, L), _model_cfg(tok.vocab_size, L)


def _make_actor(task, mcfg, eta, decoupled, lr, steps, device=None):
    cfg = PPOActorConfig(
        init_from_scratch=True,
        dtype="float32",
        param_dtype="float32",
        gradient_checkpointing=False,
        mesh=MeshConfig(),
        mb_spec=MicroBatchSpec(n_mbs=1),
        optimizer=OptimizerConfig(lr=lr, warmup_steps_proportion=0.0, weight_decay=0.0,
                                  gradient_clipping=1.0),
        pack_length_quantum=task.L,
        max_pack_length=2 * task.L,
        group_size=GROUP,
        ppo_n_minibatches=4,  # >1 magnifies off-policy damage, as in PPO lore
        eps_clip=0.2,
        use_decoupled_loss=decoupled,
        recompute_logprob=decoupled,
        behav_imp_weight_cap=5.0 if decoupled else None,
        adv_norm=NormConfig(mean_level="group", std_level="group", group_size=GROUP),
        temperature=1.0,
    )
    actor = TorchPPOActor(cfg, model_config=mcfg, device=device)
    actor.initialize(ft_spec=FinetuneSpec(1, steps * PROMPTS_PER_BATCH, PROMPTS_PER_BATCH))
    return actor


def _state(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def _load(model, state: Dict[str, torch.Tensor]) -> None:
    for n, p in model.named_parameters():
        p.copy_(state[n])


def warmstart_params(tok, seed: int, sft_steps: int, sft_lr: float = 1e-3, device=None):
    """SFT-warm-started parameters (on the host), computed once per seed
    and shared by every (η, objective) RL config: the ablation varies the
    RL dynamics, not the starting point."""
    task, mcfg = _task_setup(tok)
    actor = _make_actor(task, mcfg, 0, True, sft_lr, sft_steps + 1, device)
    rng_np = np.random.default_rng(seed)
    _sft_warmstart(actor, task, sft_steps, rng_np)
    host = {n: t.cpu() for n, t in _state(actor.model).items()}
    actor.destroy()
    return host


def run(eta: int, decoupled: bool, steps: int, tok, warm_params, seed: int = 0,
        lr: float = 1e-4, interrupt_every: int = 0, device=None,
        consumed: Optional[List[tuple]] = None, update_stats: Optional[List[dict]] = None):
    """Train with rollouts that are `eta` policy versions stale; returns the
    per-step reward curve (the reward of the FRESH batch generated each
    step, i.e. the current policy's quality).  `consumed`, when given,
    gets (training step, step that generated its batch) per update.

    `interrupt_every=k` (> 0) adds the second axis: every k-th training
    batch is generated interrupted — its first half by the policy η steps
    old, the rest under the current one.  The other batches stay uniformly
    η-stale through the FIFO."""
    task, mcfg = _task_setup(tok)
    actor = _make_actor(task, mcfg, eta, decoupled, lr, steps, device)
    _load(actor.model, warm_params)
    rng_np = np.random.default_rng(seed + 1000)  # disjoint from the SFT stream
    gen = torch.Generator(device=actor.device).manual_seed(seed)
    fifo = collections.deque()
    params_hist = collections.deque(maxlen=eta + 1)  # device copies (a tiny model)
    old_model = None
    curve = []
    trained = 0
    for step in range(steps):
        params_hist.append(_state(actor.model))
        fresh = _sample_batch(actor, mcfg, task, rng_np, gen)
        fresh["gen_step"] = step
        curve.append(float(fresh["rewards"].mean()))
        fifo.append(fresh)
        if len(fifo) <= eta:
            continue  # warm-up: nothing old enough to train on yet
        if interrupt_every > 0 and eta > 0 and trained % interrupt_every == 0 \
                and len(params_hist) > eta:
            # the interrupted batch replaces the FIFO one this step: phase A
            # under the η-old policy, phase B resumed under the current one
            fifo.popleft()
            if old_model is None:
                old_model = build_model(actor.model_config, actor.device, "float32")
            _load(old_model, params_hist[0])
            batch = _sample_batch(actor, mcfg, task, rng_np, gen,
                                  phases=[(old_model, GEN // 2, step - eta),
                                          (actor.model, GEN - GEN // 2, step)])
            batch["gen_step"] = step - eta
        else:
            batch = dict(fifo.popleft())  # generated by the policy η steps ago
        if consumed is not None:
            consumed.append((step, batch["gen_step"]))
        batch = {k: v for k, v in batch.items() if k != "gen_step"}
        if decoupled:
            batch["prox_logp"] = actor.compute_logp(batch)
        actor.compute_advantages(batch)
        stats = actor.ppo_update(batch)
        if update_stats is not None:
            update_stats.extend(stats)
        trained += 1
    actor.destroy()
    return curve


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--etas", type=int, nargs="+", default=[0, 1, 2, 4])
    p.add_argument("--interrupts", type=int, nargs="+", default=[0],
                   help="second axis: 0 = pure FIFO staleness; k > 0 = every k-th training "
                        "batch is generated interrupted (first half by the eta-old policy, "
                        "second half resumed under the current one)")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--lr", type=float, default=1e-4, help="RL learning rate")
    p.add_argument("--sft-lr", type=float, default=1e-3)
    p.add_argument("--sft-steps", type=int, default=1600)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default="STALENESS_ABLATION_torch.json")
    args = p.parse_args(argv)

    tok = ArithmeticTokenizer()
    device = "cuda" if args.device is None else args.device
    kind = torch.cuda.get_device_name(device) if device.startswith("cuda") else "cpu"
    results = {
        "task": "single-digit-sum QA; reward=1 iff first emitted number equals the answer",
        "setup": {
            "model": "4-layer/256-hidden Qwen2-class (qkv-bias, GQA), character tokenizer "
                     f"vocab {tok.vocab_size}",
            "warmstart": f"{args.sft_steps} SFT steps (lr {args.sft_lr}) shared across all RL "
                         "configs per seed",
            "batch": f"{PROMPTS_PER_BATCH} prompts x {GROUP} GRPO samples",
            "optimizer": f"adamw rl-lr={args.lr}, 4 ppo minibatches per batch",
            "staleness": "FIFO: step t trains on the batch generated by the policy from "
                         "step t-eta",
            "steps": args.steps,
            "seeds": args.seeds,
            "device_kind": kind,
        },
        "results": {},
    }
    warm = {s: warmstart_params(tok, s, args.sft_steps, args.sft_lr, device)
            for s in args.seeds}
    print("warm-start ready", flush=True)
    for eta in args.etas:
        for dec in (True, False):
            for intr in args.interrupts:
                if intr > 0 and eta == 0:
                    continue  # interruption needs an older policy
                name = f"eta{eta}_{'decoupled' if dec else 'naive'}"
                if intr > 0:
                    name += f"_int{intr}"
                curves = [run(eta, dec, args.steps, tok, warm[s], seed=s, lr=args.lr,
                              interrupt_every=intr, device=device)
                          for s in args.seeds]
                final = float(np.mean([np.mean(c[-20:]) for c in curves]))
                results["results"][name] = {"final_reward": final, "curves": curves}
                print(f"{name}: final reward {final:.3f}", flush=True)
                with open(args.out, "w") as f:  # incremental: a long run
                    json.dump(results, f, indent=2)

    print(f"\nwrote {args.out}")
    # the acceptance shape: at the largest η, decoupled stays near the η=0
    # oracle while naive falls behind
    e = max(args.etas)
    res = results["results"]
    if e > 0 and "eta0_decoupled" in res and f"eta{e}_naive" in res \
            and f"eta{e}_decoupled" in res:
        print(f"shape check @ eta={e}: oracle={res['eta0_decoupled']['final_reward']:.3f} "
              f"decoupled={res[f'eta{e}_decoupled']['final_reward']:.3f} "
              f"naive={res[f'eta{e}_naive']['final_reward']:.3f}")


if __name__ == "__main__":
    main()
