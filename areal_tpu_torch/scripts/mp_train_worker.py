"""One rank of multi-process PPO training over a (dp, sp) mesh (the port's
counterpart of the JAX package's `tests/mp/train_worker.py`).

Start one process a rank with the env contract of
`parallel/distributed.py` (AREAL_COORDINATOR, AREAL_NUM_PROCESSES,
AREAL_PROCESS_ID), or one process alone for the single-rank baseline:

    AREAL_COORDINATOR=127.0.0.1:29500 AREAL_NUM_PROCESSES=2 AREAL_PROCESS_ID=0 \\
        python -m areal_tpu_torch.scripts.mp_train_worker --meshes 1x2 &
    AREAL_COORDINATOR=127.0.0.1:29500 AREAL_NUM_PROCESSES=2 AREAL_PROCESS_ID=1 \\
        python -m areal_tpu_torch.scripts.mp_train_worker --meshes 1x2

Each rank joins the group (`init_distributed`; the backend follows from
the layout: two ranks on one card use gloo), then for each case of
`--meshes` (DPxSP[:DTYPE[:LAYERS]]: the compute dtype, bfloat16 by
default, and the depth, the model's by default) builds `TorchPPOActor`
with
`TrainEngineConfig.mesh = MeshConfig(dp, sp)`, takes the head's rollout
through `DistRolloutCoordinator` (the head makes the seeded batch, every
rank receives it), and runs `compute_logp`, `compute_advantages` and
`--steps` `ppo_update`s.  `--checks` first exercises the data plane:
`broadcast_pytree`, the shards of `make_global_batch`, and the sequence
gather, sum-scatter and sum.  Every result is one `RESULT {json}` line on
standard output (the head also prints its logprobs): the backend, the
flash kernels' launches, each step's loss and grad norm, a digest of the
parameters after each step (equal digests: bit-equal parameters), the
seconds spent in collectives, and the peak device memory.

On the CPU the model is `--model tiny` (head dim 128, so the flash path
runs its plain versions); on the card it is Qwen2.5-1.5B at full width,
from seeded random weights, or `--ckpt` (an HF checkpoint dir) on
either.
"""

import argparse
import base64
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.config import MeshConfig, NormConfig, OptimizerConfig, PPOActorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.core.dist_rollout import DistRolloutCoordinator
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.launcher.local import find_free_port
from areal_tpu_torch.models.model_config import TransformerConfig, qwen25_1p5b, tiny_config
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.parallel import distributed
from areal_tpu_torch.parallel.mesh import build_mesh


def model_config(name: str, layers: Optional[int] = None) -> TransformerConfig:
    """`tiny` (2 layers, head dim 128, the CPU tests' size) or Qwen2.5-1.5B
    at full width, `layers` deep."""
    if name == "tiny":
        mc = tiny_config(vocab_size=128, hidden_size=256, intermediate_size=512, num_heads=2,
                         num_kv_heads=1, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
    elif name == "qwen2.5-1.5b":
        mc = qwen25_1p5b()
    else:
        raise ValueError(f"unknown model {name!r}: tiny or qwen2.5-1.5b")
    return mc.replace(num_layers=layers) if layers else mc


# the batch of each model: (prompts, group, prompt lengths, new tokens, row
# length, PPO minibatches)
BATCH_SHAPES = {
    "tiny": (4, 2, (16, 64), 160, 256, 1),
    # the train phase's shape: 8 prompts x group 4, 128..512-token prompts,
    # 256 new tokens, 1024-token rows, two minibatches an update (16 rows each)
    "qwen2.5-1.5b": (8, 4, (128, 513), 256, 1024, 2),
}


def make_batch(vocab: int, model: str, seed: int = 7) -> Dict[str, np.ndarray]:
    """The seeded rollout batch: token-aligned, each sequence a prompt and
    its completion (loss mask on the completion), behaviour logprobs near
    -1, a reward from the parity of the completion's ids."""
    n_prompts, group, (lo, hi), new = BATCH_SHAPES[model][:4]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(rng.integers(lo, hi))) for _ in range(n_prompts)]
    seqs = [(p, rng.integers(0, vocab, new)) for p in prompts for _ in range(group)]
    B, L = len(seqs), max(len(p) + len(c) for p, c in seqs)
    batch = {
        "input_ids": np.zeros((B, L), np.int32),
        "attention_mask": np.zeros((B, L), bool),
        "loss_mask": np.zeros((B, L), np.float32),
        "logprobs": np.zeros((B, L), np.float32),
        "rewards": np.zeros(B, np.float32),
        "versions": np.zeros((B, L), np.int32),
    }
    for i, (p, c) in enumerate(seqs):
        n = len(p) + len(c)
        batch["input_ids"][i, :n] = np.concatenate([p, c])
        batch["attention_mask"][i, :n] = True
        batch["loss_mask"][i, len(p):n] = 1.0
        batch["logprobs"][i, len(p):n] = rng.normal(-1.0, 0.1, len(c))
        batch["rewards"][i] = float(np.mean(c % 2 == 0) > 0.5)
    return batch


def actor_config(model: str, dtype: str, dp: int, sp: int,
                 ckpt: Optional[str] = None) -> PPOActorConfig:
    """f32 masters, `dtype` compute, full remat, the batch shape's PPO
    minibatches of one micro-batch each, rows of its length."""
    _, group, _, _, row, n_minibatches = BATCH_SHAPES[model]
    return PPOActorConfig(
        init_from_scratch=ckpt is None, path=ckpt or "", dtype=dtype,
        gradient_checkpointing=True, group_size=group, ppo_n_minibatches=n_minibatches,
        use_decoupled_loss=True, pack_length_quantum=row, max_pack_length=row,
        adv_norm=NormConfig(mean_level="group", std_level="group"),
        optimizer=OptimizerConfig(lr=1e-5 if model != "tiny" else 1e-3,
                                  warmup_steps_proportion=0.0),
        mesh=MeshConfig(data_parallel_size=dp, sequence_parallel_size=sp),
    )


@torch.no_grad()
def params_digest(model: torch.nn.Module) -> str:
    """A digest of every parameter's bits: an int64 sum of the bits
    weighted by a position pattern, per tensor, hashed together on the
    host.  Equal digests across ranks: bit-equal parameters."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        bits = p.detach().reshape(-1).view({4: torch.int32, 2: torch.int16}[p.element_size()])
        bits = bits.long()
        total = torch.zeros((), dtype=torch.int64, device=p.device)
        for s in range(0, bits.numel(), 1 << 24):
            chunk = bits[s:s + (1 << 24)]
            w = (torch.arange(s, s + chunk.numel(), device=p.device) * 2654435761) % 2147483647
            total += (chunk * (w + 1)).sum()
        h.update(name.encode() + str(int(total)).encode())
    return h.hexdigest()[:16]


def flash_counts() -> List[int]:
    return [fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches]


def flash_counts_tc() -> List[int]:
    return [fa.flash_fwd.launches_tc, fa.flash_bwd_dq.launches_tc,
            fa.flash_bwd_dkv.launches_tc]


def flash_counts_wg() -> List[int]:
    return [fa.flash_fwd.launches_wg, fa.flash_bwd_dq.launches_wg,
            fa.flash_bwd_dkv.launches_wg]


class CollectiveTimer:
    """Seconds spent in `distributed.all_sum_` (every collective of the
    training step: the K/V gathers, the dK/dV sum-scatters, the gradient
    and stats sums, the logprob gather), the device synchronised before
    and after each so that the time is the collective's own."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._inner = distributed.all_sum_

    def __enter__(self):
        def timed(t, group):
            if group is None:
                return t
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            out = self._inner(t, group)
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        distributed.all_sum_ = timed
        return self

    def __exit__(self, *exc):
        distributed.all_sum_ = self._inner


class _HeadRollout:
    """Stands in for the inference client on the head rank."""

    def __init__(self, batch_fn):
        self.batch_fn = batch_fn
        self.calls = 0

    def rollout_batch(self, data, **kw):
        self.calls += 1
        return self.batch_fn()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(model: str, dp: int, sp: int, dtype: str, steps: int, device=None,
             layers: Optional[int] = None, ckpt: Optional[str] = None) -> dict:
    """One mesh case on this rank: the actor, the head's rollout, logprobs,
    advantages and `steps` updates.  Returns the rank's results."""
    mc = model_config(model, layers)
    actor = TorchPPOActor(actor_config(model, dtype, dp, sp, ckpt),
                          model_config=mc if ckpt is None else None, device=device)
    actor.initialize(ft_spec=FinetuneSpec(1, 32, 32))
    dev = actor.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rollout = _HeadRollout(lambda: make_batch(actor.model_config.vocab_size, model))
    batch = DistRolloutCoordinator(rollout).rollout_batch([{}])
    out = {"proc": distributed.process_index(), "mesh": [dp, sp],
           "backend": distributed.backend(), "device": str(dev),
           "layers": actor.model_config.num_layers,
           "dtype": dtype, "rollout_calls": rollout.calls}
    with CollectiveTimer() as timer:
        c0 = flash_counts()
        _sync(dev)
        t0 = time.perf_counter()
        logp = actor.compute_logp(batch)
        _sync(dev)
        out["logp_s"] = time.perf_counter() - t0
        out["logp_flash"] = list(np.subtract(flash_counts(), c0).tolist())
        out["logp_collective_s"] = timer.seconds
        batch["prox_logp"] = logp
        out["logp_digest"] = hashlib.sha256(logp.tobytes()).hexdigest()[:16]
        if distributed.is_head():
            out["logp_b64"] = base64.b64encode(logp.astype(np.float32).tobytes()).decode()
            out["logp_shape"] = list(logp.shape)
        actor.compute_advantages(batch)
        out["steps"] = []
        for _ in range(steps):
            c0, tc0, wg0 = flash_counts(), flash_counts_tc(), flash_counts_wg()
            s0 = timer.seconds
            _sync(dev)
            t0 = time.perf_counter()
            st = actor.ppo_update(batch)
            _sync(dev)
            out["steps"].append({  # one ppo_update: a loss and grad norm a minibatch
                "loss": [x["loss"] for x in st], "grad_norm": [x["grad_norm"] for x in st],
                "ppo_update_s": time.perf_counter() - t0,
                "train_batch_s": [x["step_time"] for x in st],
                "collective_s": timer.seconds - s0,
                "flash": list(np.subtract(flash_counts(), c0).tolist()),
                "flash_tc": list(np.subtract(flash_counts_tc(), tc0).tolist()),
                "flash_wg": list(np.subtract(flash_counts_wg(), wg0).tolist()),
                "params": params_digest(actor.model)})
        out["collective_calls"] = timer.calls
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                       else None)
    actor.destroy()
    del actor
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_checks(device=None) -> dict:
    """The data plane on two ranks: `broadcast_pytree` of a nested object,
    `make_global_batch`'s shards at (dp=1, sp=2) and (dp=2, sp=1), and
    the sequence collectives over sp (gather, sum-scatter, sum)."""
    dev = distributed.rank_device(device)
    r = distributed.process_index()
    obj = {"ids": np.arange(12).reshape(3, 4), "meta": ["a", {"b": 2}]} if r == 0 else None
    got = distributed.broadcast_pytree(obj)
    host = {"x": np.arange(4 * 8).reshape(4, 8), "rows": np.arange(4)}
    shards = {}
    for dp, sp in ((1, 2), (2, 1)):
        mesh = build_mesh(dp=dp, sp=sp)
        shards[f"{dp}x{sp}"] = {k: v.tolist()
                                for k, v in distributed.make_global_batch(mesh, host).items()}
    mesh = build_mesh(sp=2)
    g = mesh.groups["sp"]
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(1, 3, 2) + 10 * r
    gathered = distributed.seq_gather(x, g)
    scattered = distributed.seq_sum_scatter(gathered * (r + 1), g)
    xg = x.clone().requires_grad_(True)
    distributed.seq_gather(xg, g).pow(2).sum().backward()
    total = distributed.all_sum_(torch.tensor([r + 1.0], device=dev), mesh.group)
    return {"proc": r, "backend": distributed.backend(),
            "broadcast": {"ids": got["ids"].tolist(), "meta": got["meta"]},
            "shards": shards, "gathered": gathered.tolist(), "scattered": scattered.tolist(),
            "gather_grad": xg.grad.tolist(), "sum": total.tolist()}


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(n_ranks: int, args: List[str], env: Optional[Dict[str, str]] = None
           ) -> List[subprocess.Popen]:
    """Start `n_ranks` processes of this worker on one host with `args`,
    joined through a free local port (the env contract)."""
    port = find_free_port()
    procs = []
    for r in range(n_ranks):
        e = dict(os.environ, **(env or {}))
        e.update(AREAL_COORDINATOR=f"127.0.0.1:{port}", AREAL_NUM_PROCESSES=str(n_ranks),
                 AREAL_PROCESS_ID=str(r),
                 PYTHONPATH=os.pathsep.join(filter(None, [_ROOT, e.get("PYTHONPATH")])))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "areal_tpu_torch.scripts.mp_train_worker", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=e))
    return procs


def collect(procs: List[subprocess.Popen], timeout: float) -> List[List[dict]]:
    """Each rank's RESULT objects, its output drained as it runs.  Kills
    every rank and raises with the output's tail when one fails or the
    ranks outlast `timeout` seconds."""
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        futs = [pool.submit(p.communicate) for p in procs]
        try:
            outs = [f.result(timeout=timeout)[0] for f in futs]
        except concurrent.futures.TimeoutError:
            for p in procs:
                p.kill()
            outs = [f.result()[0] for f in futs]
            raise RuntimeError("the ranks timed out:\n" + "\n".join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DONE proc={r}" not in out:
            for q in procs:
                q.kill()
            raise RuntimeError(f"rank {r} failed (exit {p.returncode}):\n{out[-6000:]}")
    return [[json.loads(line[len("RESULT "):]) for line in out.splitlines()
             if line.startswith("RESULT ")] for out in outs]


def decode_logp(res: dict) -> np.ndarray:
    """The head's logprobs from its RESULT object."""
    return np.frombuffer(base64.b64decode(res["logp_b64"]), np.float32).reshape(
        res["logp_shape"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--model", default="qwen2.5-1.5b", choices=sorted(BATCH_SHAPES))
    ap.add_argument("--meshes", default="1x2",
                    help="comma-separated cases: DPxSP[:DTYPE[:LAYERS]] (depth cut, full "
                    "width kept)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--ckpt", default=None, help="an HF checkpoint dir (else seeded weights)")
    ap.add_argument("--checks", action="store_true", help="exercise the data plane first")
    args = ap.parse_args(argv)
    distributed.init_distributed(args.device)
    if args.checks:
        print("RESULT " + json.dumps({"checks": run_checks(args.device)}), flush=True)
    for case in args.meshes.split(","):
        mesh, *rest = case.split(":")
        dp, sp = (int(x) for x in mesh.split("x"))
        dtype = rest[0] if rest else "bfloat16"
        layers = int(rest[1]) if len(rest) > 1 else None
        res = run_case(args.model, dp, sp, dtype, args.steps, args.device, layers, args.ckpt)
        print("RESULT " + json.dumps(res), flush=True)
    print(f"DONE proc={distributed.process_index()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
