"""areal_tpu_torch: the PyTorch/CUDA port of `areal_tpu`, for one NVIDIA H100.

The JAX package beside it stays the reference every ported part is held
against (tests/test_torch_*.py).  This package imports `torch` and never
`jax` or `areal_tpu`; where it needs one of the reference's framework-free
modules it keeps its own copy.

What is ported so far:

- serving, the path of `python -m areal_tpu.gen.server --ragged-attn`: the
  model's prefill and decode forward, the counter-keyed sampler, the
  slot-grid engine and the HTTP server, which also reloads a trainer's
  snapshot (`/update_weights_from_disk`);
- training, the path of `JaxPPOActor`: the packed-row training forward
  with a deferred fused LM head, the decoupled-PPO loss, GAE, the train
  engine (f32 masters, bf16 compute, `full` remat, AdamW) and
  `TorchPPOActor`, which publishes its weights for the server;
- the GRPO loop: colocated in one process (`engine/colocated.py`), or
  remote, with servers as processes of their own (`launcher/local.py`)
  driven over HTTP by `RemoteTorchEngine` (`engine/torch_remote.py`) and
  weights published by snapshot or chunked transfer; the entry points are
  `scripts/bench_e2e_grpo.py` and `examples/math/gsm8k_grpo.py`;
- the example's training job: the ref engine and its KL term, the eval
  client (`utils/evaluator.py`), `utils/saver.py`, crash-safe recovery
  (`utils/recover.py`, the engine's `save`/`load`, `utils/faults.py`,
  `utils/shutdown.py`), `utils/stats_logger.py`, and the launcher's
  relaunch loop (`LocalLauncher.run`, `gsm8k_grpo --launch`).
- the fleet: the router in front of N servers (`gen/router.py`, the
  backend health checker `gen/health.py`), its fleet-wide staleness gate
  and the client's side of it, and discovery of servers, router and
  publishes through name_resolve (`utils/name_resolve.py`,
  `utils/names.py`).

Decode attention runs a hand-written CUDA kernel for Hopper
(`csrc/ragged_decode.cu`, bound in `ops/ragged_decode.py`), training
attention three (`csrc/flash_attention.cu`: forward, dq, dk/dv, bound in
`ops/flash_attention.py`); on a CPU tensor each wrapper runs the kernel's
plain PyTorch version.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""
