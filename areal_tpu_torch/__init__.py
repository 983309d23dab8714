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
  `TorchPPOActor`, which publishes its weights for the server.

Decode attention runs a hand-written CUDA kernel for Hopper
(`csrc/ragged_decode.cu`, bound in `ops/ragged_decode.py`), training
attention three (`csrc/flash_attention.cu`: forward, dq, dk/dv, bound in
`ops/flash_attention.py`); on a CPU tensor each wrapper runs the kernel's
plain PyTorch version.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""
