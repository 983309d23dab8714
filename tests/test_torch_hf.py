"""The torch port's HF checkpoint I/O against the JAX package's.

The port reads safetensors by hand (it does not depend on the
`safetensors` package): a checkpoint the JAX `save_hf_checkpoint` wrote
loads to equal params, the port's writer produces files the JAX loader
and the `safetensors` library read back exactly, and incomplete
checkpoints fail loudly.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.convert import jax_tree_to_hf
from areal_tpu_torch.models.hf import load_hf_params, save_hf_checkpoint, state_to_params
from areal_tpu_torch.models.model_config import TransformerConfig, tiny_config
from areal_tpu_torch.models.transformer import init_params

KW = dict(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
          eos_token_id=None)


def _jax_params(tied):
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    jcfg = jax_tiny(**KW, tie_word_embeddings=tied)
    return jcfg, jax.tree_util.tree_map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(2)))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("save_dtype", ["float32", "bfloat16"])
def test_port_loads_jax_checkpoint(tmp_path, tied, save_dtype):
    from areal_tpu.models.hf import save_hf_checkpoint as jax_save

    jcfg, tree = _jax_params(tied)
    jax_save(tree, jcfg, str(tmp_path), save_dtype=save_dtype, max_shard_bytes=40_000)
    assert len(list(tmp_path.glob("*.safetensors"))) > 1  # sharded
    cfg = TransformerConfig.from_hf(str(tmp_path)).replace(dtype="float32")
    model, cfg = load_hf_params(str(tmp_path), cfg, device="cpu")
    want = {k: v.to(getattr(torch, save_dtype)).float()
            for k, v in jax_tree_to_hf(tree, cfg)}
    got = model.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("tied", [False, True])
def test_jax_loads_port_checkpoint(tmp_path, tied):
    from areal_tpu.models.hf import load_hf_params as jax_load
    from areal_tpu.models.hf import params_to_hf_state

    cfg = tiny_config(**KW, tie_word_embeddings=tied)
    model = init_params(cfg, 4, "cpu")
    save_hf_checkpoint(model, str(tmp_path), save_dtype="float32", max_shard_bytes=30_000)
    tree, jcfg = jax_load(str(tmp_path))
    assert jcfg.tie_word_embeddings == tied and jcfg.qkv_bias
    state = model.state_dict()
    emitted = dict(params_to_hf_state(tree, jcfg))
    assert set(emitted) == set(state)
    for name, arr in emitted.items():
        np.testing.assert_array_equal(np.asarray(arr), state[name].numpy(), name)


def test_reader_and_writer_agree_with_safetensors_library(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = {"w": torch.randn(3, 5).bfloat16(), "i": torch.arange(7, dtype=torch.int32),
               "f": torch.randn(2, 2, 2), "s": torch.tensor(2.5), "b": torch.tensor([True])}
    safetensors_io.save_file(tensors, str(tmp_path / "ours.safetensors"))
    theirs = load_file(str(tmp_path / "ours.safetensors"))
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    ours = dict(safetensors_io.read_file(str(tmp_path / "lib.safetensors")))
    for name, t in tensors.items():
        assert torch.equal(theirs[name], t) and theirs[name].dtype == t.dtype, name
        assert torch.equal(ours[name], t) and ours[name].dtype == t.dtype, name


def test_incomplete_checkpoints_fail_loudly():
    cfg = tiny_config(**KW)
    state = dict(init_params(cfg, 0, "cpu").state_dict())
    with pytest.raises(ValueError, match="lm_head"):
        state_to_params(((k, v) for k, v in state.items() if k != "lm_head.weight"),
                        cfg, "cpu")
    with pytest.raises(ValueError, match="incomplete"):
        state_to_params(((k, v) for k, v in state.items() if "layers.1." not in k),
                        cfg, "cpu")
    bad = dict(state, **{"model.norm.weight": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        state_to_params(bad.items(), cfg, "cpu")
    # a tied config ignores a checkpoint's lm_head
    tied = cfg.replace(tie_word_embeddings=True)
    model = state_to_params(state.items(), tied, "cpu")
    assert model.lm_head is None
