"""The port's multi-process training over a (dp, sp) mesh against the JAX
package, on the CPU.

- `mesh_from_alloc`'s axis sizes against the JAX package's for a few
  allocation strings; the axes the port does not run raise.
- One 2-rank gloo group (`areal_tpu_torch/scripts/mp_train_worker.py`,
  started once for the module) runs every case: `broadcast_pytree`, the
  shards of `make_global_batch`, the sequence gather, sum-scatter and sum,
  and 3 `ppo_update` steps at (dp=1, sp=2) and at (dp=2, sp=1) of a
  2-layer model with head dim 128 (so the flash path runs its plain
  versions, at the query offset under sp), f32.
- Across the ranks: the head alone rolls out, losses and grad norms are
  identical, and the parameters bit-equal after every step.
- Against the reference: the JAX actor on a single-process mesh of the
  same shape (virtual CPU devices), at the JAX package's own tolerances
  (`tests/test_jax_train_engine.py`: rtol 2e-4 on forward logprobs, 1e-3
  on the loss), and against the port at sp = 1 (one worker process),
  tighter (f32 on both sides, the same products on rows cut in two: 1e-6
  on logprobs, 1e-5 relative on loss and grad norm).
- The shard-boundary label: the packed rows hold a loss-masked token at
  position T/2 - 1, whose label is the next shard's first token; a
  `torch.roll` inside the shard would score it against its own first.
"""

import dataclasses

import numpy as np
import pytest
import torch

from areal_tpu_torch.api import alloc as port_alloc
from areal_tpu_torch.api.config import MeshConfig
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.parallel import distributed
from areal_tpu_torch.parallel.mesh import Mesh, mesh_from_alloc, mesh_shape_from_alloc
from areal_tpu_torch.scripts import mp_train_worker as worker
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = ((1, 2), (2, 1))
STEPS = 3
LOGP_RTOL_JAX, LOSS_RTOL_JAX = 2e-4, 1e-3  # the JAX package's own (test_jax_train_engine)
LOGP_ATOL_PORT, STAT_RTOL_PORT = 1e-6, 1e-5


def test_mesh_from_alloc_matches_reference_axis_sizes():
    from areal_tpu.api.alloc import AllocationMode as JaxAlloc
    from areal_tpu.parallel.mesh import mesh_from_alloc as jax_mesh_from_alloc

    for expr in ("d2s2", "d4", "d2c2", "s2", "jax:d2|jax:d1s2", "jax:d2+jax:d2s2"):
        port = mesh_shape_from_alloc(port_alloc.AllocationMode.from_str(expr).train)
        ref = jax_mesh_from_alloc(JaxAlloc.from_str(expr).train).shape
        assert port == dict(ref), expr
    for expr in ("d2f2", "d2t2", "d2e2"):
        with pytest.raises(NotImplementedError, match="M9b"):
            mesh_from_alloc(port_alloc.AllocationMode.from_str(expr).train)
    with pytest.raises(NotImplementedError):
        mesh_shape_from_alloc(port_alloc.AllocationMode.from_str("d2p2").train)
    for kw in (dict(fsdp_parallel_size=2), dict(tensor_parallel_size=2),
               dict(expert_parallel_size=2)):
        with pytest.raises(NotImplementedError, match="M9b"):
            MeshConfig(**kw)
    assert distributed.backend_for("cuda", 2, 1) == "gloo"  # two ranks share the card
    assert distributed.backend_for("cuda", 2, 2) == "nccl"
    assert distributed.backend_for("cpu", 2, 0) == "gloo"


def _jax_config(port_cfg, jc):
    """The JAX package's config of the same fields as a port config."""
    kw = {}
    for f in dataclasses.fields(port_cfg):
        v = getattr(port_cfg, f.name)
        kw[f.name] = _jax_config(v, jc) if dataclasses.is_dataclass(v) else v
    return getattr(jc, type(port_cfg).__name__)(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX actors (one per mesh), their initial params as an HF
    checkpoint, the 2-rank run from it, and the port at sp = 1 in this
    process from it."""
    import jax

    from areal_tpu.api import config as jc
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.engine.ppo import JaxPPOActor
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    mc = worker.model_config("tiny")
    jmc = jax_tiny(**{f.name: getattr(mc, f.name) for f in dataclasses.fields(mc)
                      if f.name in ("vocab_size", "hidden_size", "intermediate_size",
                                    "num_heads", "num_kv_heads", "qkv_bias",
                                    "hf_architecture")})
    jax_actors, params = {}, None
    for dp, sp in MESHES:
        cfg = _jax_config(worker.actor_config("tiny", "float32", dp, sp), jc)
        cfg = dataclasses.replace(cfg, experiment_name="mp", trial_name="mp")
        ja = JaxPPOActor(cfg, model_config=jmc)
        ja.initialize(ft_spec=JaxSpec(1, 32, 32))
        bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, ja.params), mc,
                                  device="cpu", param_dtype="float32")
        if params is None:
            params = bridged
        else:  # both meshes start from the same values
            for (n, a), b in zip(params.named_parameters(), bridged.parameters()):
                assert torch.equal(a, b), n
        jax_actors[(dp, sp)] = ja
    ckpt = str(tmp_path_factory.mktemp("mp_ckpt"))
    save_hf_checkpoint(params, ckpt, save_dtype="float32")

    args = ["--device", "cpu", "--model", "tiny", "--steps", str(STEPS), "--ckpt", ckpt]
    env = {"OMP_NUM_THREADS": "2"}
    ranks = worker.collect(worker.launch(2, args + [
        "--checks", "--meshes", ",".join(f"{dp}x{sp}:float32" for dp, sp in MESHES)], env),
        timeout=240)
    # sp = 1 in a process of its own, as the ranks run: this test process
    # also runs JAX, and its first torch forward has been seen to differ
    # from every later one (and from any process without JAX) by ~1e-4
    (sp1,), = worker.collect(worker.launch(1, args + ["--meshes", "1x1:float32"], env),
                             timeout=240)
    return jax_actors, ranks, sp1


def test_data_plane_on_two_ranks(runs):
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        c = res[0]["checks"]
        assert c["proc"] == r and c["backend"] == "gloo"
        assert c["broadcast"] == {"ids": np.arange(12).reshape(3, 4).tolist(),
                                  "meta": ["a", {"b": 2}]}
        x = np.arange(32).reshape(4, 8)
        assert c["shards"]["1x2"] == {"x": x[:, 4 * r:4 * r + 4].tolist(),
                                      "rows": list(range(4))}
        assert c["shards"]["2x1"] == {"x": x[2 * r:2 * r + 2].tolist(),
                                      "rows": [2 * r, 2 * r + 1]}
        shard = [np.arange(6.0).reshape(3, 2) + 10 * q for q in (0, 1)]
        whole = np.concatenate(shard)[None]
        assert c["gathered"] == whole.tolist()  # every rank's block, in rank order
        # sum over ranks of (q + 1) * whole, this rank's half
        assert c["scattered"] == (3 * whole)[:, 3 * r:3 * r + 3].tolist()
        # d/dx of sum(gather(x)^2) summed over both ranks' losses: 2 x 2 x
        assert c["gather_grad"] == (4 * shard[r])[None].tolist()
        assert c["sum"] == [3.0]


@pytest.mark.parametrize("dp,sp", MESHES)
def test_ranks_agree_bit_for_bit(runs, dp, sp):
    _, ranks, _ = runs
    case = [next(x for x in res[1:] if x["mesh"] == [dp, sp]) for res in ranks]
    assert [c["rollout_calls"] for c in case] == [1, 0]  # the head alone rolls out
    assert {c["backend"] for c in case} == {"gloo"}
    assert case[0]["logp_digest"] == case[1]["logp_digest"]
    for a, b in zip(case[0]["steps"], case[1]["steps"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert a["params"] == b["params"]  # bit-equal parameters after every step
    # the plain versions on the CPU: no kernel launched
    assert case[0]["logp_flash"] == [0, 0, 0]


@pytest.mark.parametrize("dp,sp", MESHES)
def test_mesh_run_matches_reference_and_single_rank(runs, dp, sp):
    jax_actors, ranks, sp1 = runs
    head = next(x for x in ranks[0][1:] if x["mesh"] == [dp, sp])
    logp = worker.decode_logp(head)
    np.testing.assert_allclose(logp, worker.decode_logp(sp1), rtol=0, atol=LOGP_ATOL_PORT)
    for a, b in zip(head["steps"], sp1["steps"]):
        for k in ("loss", "grad_norm"):
            (x,), (y,) = a[k], b[k]  # one minibatch an update
            assert abs(x - y) <= STAT_RTOL_PORT * max(abs(y), 1e-3), (k, x, y)

    ja = jax_actors[(dp, sp)]
    batch = worker.make_batch(128, "tiny")
    batch["prox_logp"] = ja.compute_logp(batch)
    np.testing.assert_allclose(logp, batch["prox_logp"], rtol=LOGP_RTOL_JAX,
                               atol=LOGP_RTOL_JAX)
    ja.compute_advantages(batch)
    for step in head["steps"]:
        (st,) = ja.ppo_update(batch)
        (loss,), (grad_norm,) = step["loss"], step["grad_norm"]
        assert abs(loss - st["loss"]) <= LOSS_RTOL_JAX * max(abs(st["loss"]), 1e-3)
        assert abs(grad_norm - st["grad_norm"]) <= LOSS_RTOL_JAX * st["grad_norm"]


def test_shard_boundary_label():
    """After packing, a loss-masked token sits at T/2 - 1 of a row; at
    sp = 2 its label in shard 0 is the row's token T/2 (the next shard's
    first), where rolling the shard's own ids would give its token 0."""
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    actor = TorchPPOActor(worker.actor_config("tiny", "float32", 1, 1),
                          model_config=worker.model_config("tiny"), device="cpu")
    actor.initialize()
    batch = worker.make_batch(128, "tiny")
    actor.compute_advantages(batch)  # the predictor-aligned loss mask
    _, data, T = actor._prepare_rows(batch, 1)
    rows = np.nonzero(data["loss_mask"][:, T // 2 - 1] > 0)[0]
    assert rows.size, "no loss-masked token at the shard boundary"
    mesh0 = Mesh(shape=dict(dp=1, fsdp=1, ep=1, sp=2, tp=1),
                 coords=dict(dp=0, fsdp=0, ep=0, sp=0, tp=0), groups={}, group=None)
    shard = distributed.make_global_batch(mesh0, data)
    assert shard["input_ids"].shape == (data["input_ids"].shape[0], T // 2)
    np.testing.assert_array_equal(shard["labels"][rows, -1], data["input_ids"][rows, T // 2])
    rolled = np.roll(shard["input_ids"], -1, axis=-1)[rows, -1]  # the wrong label
    assert (rolled != data["input_ids"][rows, T // 2]).any()

