"""The torch port's copy of gen/kv_pool.py behaves as the JAX package's:
the same operations give the same page table, radix matches and host-tier
evictions."""

import numpy as np

from areal_tpu.gen import kv_pool as ref
from areal_tpu_torch.gen import kv_pool as port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _run(mod, seed=0):
    rng = np.random.default_rng(seed)
    pool = mod.KVPool(6, host_bytes=4096)
    trace = []
    base = rng.integers(0, 50, 40)
    for step in range(60):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, 6))
        toks = np.concatenate([base[: rng.integers(0, 40)], rng.integers(0, 50, rng.integers(0, 8))])
        if op == 0:
            pool.note_free(slot, toks, len(toks))
        elif op == 1:
            trace.append(("drop", pool.drop_device(slot)))
        elif op == 2:
            pool.swap(slot, int(rng.integers(0, 6)))
        elif op == 3:
            kv = {"k": np.zeros((1, 16, 1, 8), np.float32)}
            trace.append(("put", pool.host_put(toks, len(toks), step, 16, kv)))
        trace.append(("match", sorted(pool.match_device(toks).items()),
                      sorted(pool.match_host(toks).items())))
        trace.append(("rows", pool.device_rows().tolist(), pool.row(slot)))
    pool.check_page_table()
    return trace


def test_port_copy_matches_reference():
    for seed in range(3):
        assert _run(port, seed) == _run(ref, seed)


def test_wire_round_trip_matches_reference():
    entry = {"tokens": [1, 2, 3], "valid_len": 3, "version": 2, "block": 16,
             "kv": {"k": np.arange(12, dtype=np.float32).reshape(1, 3, 1, 4)}}
    doc = port.wire_encode_entry(entry)
    assert doc == ref.wire_encode_entry(entry)
    back = port.wire_decode_entry(doc)
    np.testing.assert_array_equal(back["kv"]["k"], entry["kv"]["k"])
