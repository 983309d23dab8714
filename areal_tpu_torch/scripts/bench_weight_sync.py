"""Trainer -> server weight-sync latency of the port: transfer against disk.

    python -m areal_tpu_torch.scripts.bench_weight_sync                  # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.scripts.bench_weight_sync --device cpu --model tiny

The counterpart of `scripts/bench_weight_sync.py`.  A port server
(`gen/server.py`, standard library) runs in this process on its own
thread; the trainer is the port's `TorchTrainEngine` (bf16 weights, no
optimizer), on the same device.

- **transfer**: the trainer streams its bf16 tensors as octet-stream
  chunks into the server's staging buffer (`/update_weights_chunk`), the
  server assembles them on its device (`prepare`), then an aborting
  commit swaps them in (`_push_transfer_chunks` + `_commit_transfer`);
- **disk**: the trainer writes an HF safetensors snapshot in bf16, then
  `/update_weights_from_disk` reloads it.

Each path is timed twice, in the order transfer, disk, disk, transfer
(ORDER), so that neither path has only the first, cold reading: the
server's staging buffers and the trainer's export state are made inside
the first transfer, and the disk path's first save and reload run cold
too.  Prints one JSON line: each path's two readings in seconds, the disk
path's save and load seconds, the model's bf16 bytes, and the bytes the
disk path wrote (both snapshots; each is removed after its reload).
"""

import argparse
import json
import os
import shutil
import tempfile
import threading
import time

import torch

from areal_tpu_torch.api.config import TrainEngineConfig
from areal_tpu_torch.api.io_struct import WeightUpdateMeta
from areal_tpu_torch.engine.torch_train import TorchTrainEngine
from areal_tpu_torch.gen import server as gen_server
from areal_tpu_torch.gen.engine import GenEngine
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.scripts.bench_serving import MODELS, device_kind, serving_model_setup
from areal_tpu_torch.utils.http import request_with_retry


def dir_bytes(path: str) -> int:
    """Bytes of the files under `path`."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


ORDER = ("transfer", "disk", "disk", "transfer")


def run(model: str = "qwen25_1p5b", device=None, work_dir: str = "") -> dict:
    """Boot a server, publish the trainer's weights both ways in ORDER
    (versions 1, 2, ...), and report."""
    cfg, params = serving_model_setup(model, device)
    n_bytes = sum(p.numel() * 2 for p in params.parameters())
    engine = GenEngine(cfg, params=params, n_slots=1, max_seq_len=256, prompt_bucket=128,
                       device=next(params.parameters()).device)
    ready = threading.Event()
    holder = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    thread = threading.Thread(
        target=gen_server.serve, args=(engine,),
        kwargs=dict(host="127.0.0.1", on_ready=on_ready), daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("the weight-sync server did not come up")
    addr = f"127.0.0.1:{holder['httpd'].port}"
    own_dir = not work_dir
    work_dir = work_dir or tempfile.mkdtemp(prefix="wsync-")
    env = os.environ.get("AREAL_LLM_SERVER_ADDRS")
    try:
        trainer = TorchTrainEngine(
            TrainEngineConfig(init_from_scratch=True, dtype=cfg.dtype, param_dtype=cfg.dtype,
                              gradient_checkpointing=False, optimizer=None),
            model_config=cfg, device=engine.device)
        trainer.initialize()
        _sync(trainer.device)
        os.environ["AREAL_LLM_SERVER_ADDRS"] = addr
        times = {"transfer": [], "disk": [], "save": [], "load": []}
        written = 0
        for version, path_kind in enumerate(ORDER, start=1):
            trainer.set_version(version)
            if path_kind == "transfer":
                # stream + prepare, then an aborting commit
                meta = WeightUpdateMeta.from_transfer("wsync", "t", live_commit=False)
                t0 = time.perf_counter()
                trainer.update_weights(meta)
                times["transfer"].append(time.perf_counter() - t0)
                continue
            # the bf16 snapshot, then the server-side reload
            path = os.path.join(work_dir, f"v{version}")
            t0 = time.perf_counter()
            save_hf_checkpoint(trainer.model, path, save_dtype="bfloat16")
            save_s = time.perf_counter() - t0
            written += dir_bytes(path)
            t0 = time.perf_counter()
            request_with_retry(addr, "/update_weights_from_disk",
                               payload={"path": path, "version": version}, timeout=600)
            load_s = time.perf_counter() - t0
            shutil.rmtree(path, ignore_errors=True)
            times["save"].append(save_s)
            times["load"].append(load_s)
            times["disk"].append(save_s + load_s)
        version = request_with_retry(addr, "/health", method="GET", timeout=30)["version"]
    finally:
        if env is None:
            os.environ.pop("AREAL_LLM_SERVER_ADDRS", None)
        else:
            os.environ["AREAL_LLM_SERVER_ADDRS"] = env
        holder["httpd"].shutdown()
        thread.join(timeout=60)
        if own_dir:
            shutil.rmtree(work_dir, ignore_errors=True)
    return {
        "model": model,
        "num_layers": cfg.num_layers,
        "device_kind": device_kind(engine.device),
        "model_bytes_bf16": n_bytes,
        "order": list(ORDER),
        "transfer_path_seconds": [round(t, 3) for t in times["transfer"]],
        "disk_path_seconds": [round(t, 3) for t in times["disk"]],
        "disk_save_seconds": [round(t, 3) for t in times["save"]],
        "disk_load_seconds": [round(t, 3) for t in times["load"]],
        "disk_bytes_written": written,
        "transfer_vs_disk": round(sum(times["transfer"]) / max(sum(times["disk"]), 1e-9), 3),
        "server_version": version,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="qwen25_1p5b", choices=MODELS)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--work-dir", default="", help="where the disk snapshot goes "
                   "(default: a temporary directory, removed after)")
    args = p.parse_args(argv)
    print(json.dumps(run(args.model, args.device, args.work_dir)))


if __name__ == "__main__":
    main()
