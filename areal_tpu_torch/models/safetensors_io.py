"""Reader and writer for the safetensors format, by hand.

The port reads and writes the format itself rather than depend on the
`safetensors` package.  A file is an 8-byte little-endian header
length N, an N-byte JSON header mapping each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets relative to
the end of the header; an optional ``"__metadata__"`` entry holds strings),
then the raw little-endian buffers.  bf16 has no numpy dtype, so buffers
become tensors through `torch.frombuffer` and a dtype view.
"""

import json
import os
import struct
from typing import Dict, Iterable, Iterator, Mapping, Tuple

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_file(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor in one .safetensors file,
    in header order.  Tensors share one buffer read from the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(buf)
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported dtype {meta['dtype']} for {name}")
        begin, end = meta["data_offsets"]
        shape = list(meta["shape"])
        if end == begin:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=begin)
        if begin % dtype.itemsize:
            raw = raw.clone()  # a dtype view needs an aligned offset
        yield name, raw.view(dtype).reshape(shape)


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) over every .safetensors shard in a dir,
    shards in sorted order."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    for f in files:
        yield from read_file(f)


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device; copied to the CPU) as one file.  The
    header is padded with spaces so the data starts on an 8-byte boundary,
    as the reference writer does."""
    header: Dict[str, object] = {"__metadata__": {"format": "pt"}}
    flat = []
    offset = 0
    # widest elements first keeps every offset aligned to its element size
    # (the format allows no holes between buffers)
    items = sorted(tensors.items(), key=lambda kv: -kv[1].element_size())
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        flat.append(t.reshape(-1).view(torch.uint8))
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in flat:
            f.write(t.numpy().data)


def save_sharded(items: Iterable[Tuple[str, torch.Tensor]], out_dir: str, stem: str,
                 max_shard_bytes: int = 4 * 1024**3) -> Tuple[Dict[str, str], int]:
    """Write (name, tensor) pairs into `out_dir` as `{stem}.safetensors`,
    or as `{stem}-00001-of-0000N.safetensors`... when they outgrow one
    shard of `max_shard_bytes`; returns ({name: file name}, total bytes)."""
    shards, sizes = [{}], [0]
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    n = len(shards)
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"{stem}.safetensors" if n == 1 else f"{stem}-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file(shard, os.path.join(out_dir, fname))
        weight_map.update({name: fname for name in shard})
    return weight_map, sum(sizes)
