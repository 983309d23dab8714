"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and compiles on its own
into `_build/lib<name>-<hash>.so` (the hash covers the source and the
flags, so an edited source rebuilds).  `build` starts one nvcc per missing
library, all together, and waits for them; `load` builds if needed and
opens the library once per process; `count_launch` keeps the wrappers'
launch counts.  Nothing here runs at import time:
the CPU tests import every module where there is no nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _paths(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all started together.  Returns {name: nvcc output} (the
    `-Xptxas -v` report: registers, shared memory, spills) for the ones it
    built; raises with nvcc's output when one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        src, lib = _paths(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    logs = {}
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
            logs[name] = out
        else:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


_count_lock = threading.Lock()


def count_launch(wrapper, tensor_cores: bool = False) -> None:
    """Add one launch to `wrapper.launches` (and to `wrapper.launches_tc`
    when it ran on the tensor cores) under a lock: a colocated engine's
    decode stepper and the trainer launch from two threads, and a bare
    `+=` there can lose an increment."""
    with _count_lock:
        wrapper.launches += 1
        if tensor_cores:
            wrapper.launches_tc += 1


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib
