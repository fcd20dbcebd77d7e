"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries are built at first
use into `imagdressing_tpu_torch/_build/` (listed in .gitignore), named by a
hash of the sources and flags so that an edited source is rebuilt. `build()`
starts one nvcc per source, all at once.

Nothing here runs at import time: the CPU tests import every module of the
port on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "gn_conv.cu", "groupnorm.cu",
           "bn_act.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per built
    source (0.0 for one already built). Raises with nvcc's output on error;
    the ptxas report (registers, shared memory, spills) is kept beside each
    library as `<name>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for src in sources:
        out = lib_path(src)
        if out.exists():
            times[src] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failures = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[src] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src} (rc {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return times


def load(source: str) -> ctypes.CDLL:
    """The library of one source, built first if needed (once per process)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(lib_path(source)))
            _libs[source] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on the CUDA error code a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


class LaunchCounter:
    """Launches of one kernel: `count` is a plain integer that the wrapper
    bumps once per launch of its CUDA kernel (never for the plain version);
    `by_shape` tallies the same launches by the shape key the wrapper
    gives."""

    def __init__(self) -> None:
        self.count = 0
        self.by_shape: Counter = Counter()

    def add(self, shape_key) -> None:
        self.count += 1
        self.by_shape[shape_key] += 1

    def reset(self) -> None:
        self.count = 0
        self.by_shape.clear()


def check_operands(name: str, *tensors) -> None:
    """The checks every launch makes on its tensor arguments: on one CUDA
    device, the current one (a launch goes to the current device's context
    on that device's current stream; a rank sets its device once), densely
    laid out, 16-byte aligned (the kernels move 8 elements per vector
    load)."""
    import torch

    dev = tensors[0].device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")
