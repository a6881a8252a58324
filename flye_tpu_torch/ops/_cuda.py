"""Build and bind the port's CUDA kernels (`flye_tpu_torch/csrc/*.cu`).

Each source compiles with nvcc into its own plain-C shared library
(`extern "C"` launchers, no PyTorch headers) in the gitignored build
directory, and loads with ctypes.  Pointers and the stream pass as
`c_void_p`; every launcher takes the stream last and returns
`cudaGetLastError()` after its launch.  Wrappers launch through
`launch()`, which raises on a nonzero code.  Nothing here runs at
import: the first launch builds, so the CPU-only tests never need nvcc.

`LAUNCHES` counts kernel launches by name.  `launch()` adds one right
after the launcher returns, and nothing else does, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# kernel name -> launches; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"chain_dp": 0, "polish_backward": 0,
                            "polish_forward_score": 0, "polish_fused": 0,
                            "levenshtein": 0}

# A harness that times the launches sets this to a callable: each launch
# is then bracketed by two CUDA events recorded on its stream just before
# and just after the launcher call, handed over as ON_LAUNCH(name, start,
# end) on the launching thread.  None: no events.
ON_LAUNCH: Optional[Callable] = None

# source name -> nvcc's output of its last build here (ptxas's registers,
# shared memory and spills per kernel)
BUILD_LOG: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return path


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _sources(name: str) -> list:
    """csrc/<name>.cu and the headers of csrc it includes ("...")."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src) as f:
        heads = re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    return [src] + [os.path.join(CSRC, h) for h in heads]


def _stale(name: str) -> bool:
    """Whether the library of csrc/<name>.cu is missing or older than
    its source or a header it includes."""
    so = _so_path(name)
    return (not os.path.exists(so)
            or any(os.path.getmtime(so) < os.path.getmtime(p)
                   for p in _sources(name)))


def build(names: Iterable[str]) -> None:
    """Compile the named sources, one nvcc process each, all started
    together; raises with the compiler output if any fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = f"{_so_path(name)}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, p in procs:
        out, _ = p.communicate(timeout=900)
        text = out.decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{text}")
        else:
            BUILD_LOG[name] = text
            os.replace(tmp, _so_path(name))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(_so_path(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Launch kernel `name` with fn(*args, stream), on the current stream
    of `device`; raise on its error code, count it in LAUNCHES."""
    stream = torch.cuda.current_stream(device)
    hook = ON_LAUNCH
    if hook is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
    if hook is not None:
        end.record(stream)
        hook(name, start, end)
    check(err, name)
    LAUNCHES[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, device: torch.device) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape on
    this CUDA device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
