"""Build and bind the port's CUDA kernels (`flye_tpu_torch/csrc/*.cu`).

Each source compiles with nvcc into its own plain-C shared library
(`extern "C"` launchers, no PyTorch headers) in the gitignored build
directory, and loads with ctypes.  Pointers and the stream pass as
`c_void_p`; every launcher returns `cudaGetLastError()` after its
launch, and `check()` raises on a nonzero code.  Nothing here runs at
import: the first launch builds, so the CPU-only tests never need nvcc.

`LAUNCHES` counts kernel launches by name.  Each wrapper adds one right
after it launches its kernel, and nowhere else, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> launches; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"chain_dp": 0, "polish_backward": 0,
                            "polish_forward_score": 0, "polish_fused": 0,
                            "levenshtein": 0}

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


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


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
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
        else:
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


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
