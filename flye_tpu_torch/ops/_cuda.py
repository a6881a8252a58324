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
that its main path went through the kernels.  A launch made while a
`Graph` captures runs nothing: it is noted on the graph, and each
`Graph.replay()` adds the graph's captured launches to `LAUNCHES`, so
the counts stay exact (replays x captured launches).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
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
                            "levenshtein": 0, "anchor_geometry": 0,
                            "anchor_rows": 0}

# A harness that times the launches sets this to a callable: each launch
# is then bracketed by two CUDA events recorded on its stream just before
# and just after the launcher call, handed over as ON_LAUNCH(name, start,
# end) on the launching thread.  None: no events.
ON_LAUNCH: Optional[Callable] = None

# The same for CUDA-graph replays: each `Graph.replay()` is bracketed by
# two CUDA events on its stream, handed over as ON_REPLAY(graph, start,
# end).  Launches made during a capture record no events.
ON_REPLAY: Optional[Callable] = None

# source name -> nvcc's output of its last build here (ptxas's registers,
# shared memory and spills per kernel)
BUILD_LOG: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_capturing = threading.local()   # .graph: the Graph this thread captures


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
    of `device`; raise on its error code, count it in LAUNCHES (or, while
    a `Graph` captures, on the graph)."""
    stream = torch.cuda.current_stream(device)
    if torch.cuda.is_current_stream_capturing():
        graph = getattr(_capturing, "graph", None)
        if graph is None:
            raise RuntimeError(f"{name}: launched in a CUDA graph capture "
                               "that is not a _cuda.Graph's")
        check(fn(*args, ctypes.c_void_p(stream.cuda_stream)), name)
        graph.launches[name] = graph.launches.get(name, 0) + 1
        return
    hook = ON_LAUNCH
    if hook is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    # the C launcher acts on the current device, which must own `stream`
    with torch.cuda.device(device):
        err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
    if hook is not None:
        end.record(stream)
        hook(name, start, end)
    check(err, name)
    LAUNCHES[name] += 1


class Graph:
    """A CUDA graph of a fixed sequence of device work (torch ops and
    `launch()`es), captured once and replayed.

    `launches`: kernel name -> launches captured (one replay's); `tag`
    names the graph in a census; `replays` counts its replays;
    `capture_s`: host seconds its capture took (instantiation included).
    """

    def __init__(self, tag: str):
        self.tag = tag
        self.cuda_graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0

    @contextlib.contextmanager
    def capture(self, stream, pool=None):
        """Capture the work queued inside the block on `stream` (not the
        default stream), allocating from `pool`.  A failed capture
        raises."""
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            _capturing.graph = self
            try:
                self.cuda_graph.capture_begin(pool=pool)
                try:
                    yield
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        self.cuda_graph.capture_end()
                    raise
                self.cuda_graph.capture_end()
            finally:
                _capturing.graph = None
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        """Run the captured work on the current stream; count its
        launches in LAUNCHES and, with ON_REPLAY set, hand the replay's
        events over."""
        hook = ON_REPLAY
        if hook is not None:
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        self.cuda_graph.replay()
        if hook is not None:
            end.record(stream)
            hook(self, start, end)
        self.replays += 1
        for name, n in self.launches.items():
            LAUNCHES[name] += n


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
