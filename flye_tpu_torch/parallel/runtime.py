"""Parallel runtime: the devices the kernels of a run use, and the run's
process topology.

Port of `flye_tpu/parallel/runtime.py`.  One process drives the devices
of its mesh (`parallel/mesh.Mesh`, an ordered list of `torch.device`s;
a device may repeat).  With more than one device in the mesh
(`active`), every call site that the JAX package shards over its mesh
runs its kernel on each device's contiguous block of rows and puts the
results back in order on the first device (`map_rows`): the index
builds take the posting exchange (`ShardedKmerIndex`), and the
flat-stream extraction, solid selection and probe, the chain DP (K1)
and the bubble climb (K2+K3 or K4) split their batch rows.  Where the
rows do not divide the device count the batch stays whole on the
first device, as the JAX package leaves such an array unsharded.

The topology comes from `init_distributed` (`RANK` / `WORLD_SIZE`): N
processes of one host share the card of `--device`, split the
all-vs-all overlaps by read partition (or, with FLYE_TPU_PARTITIONED=1,
the index by k-mer hash: `parallel/partitioned.py`) and the polisher's
work over the file task bus (`distributed.py`, `taskbus.py`).  Each
keeps a mesh of its own local devices.  The interface (`active`,
`mesh`, `n_devices`, `process_index`, `process_count`, `shard_rows`)
matches the JAX one so the carried-over host code reads the same.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("flye_tpu_torch")

_runtime: Optional["ParallelContext"] = None


def device_scope(device):
    """Make `device` current for the block when it is a card: the
    kernels' C launchers, CUDA graph replays and new streams act on the
    current device, not on their tensors'."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


class ParallelContext:
    """The mesh of this process's devices, and the run's process
    topology.  `device` is where whole arrays and the results of split
    calls live: the mesh's first device (default), or the one given
    when there is no mesh."""

    def __init__(self, device=None, process_index: int = 0,
                 process_count: int = 1, mesh=None):
        if device is None:
            if mesh is None:
                raise ValueError("a ParallelContext needs a device or a "
                                 "mesh")
            device = mesh.devices[0]
        self.device = torch.device(device)
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"mesh starts at {mesh.devices[0]}, not at "
                             f"{self.device}")
        self.mesh = mesh
        self.process_index = process_index
        self.process_count = process_count

    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def active(self) -> bool:
        """True when kernels split their rows over a >1-device mesh."""
        return self.mesh is not None and self.mesh.size > 1

    def shard_rows(self, *arrays):
        """Host arrays -> tensors on this context's device (the first
        of the mesh); split calls take their blocks from there
        (`map_rows`)."""
        out = tuple(_tensor(a, self.device) for a in arrays)
        return out if len(out) > 1 else out[0]

    def row_blocks(self, n_rows: int):
        """[(device, lo, hi)]: the contiguous row block of each mesh
        device, or the whole batch on the first device when the mesh is
        inactive or n_rows does not divide its size."""
        n = self.n_devices
        if not self.active or n_rows % n:
            return [(self.device, 0, n_rows)]
        per = n_rows // n
        return [(d, i * per, (i + 1) * per)
                for i, d in enumerate(self.mesh.devices)]

    def map_rows(self, fn, *arrays):
        """fn(lo, *blocks) on each `row_blocks` block of the arrays
        (numpy or tensors, one row count), the blocks on their device;
        the results (a tensor or a tuple of tensors) concatenated along
        axis 0 on the first device.  Each block runs with its device
        current (`device_scope`)."""
        blocks = self.row_blocks(len(arrays[0]))
        outs = []
        for dev, lo, hi in blocks:
            with device_scope(dev):
                outs.append(fn(lo, *(_tensor(a[lo:hi], dev)
                                     for a in arrays)))
        if len(outs) == 1:
            return outs[0]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat([o.to(self.device) for o in outs])
        return tuple(torch.cat([o[i].to(self.device) for o in outs])
                     for i in range(len(outs[0])))


def visible_devices(kind: str):
    """The devices of this kind this process sees: every visible card
    for "cuda", the one CPU for "cpu"."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def init_runtime(n_shards: Optional[int] = None,
                 device: str = "cuda") -> ParallelContext:
    """Install the runtime for a CLI run: the topology from
    `init_distributed`, and the mesh of the first `n_shards` devices of
    the `--device` type this process sees (`parallel/mesh.make_mesh`),
    as the JAX package's `init_runtime` cuts `jax.devices()`.  Every
    process of a multi-process run keeps a mesh of its own local
    devices; on one GPU they share it.  Without `n_shards` the mesh is
    one device: the JAX package takes every device, but a split over
    distinct cards has not been run, so it is asked for, not a
    default.  `device="cuda"` requires a visible GPU (there is no
    silent fallback to the CPU)."""
    from flye_tpu_torch.parallel.distributed import init_distributed
    from flye_tpu_torch.parallel.mesh import make_mesh
    global _runtime
    pidx, pcount = init_distributed()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but no CUDA "
                               "device is available")
        # no float contraction on the main path may run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        logger.info("Device: %s", torch.cuda.get_device_name(0))
    n = n_shards or 1
    mesh = make_mesh(n, device_type=dev.type) if n > 1 else None
    if mesh is not None:
        dev = mesh.devices[0]
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    _runtime = ParallelContext(dev, pidx, pcount, mesh=mesh)
    if mesh is not None or pcount > 1:
        logger.info("Parallel runtime: %d device(s) in the local mesh "
                    "(%s), %d process(es)", _runtime.n_devices, dev.type,
                    pcount)
    return _runtime


def make_mesh_local(n_devices=None, devices=None, device_type=None):
    """A mesh over this process's local devices only: in the port every
    process sees only its own, so this is `parallel/mesh.make_mesh`."""
    from flye_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_devices, devices=devices, device_type=device_type)


def get_runtime() -> ParallelContext:
    """The active context.  When nothing was installed (library use) it
    is the GPU, as `init_runtime(device="cuda")` gives, and it raises
    when no GPU is visible; a caller that wants the CPU installs
    `ParallelContext("cpu")` with `set_runtime` (the CPU tests do)."""
    global _runtime
    if _runtime is None:
        _runtime = init_runtime(device="cuda")
    return _runtime


def set_runtime(ctx: Optional[ParallelContext]) -> None:
    global _runtime
    _runtime = ctx
