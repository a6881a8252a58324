"""Parallel runtime: the device every kernel of a run uses, and the
run's process topology.

The JAX package's runtime builds a device mesh and shards batch axes
over it.  Here each process holds one `torch.device` (`shard_rows` only
moves arrays onto it) and the topology that `init_distributed` reads
(`RANK` / `WORLD_SIZE`): N processes of one host share the card of
`--device`, split the all-vs-all overlaps by read partition and the
polisher's work over the file task bus (`distributed.py`,
`taskbus.py`).  `--shards > 1` and the hash-partitioned mode
(`FLYE_TPU_PARTITIONED=1`), which need the sharded index and a
`torch.distributed` group, are not yet ported.  The interface
(`active`, `process_index`, `process_count`, `shard_rows`) matches the
JAX one so the carried-over host code reads the same.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("flye_tpu_torch")

_runtime: Optional["ParallelContext"] = None


class ParallelContext:
    """One device per process, and the run's process topology."""

    active = False   # no multi-device sharding in this port yet

    def __init__(self, device, process_index: int = 0,
                 process_count: int = 1):
        self.device = torch.device(device)
        self.process_index = process_index
        self.process_count = process_count

    def shard_rows(self, *arrays):
        """Host arrays -> tensors on this context's device."""
        out = tuple(torch.as_tensor(np.ascontiguousarray(a),
                                    device=self.device) for a in arrays)
        return out if len(out) > 1 else out[0]


def init_runtime(n_shards: Optional[int] = None,
                 device: str = "cuda") -> ParallelContext:
    """Install the runtime for a CLI run: the topology from
    `init_distributed`, and `device` for this process (every process of
    a multi-process run uses the `--device` it was given; on one GPU
    they share it).  `device="cuda"` requires a visible GPU (there is
    no silent fallback to the CPU)."""
    from flye_tpu_torch.parallel.distributed import init_distributed
    global _runtime
    if n_shards is not None and n_shards > 1:
        raise NotImplementedError(
            "--shards > 1 is not yet ported to flye_tpu_torch")
    pidx, pcount = init_distributed()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but no CUDA "
                               "device is available")
        dev = torch.device("cuda", torch.cuda.current_device())
        # no float contraction on the main path may run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        logger.info("Device: %s", torch.cuda.get_device_name(dev))
    _runtime = ParallelContext(dev, pidx, pcount)
    if pcount > 1:
        logger.info("Parallel runtime: process %d of %d, device %s",
                    pidx, pcount, dev)
    return _runtime


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
