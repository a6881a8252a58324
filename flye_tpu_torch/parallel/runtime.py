"""Single-device runtime: the device every kernel of a run uses.

The JAX package's runtime builds a device mesh and shards batch axes
over it; distribution over `torch.distributed` is not yet ported, so
this context holds one `torch.device` and `shard_rows` only moves
arrays onto it.  The interface (`active`, `process_index`,
`process_count`, `shard_rows`) matches the JAX one so the carried-over
host code reads the same.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("flye_tpu_torch")

_runtime: Optional["ParallelContext"] = None


class ParallelContext:
    """One device, one process."""

    process_index = 0
    process_count = 1
    active = False   # no multi-device sharding in this port yet

    def __init__(self, device):
        self.device = torch.device(device)

    def shard_rows(self, *arrays):
        """Host arrays -> tensors on this context's device."""
        out = tuple(torch.as_tensor(np.ascontiguousarray(a),
                                    device=self.device) for a in arrays)
        return out if len(out) > 1 else out[0]


def init_runtime(n_shards: Optional[int] = None,
                 device: str = "cuda") -> ParallelContext:
    """Install the runtime for a CLI run.  `device="cuda"` requires a
    visible GPU (there is no silent fallback to the CPU)."""
    global _runtime
    if n_shards is not None and n_shards > 1:
        raise NotImplementedError(
            "--shards > 1 is not yet ported to flye_tpu_torch")
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
    _runtime = ParallelContext(dev)
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
