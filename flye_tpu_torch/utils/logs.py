"""Logging setup: timestamped console + optional file sink.

Mirrors the reference's dual console/file logging discipline
(reference: flye/main.py:579-599, src/common/logger.h) with one root
package logger.
"""

from __future__ import annotations

import logging
import sys
from contextlib import contextmanager
from typing import Optional


def configure_logging(log_file: Optional[str] = None, debug: bool = False) -> None:
    logger = logging.getLogger("flye_tpu_torch")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.DEBUG if debug else logging.INFO)
    console.setFormatter(
        logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s",
                          "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(console)

    if log_file:
        fh = logging.FileHandler(log_file, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s",
                              "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)


def human_bytes(n: float) -> str:
    for unit in ("b", "Kb", "Mb", "Gb", "Tb"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "b" else f"{int(n)} {unit}"
        n /= 1024
    return f"{n:.1f} Pb"


def host_memory() -> tuple:
    """(current RSS, peak RSS) in bytes from /proc/self/status — the
    per-stage memory introspection of the reference
    (reference: src/common/memory_info.h getMemorySize/getPeakRSS,
    logged at stage boundaries in main_assemble.cpp:152-156,225-226)."""
    rss = peak = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
    except OSError:
        pass
    return rss, peak


def device_memory() -> Optional[tuple]:
    """(bytes_allocated, peak_bytes_allocated) of the runtime's CUDA
    device, or None when the run is on the CPU."""
    import torch

    from flye_tpu_torch.parallel.runtime import get_runtime
    dev = get_runtime().device
    if dev.type != "cuda":
        return None
    return (torch.cuda.memory_allocated(dev),
            torch.cuda.max_memory_allocated(dev))


@contextmanager
def stage_timer(name: str, logger: Optional[logging.Logger] = None):
    """Per-stage wall-clock timing + memory introspection (the reference
    keeps per-phase timers in its hot loops, src/sequence/overlap.cpp:
    128-158, and logs RSS at stage boundaries via memory_info.h).  The
    step is a span of that name (`utils.trace`), so also a range of that
    name in a `--profile` trace."""
    from flye_tpu_torch.utils.trace import span

    log = logger or logging.getLogger("flye_tpu_torch")
    log.info("%s: started", name)
    step = span(name)
    try:
        with step:
            yield
    finally:
        rss, peak = host_memory()
        dev = device_memory()
        mem = f"RSS {human_bytes(rss)} (peak {human_bytes(peak)})"
        if dev:
            mem += (f", device {human_bytes(dev[0])} "
                    f"(peak {human_bytes(dev[1])})")
        log.info("%s: done in %.1f s [%s]", name, step.seconds, mem)
