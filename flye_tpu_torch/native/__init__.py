"""Native (C++) host helpers, built on first use with g++.

The source, `flye_native.cpp` beside this file, is the port's own copy
of the JAX package's native helpers (kept byte-equal to it by
`tests/test_torch_repeat.py`).  The module is compiled into the port's
build directory (`flye_tpu_torch/_build`, gitignored).  The port has no
pure-Python fallback for these helpers: a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading

logger = logging.getLogger("flye_tpu_torch")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "flye_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "flye_native.so")
_module = None
_lock = threading.Lock()


def _build() -> None:
    if not os.path.exists(SRC):
        raise RuntimeError(f"native source not found: {SRC}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    tmp = f"{_SO}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{include}", SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError("native build failed:\n"
                           + res.stderr.decode(errors="replace"))
    os.replace(tmp, _SO)


def get() -> object:
    """The flye_native module; builds it on first use, raises if the
    build or the load fails."""
    global _module
    with _lock:
        if _module is not None:
            return _module
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(SRC)):
            _build()
        spec = importlib.util.spec_from_file_location("flye_native", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
        logger.debug("native helpers loaded from %s", _SO)
        return _module


def loaded() -> bool:
    return _module is not None
