"""flye_tpu_torch — the PyTorch/CUDA port of flye_tpu.

The same assembly pipeline as `flye_tpu` (reads -> disjointigs ->
consensus), run on an NVIDIA GPU: plain tensor work is PyTorch, and
every Pallas kernel of the JAX package's main path is a hand-written
CUDA kernel under `csrc/`, built with nvcc at first use
(`flye_tpu_torch.ops._cuda`).  Host code (graph walks, native C++
helpers) is carried over unchanged.

The package never imports jax or `flye_tpu`; it reads two of the JAX
package's data files by path (the native C++ source and the polishing
tables), see `native/__init__.py` and `polishing/homopolisher.py`.
"""

__version__ = "0.1.0"
