"""Peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W) and the roofline
bound of a launch, frozen from `chip_smoke.py`.

Float32 outside the tensor cores: 67 TFLOP/s (NVIDIA's data sheet).
Integer work: an SM dispatches at most 4 warp instructions a clock,
132 SMs x 128 lanes x 1.98 GHz = 33.4 Tops/s (nvcc also runs integer
adds, shifts and moves on the float32 pipe as IMAD forms).  HBM: 3.35
TB/s.  The peaks assume the full 700 W; the traced line names the
card's power limit beside every share.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9


def bound(n_bytes, n_ops, ops_per_s):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"
