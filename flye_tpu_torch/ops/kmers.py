"""K-mer extraction, hashing and minimizer selection over a flat read
stream, in PyTorch.

Port of the parts of `flye_tpu/ops/kmers.py` the main path calls: the
w > 1 minimizer selection of the consensus read mapper's index build
(`stream_select_packed`), with its `splitmix64` hash and `_sliding_min`.
The JAX functions are plain XLA (no Pallas), so these are plain tensor
code on whatever device the chunk tensor lies on.

uint64 semantics on int64 tensors: PyTorch has no usable uint64
arithmetic, so hashes are kept as their int64 bit patterns.  Multiplies
wrap identically in two's complement; right shifts are masked after the
arithmetic shift so they are logical; and before any ordering compare
the sign bit is flipped (`_ORDER_FLIP`), which maps unsigned order onto
signed order.  Equality is unaffected by the flip.
"""

from __future__ import annotations

import torch

MAX_K = 31
# int64 bit patterns of the uint64 constants
_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MUL2 = 0x94D049BB133111EB - (1 << 64)
_ORDER_FLIP = -(1 << 63)        # xor: unsigned order -> signed order
# the JAX package's invalid-position hash is max uint64; flipped into
# signed order it becomes max int64
_INVALID_FLIPPED = (1 << 63) - 1


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer (reference: src/sequence/kmer.h:91-98);
    int64 in, the uint64 result's int64 bit pattern out."""
    x = x.to(torch.int64)
    x = (x ^ _lshr(x, 30)) * _MUL1
    x = (x ^ _lshr(x, 27)) * _MUL2
    return x ^ _lshr(x, 31)


def _sliding_min(h: torch.Tensor, width: int, pad_val: int) -> torch.Tensor:
    """out[p] = min(h[p .. p+width-1]) along the last axis, out-of-range
    treated as pad_val (sparse-table doubling: O(log width) mins).
    Signed order: pass sign-flipped hashes for uint64 order."""
    if width <= 1:
        return h
    n = h.shape[-1]
    idx = torch.arange(n, device=h.device)

    def shift(x, s):
        rolled = torch.roll(x, -s, dims=-1)
        return torch.where(idx < n - s, rolled,
                           torch.full_like(rolled, pad_val))

    g = h
    span = 1
    while span * 2 <= width:
        g = torch.minimum(g, shift(g, span))
        span *= 2
    if span == width:
        return g
    return torch.minimum(g, shift(g, width - span))


def stream_select_packed(chunks: torch.Tensor, starts: torch.Tensor,
                         row0: int, n_total: int, k: int, w: int,
                         sample: int, step: int) -> torch.Tensor:
    """Fused k-mer extraction + canonicalization + minimizer/sample
    selection over a flat read stream (see the JAX function of the same
    name for the layout).

    Args:
      chunks: [B, W] uint8; row r holds stream positions
        (row0+r)*step - (w-1) + col.
      starts: [R+1] int64 read start offsets (ascending, padded with
        n_total), on the same device as chunks.
      row0, n_total: global row index of chunks[0], stream length.
      k, w: k-mer size / minimizer window (w=1 -> sampling mode).
      sample: keep every sample-th position per read when w == 1.
      step: selectable positions per row, W - (k-1) - 2*(w-1).

    Returns [B, W] int64: the uint64 word
    (canon << 2) | (is_fwd << 1) | 1 at selected positions, 0 elsewhere.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} out of range 1..{MAX_K}")
    B, W = chunks.shape
    dev = chunks.device
    c = chunks.to(torch.int64)
    fwd = torch.zeros((B, W), dtype=torch.int64, device=dev)
    rc = torch.zeros((B, W), dtype=torch.int64, device=dev)
    for j in range(k):
        shifted = torch.roll(c, -j, dims=1) if j else c
        fwd |= shifted << (2 * (k - 1 - j))
        rc |= (3 - shifted) << (2 * j)
    col = torch.arange(W, dtype=torch.int64, device=dev).expand(B, W)
    row = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    g = (row0 + row) * step + col - (w - 1)

    # a k-mer is valid iff it lies entirely within one read
    rid_a = torch.searchsorted(starts, g, right=True)
    rid_b = torch.searchsorted(starts, g + (k - 1), right=True)
    valid = ((g >= 0) & (g + k <= n_total) & (rid_a == rid_b)
             & (col <= W - k))

    is_fwd = fwd <= rc
    canon = torch.where(is_fwd, fwd, rc)

    if w > 1:
        h = torch.where(valid, splitmix64(canon) ^ _ORDER_FLIP,
                        torch.full_like(canon, _INVALID_FLIPPED))
        Wmin = _sliding_min(h, w, _INVALID_FLIPPED)

        def shiftL(x, s, fill):
            rolled = torch.roll(x, -s, dims=-1)
            return torch.where(col < W - s, rolled,
                               torch.full_like(rolled, fill))
        # window s is usable iff its first and last k-mers are valid and
        # belong to the same read (then so do all between)
        win_ok = (valid & shiftL(valid, w - 1, False)
                  & (rid_a == shiftL(rid_a, w - 1, -1)))
        selected = torch.zeros_like(valid)
        for j in range(w):
            Wj = torch.roll(Wmin, j, dims=-1)
            okj = torch.roll(win_ok, j, dims=-1) & (col >= j)
            selected |= okj & (Wj == h)
        selected &= valid
    elif sample > 1:
        # sample phase restarts at each read start
        read_start = starts[torch.clamp(rid_a - 1, min=0)]
        selected = valid & ((g - read_start) % sample == 0)
    else:
        selected = valid
    # only the interior zone belongs to this row
    selected = selected & (col >= w - 1) & (col < w - 1 + step)

    packed = (canon << 2) | (is_fwd.to(torch.int64) << 1) | 1
    return torch.where(selected, packed, torch.zeros_like(packed))
