"""Batched edit distance and anchored divergence estimation.

Port of `flye_tpu/ops/align.py`.  The reference's base-level divergence
path (edlib NW over whole overlap regions with optional homopolymer
compression, reference: src/sequence/alignment.cpp:218-247, 52-70)
becomes an anchored formulation: between consecutive chain anchors the
sequences differ only locally, so an overlap's edit distance decomposes
into short independent segment alignments, batched into [B, S] lanes.

`edit_distance_batch` is the wrapper of the K5 kernel: on a CUDA tensor
it launches `csrc/levenshtein.cu`; on a CPU tensor it runs the plain
version `_edit_distance_plain` (a Levenshtein row scan whose in-row
dependency resolves as a prefix-min, cummin of tmp[k] - k), which is
also the kernel's oracle.  The repeat stage reaches it on every read
type: the repeat graph is built from disjointig self-overlaps with
`nucl_alignment=True` (`repeat/driver.py`), whose segments
`SegmentBatcher.run` scores here.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from flye_tpu_torch.ops import _cuda

# segment-length buckets
SEGMENT_BUCKETS = (16, 64, 256, 1024)
# widest rows the kernel takes (one warp's row + characters must fit in
# shared memory)
_MAX_WIDTH = 16384


def edit_distance_batch(a: torch.Tensor, alen: torch.Tensor,
                        b: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance for B sequence pairs.

    a, b: [B, S] uint8 codes (padding arbitrary); alen, blen: [B] int32
    with 0 <= alen and 0 <= blen <= S, all on one device.  Returns [B] int32
    distances.  CPU tensors take the plain version, CUDA tensors the K5
    kernel.
    """
    if a.device.type == "cpu":
        return _edit_distance_plain(a, alen, b, blen)
    return _edit_distance_cuda(a, alen, b, blen)


def _edit_distance_plain(a: torch.Tensor, alen: torch.Tensor,
                         b: torch.Tensor, blen: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version: one tensor row update per row of a."""
    B, S = a.shape
    dev = a.device
    big = 2 ** 30
    js = torch.arange(S + 1, dtype=torch.int32, device=dev)
    prev = js.expand(B, S + 1)
    alen = alen.to(torch.int32)
    result = torch.where(alen[:, None] == 0, prev,
                         torch.full_like(prev, big))
    bb = b.to(torch.int32)
    a32 = a.to(torch.int32)
    # rows past the longest a never reach `result`
    n = min(S, int(alen.max())) if B else 0
    for i in range(n):
        sub = (a32[:, i:i + 1] != bb).to(torch.int32)          # [B, S]
        # tmp[j] for j>=1: min(prev[j-1] + sub_{j-1}, prev[j] + 1)
        tmp = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
        tmp = torch.cat([torch.full((B, 1), i + 1, dtype=torch.int32,
                                    device=dev), tmp], dim=1)
        # row[j] = min_{k<=j} tmp[k] + (j - k)
        row = torch.cummin(tmp - js, dim=1).values + js
        result = torch.where((alen == i + 1)[:, None], row, result)
        prev = row
    return torch.gather(result, 1,
                        blen.to(torch.int64)[:, None])[:, 0]


def _edit_distance_cuda(a: torch.Tensor, alen: torch.Tensor,
                        b: torch.Tensor, blen: torch.Tensor
                        ) -> torch.Tensor:
    """Launch K5 (csrc/levenshtein.cu) on the tensors' CUDA device."""
    B, S = a.shape
    dev = a.device
    _cuda.require(a, "a", torch.uint8, (B, S), dev)
    _cuda.require(b, "b", torch.uint8, (B, S), dev)
    _cuda.require(alen, "alen", torch.int32, (B,), dev)
    _cuda.require(blen, "blen", torch.int32, (B,), dev)
    if not 1 <= S <= _MAX_WIDTH:
        raise ValueError(f"segment width {S} outside 1..{_MAX_WIDTH}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _cuda.lib("levenshtein").levenshtein_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(a), _cuda.ptr(alen), _cuda.ptr(b), _cuda.ptr(blen),
             _cuda.ptr(out), B, S, _cuda.stream_ptr(dev))
    _cuda.check(err, "levenshtein")
    _cuda.LAUNCHES["levenshtein"] += 1
    return out


def hpc_compress(codes: np.ndarray) -> np.ndarray:
    """Homopolymer-compress a code array (host)."""
    if len(codes) == 0:
        return codes
    keep = np.concatenate([[True], codes[1:] != codes[:-1]])
    return codes[keep]


class SegmentBatcher:
    """Accumulates (a, b) segment pairs and scores them bucketed by
    length, amortizing kernel launches across many overlaps."""

    def __init__(self):
        self._segments: List[Tuple[np.ndarray, np.ndarray]] = []

    def add(self, a: np.ndarray, b: np.ndarray) -> int:
        self._segments.append((a, b))
        return len(self._segments) - 1

    def run(self) -> np.ndarray:
        """Edit distance for every added pair, preserving order."""
        n = len(self._segments)
        out = np.zeros(n, dtype=np.int64)
        by_bucket = {}
        for i, (a, b) in enumerate(self._segments):
            m = max(len(a), len(b))
            bucket = None
            for s in SEGMENT_BUCKETS:
                if m <= s:
                    bucket = s
                    break
            if bucket is None:
                # segment longer than the largest bucket: truncate the
                # tails and charge the length difference (rare giant
                # indels between anchors)
                s = SEGMENT_BUCKETS[-1]
                out[i] += max(len(a), len(b)) - min(s, min(len(a), len(b)))
                a, b = a[:s], b[:s]
                bucket = s
            by_bucket.setdefault(bucket, []).append((i, a, b))
        for bucket, items in by_bucket.items():
            # rows padded to a power of two (the JAX package's batch
            # shapes); padded rows have zero lengths -> distance 0
            B = 1 << max(4, (len(items) - 1).bit_length())
            av = np.zeros((B, bucket), dtype=np.uint8)
            bv = np.zeros((B, bucket), dtype=np.uint8)
            al = np.zeros(B, dtype=np.int32)
            bl = np.zeros(B, dtype=np.int32)
            for r, (_, a, b) in enumerate(items):
                av[r, :len(a)] = a
                bv[r, :len(b)] = b
                al[r] = len(a)
                bl[r] = len(b)
            from flye_tpu_torch.parallel.runtime import get_runtime
            d = edit_distance_batch(
                *get_runtime().shard_rows(av, al, bv, bl)).cpu().numpy()
            for r, (i, _, _) in enumerate(items):
                out[i] += int(d[r])
        self._segments = []
        return out


def anchored_divergence(cur_codes: np.ndarray, ext_codes: np.ndarray,
                        anchors: np.ndarray, k: int,
                        use_hpc: bool = False,
                        batcher: Optional[SegmentBatcher] = None):
    """Split an overlap at its k-mer anchors and queue the inter-anchor
    segments for batched edit-distance scoring.

    anchors: [N, 2] ascending (cur_pos, ext_pos) including both overlap
    ends (the engine appends them). Returns a closure that, once the
    batcher has run, yields (divergence, per-segment distances).
    """
    own = batcher is None
    if own:
        batcher = SegmentBatcher()
    seg_ids = []
    spans = []
    for (c0, e0), (c1, e1) in zip(anchors[:-1], anchors[1:]):
        a = cur_codes[c0:c1]
        b = ext_codes[e0:e1]
        if use_hpc:
            a, b = hpc_compress(a), hpc_compress(b)
        spans.append((c1 - c0, e1 - e0))
        if len(a) == 0 and len(b) == 0:
            seg_ids.append(None)
        else:
            seg_ids.append(batcher.add(a, b))

    def finish(dists: np.ndarray):
        total = 0
        per_seg = []
        for sid in seg_ids:
            d = 0 if sid is None else int(dists[sid])
            per_seg.append(d)
            total += d
        aln_len = max(anchors[-1][0] - anchors[0][0],
                      anchors[-1][1] - anchors[0][1]) + k
        return total / max(1, aln_len), np.asarray(per_seg), np.asarray(spans)

    if own:
        d = batcher.run()
        return finish(d)
    return finish
