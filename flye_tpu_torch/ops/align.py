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
`SegmentBatcher.run` scores here.  The base-alignment read types
(`reads_base_alignment=1`, e.g. HiFi) score the segments of every read
overlap too, millions per batch of reads, so the segment path (split,
homopolymer compression, bucketing, padding) runs as array operations
over whole overlaps rather than a loop over segments.

On one card the engine skips the host side of that path:
`anchored_distances` takes a batch's anchors as one flat array and the
reads as `ResidentStrands` (both strands, and their homopolymer runs,
which the engine keeps on the device), derives every segment there
(`csrc/levenshtein.cu` `anchor_geometry`), gathers each bucket's rows
from the resident codes (`anchor_rows`) and scores them with K5 through
`edit_distance_batch`; the bucket counts and the distances come back in
one read each.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.utils import trace

# segment-length buckets
SEGMENT_BUCKETS = (16, 64, 256, 1024)
# widest rows the kernel takes (a pair on a warp's 32 lanes of eight
# 64-bit words each)
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
    _cuda.launch("levenshtein", fn, dev, _cuda.ptr(a), _cuda.ptr(alen),
                 _cuda.ptr(b), _cuda.ptr(blen), _cuda.ptr(out), B, S)
    return out


def _tile_segments(codes: np.ndarray, pos: np.ndarray, use_hpc: bool):
    """The segments codes[pos[i]:pos[i+1]] of non-decreasing positions,
    each homopolymer-compressed on its own when use_hpc (its first base
    kept, then every base unlike its predecessor), as one concatenation
    and the segment lengths.  The segments tile [pos[0], pos[-1]), so a
    few array operations do what a loop over segments would."""
    n = len(codes)
    if len(pos) < 2:
        return codes[:0], np.zeros(0, dtype=np.int64)
    lo = np.minimum(pos[:-1], n)
    hi = np.maximum(np.minimum(pos[1:], n), lo)
    span = codes[lo[0]:hi[-1]]
    if not use_hpc:
        return span, (hi - lo).astype(np.int64)
    keep = np.ones(len(span), dtype=bool)
    keep[1:] = span[1:] != span[:-1]
    starts = (lo - lo[0])[hi > lo]
    keep[starts] = True
    csum = np.concatenate([[0], np.cumsum(keep)])
    return span[keep], csum[hi - lo[0]] - csum[lo - lo[0]]


class SegmentBatcher:
    """Accumulates (a, b) segment pairs and scores them bucketed by
    length, amortizing kernel launches across many overlaps.  Segments
    are kept as concatenations with their lengths, and `run` builds the
    padded [B, S] rows of each bucket with array operations."""

    def __init__(self):
        self._parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]] = []
        self._n = 0

    def add(self, a: np.ndarray, b: np.ndarray) -> int:
        return int(self.add_many(a, np.array([len(a)]), b,
                                 np.array([len(b)]))[0])

    def add_many(self, a_flat: np.ndarray, a_lens: np.ndarray,
                 b_flat: np.ndarray, b_lens: np.ndarray) -> np.ndarray:
        """Queue the pairs whose a sides are consecutive pieces of
        a_flat (lengths a_lens) and b sides of b_flat; returns their
        ids."""
        ids = np.arange(self._n, self._n + len(a_lens))
        self._n += len(a_lens)
        self._parts.append((np.asarray(a_flat, np.uint8),
                            np.asarray(a_lens, np.int64),
                            np.asarray(b_flat, np.uint8),
                            np.asarray(b_lens, np.int64)))
        return ids

    def run(self) -> np.ndarray:
        """Edit distance for every added pair, preserving order."""
        out = np.zeros(self._n, dtype=np.int64)
        if self._n == 0:
            return out
        trace.count("align.packed_segments", self._n)
        a_flat, al, b_flat, bl = (np.concatenate(x) for x in
                                  zip(*self._parts))
        self._parts, self._n = [], 0
        a_start = np.cumsum(al) - al
        b_start = np.cumsum(bl) - bl
        m = np.maximum(al, bl)
        # the smallest bucket that holds the longer side; a segment
        # longer than the largest bucket is cut to it, tails dropped, and
        # charged the length difference (rare giant indels between
        # anchors)
        top = SEGMENT_BUCKETS[-1]
        over = m > top
        out[over] += m[over] - np.minimum(top, np.minimum(al, bl)[over])
        al, bl = np.minimum(al, top), np.minimum(bl, top)
        bucket = np.asarray(SEGMENT_BUCKETS)[np.minimum(
            np.searchsorted(SEGMENT_BUCKETS, m), len(SEGMENT_BUCKETS) - 1)]
        from flye_tpu_torch.parallel.runtime import get_runtime
        for s in SEGMENT_BUCKETS:
            rows = np.flatnonzero(bucket == s)
            if not len(rows):
                continue
            # rows padded to a power of two (the JAX package's batch
            # shapes); padded rows have zero lengths -> distance 0
            B = 1 << max(4, (len(rows) - 1).bit_length())
            with trace.span("align: pack"):
                av = _pad_rows(a_flat, a_start[rows], al[rows], B, s)
                bv = _pad_rows(b_flat, b_start[rows], bl[rows], B, s)
                alp = np.zeros(B, dtype=np.int32)
                blp = np.zeros(B, dtype=np.int32)
                alp[:len(rows)] = al[rows]
                blp[:len(rows)] = bl[rows]
            with trace.span("align: distance"):
                d = trace.readback(edit_distance_batch(
                    *get_runtime().shard_rows(av, alp, bv, blp))
                ).cpu().numpy()
            out[rows] += d[:len(rows)]
        return out


def _pad_rows(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
              B: int, S: int) -> np.ndarray:
    """[B, S] uint8 rows: row r holds flat[starts[r]:starts[r] +
    lens[r]], zeros after it and in the rows past len(starts)."""
    out = np.zeros((B, S), dtype=np.uint8)
    padded = np.concatenate([flat, np.zeros(S, dtype=np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, S)[starts]
    out[:len(starts)] = np.where(np.arange(S) < lens[:, None], win, 0)
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
    anchors = np.asarray(anchors)
    c, e = anchors[:, 0], anchors[:, 1]
    if (np.diff(c) < 0).any() or (np.diff(e) < 0).any():
        raise ValueError("anchors must ascend in both coordinates")
    spans = np.stack([np.diff(c), np.diff(e)], axis=1)
    a_flat, a_lens = _tile_segments(cur_codes, c, use_hpc)
    b_flat, b_lens = _tile_segments(ext_codes, e, use_hpc)
    # a segment empty on both sides scores 0 without a pair
    live = (a_lens > 0) | (b_lens > 0)
    seg_ids = np.full(len(live), -1, dtype=np.int64)
    seg_ids[live] = batcher.add_many(a_flat, a_lens[live], b_flat,
                                     b_lens[live])

    def finish(dists: np.ndarray):
        per_seg = np.zeros(len(seg_ids), dtype=np.int64)
        per_seg[live] = dists[seg_ids[live]]
        total = int(per_seg.sum())
        aln_len = max(anchors[-1][0] - anchors[0][0],
                      anchors[-1][1] - anchors[0][1]) + k
        return total / max(1, aln_len), per_seg, spans

    if own:
        d = batcher.run()
        return finish(d)
    return finish


# ------------------------------------------------------------------
# Anchored segments from device-resident strands

class ResidentStrands:
    """Both strands of every sequence of a SequenceStore on one device.

    The strands lie end to end, the forward arena and then its reverse
    complement, so strand id s starts at `base(s)`.  Without `use_hpc`
    `codes` holds those bases and `run` is None.  With it, `run[p]` is
    the number of the homopolymer run that holds base p and `codes`
    holds each run's code (the bases themselves are not kept): a
    segment [lo, hi) of a strand, compressed on its own as
    `_tile_segments` compresses it (its first base, then every base
    unlike its predecessor), is then codes[run[lo]:run[hi - 1] + 1]."""

    def __init__(self, store, device, use_hpc: bool):
        self.n_seqs = len(store)
        self.device = torch.device(device)
        self.offsets = np.zeros(self.n_seqs + 1, dtype=np.int64)
        np.cumsum(store.lengths, out=self.offsets[1:])
        self.total = int(self.offsets[-1])
        fwd = torch.as_tensor(store.arena).to(self.device)
        rev = fwd.flip(0)
        # codes past 3 have no complement and stay as they are
        raw = torch.cat([fwd, torch.where(rev < 4, 3 - rev, rev)])
        del fwd, rev
        self.run = None
        self.codes = raw
        if use_hpc:
            keep = torch.ones_like(raw, dtype=torch.bool)
            keep[1:] = raw[1:] != raw[:-1]
            self.run = torch.cumsum(keep, 0, dtype=torch.int32) - 1
            self.codes = raw[keep]

    def base(self, sids: np.ndarray) -> np.ndarray:
        """Where each strand id starts in the strands (int64)."""
        sids = np.asarray(sids, dtype=np.int64)
        idx = sids >> 1
        return np.where(sids & 1, 2 * self.total - self.offsets[idx + 1],
                        self.offsets[idx])


class _Widths(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("w", ctypes.c_int * 8)]


def anchor_geometry(anc, aov, ovm, a_run, b_run, widths):
    """The two segments of every pair slot of a batch's anchors.

    anc: int32 [N, 2] (cur, ext) anchors; aov: int32 [N] the overlap of
    each; ovm: int64 [n_ov, 4] per overlap where its a-side strand
    starts and its length, then the same of its b side; a_run, b_run:
    the sides' run indexes (`ResidentStrands.run`) or None; widths: the
    row widths, ascending.  Pair slot j joins anchors j and j + 1 (a
    slot across two overlaps is empty).  Each side is clamped to its
    strand as `_tile_segments` clamps it, then taken as a slice of the
    strand's codes (its run slice with a run index); a side longer than
    the widest row is cut to it and the slot charged what
    `SegmentBatcher.run` charges.  Returns [N - 1] int64 offsets into
    each side's codes and int32 lengths, charges and keys (0: nothing to
    score, else 1 + the bucket).  CPU tensors take the plain version,
    CUDA tensors the `anchor_geometry` kernel (csrc/levenshtein.cu)."""
    if anc.device.type == "cpu":
        return _anchor_geometry_plain(anc, aov, ovm, a_run, b_run, widths)
    return _anchor_geometry_cuda(anc, aov, ovm, a_run, b_run, widths)


def _anchor_geometry_plain(anc, aov, ovm, a_run, b_run, widths):
    """Plain version of `anchor_geometry`, on any device."""
    top = widths[-1]
    live = aov[1:] == aov[:-1]
    m = ovm[aov[:-1].long()]

    def side(p0, p1, base, n, run):
        lo = torch.minimum(p0, n)
        hi = torch.maximum(torch.minimum(p1, n), lo)
        on = live & (hi > lo)
        if run is None:
            off, ln = base + lo, hi - lo
        else:
            r0 = run[torch.where(on, base + lo, 0)].long()
            r1 = run[torch.where(on, base + hi - 1, 0)].long()
            off, ln = r0, r1 - r0 + 1
        return torch.where(on, off, 0), torch.where(on, ln, 0)

    c, e = anc[:, 0].long(), anc[:, 1].long()
    a_off, al = side(c[:-1], c[1:], m[:, 0], m[:, 1], a_run)
    b_off, bl = side(e[:-1], e[1:], m[:, 2], m[:, 3], b_run)
    longer = torch.maximum(al, bl)
    extra = torch.where(longer > top, longer - torch.clamp(
        torch.minimum(al, bl), max=top), 0)
    al, bl = torch.clamp(al, max=top), torch.clamp(bl, max=top)
    w = torch.as_tensor(widths, dtype=torch.int64, device=anc.device)
    key = torch.where((al > 0) | (bl > 0), 1 + torch.searchsorted(
        w, torch.maximum(al, bl)), 0)
    return (a_off, b_off, al.to(torch.int32), bl.to(torch.int32),
            extra.to(torch.int32), key.to(torch.int32))


def _anchor_geometry_cuda(anc, aov, ovm, a_run, b_run, widths):
    """Launch `anchor_geometry` (csrc/levenshtein.cu)."""
    dev = anc.device
    N = anc.shape[0]
    P = N - 1
    _cuda.require(anc, "anchors", torch.int32, (N, 2), dev)
    _cuda.require(aov, "anchor_ov", torch.int32, (N,), dev)
    _cuda.require(ovm, "ov_strands", torch.int64, (ovm.shape[0], 4), dev)
    for r in (a_run, b_run):
        if r is not None:
            _cuda.require(r, "run", torch.int32, (r.shape[0],), dev)
    a_off = torch.empty(P, dtype=torch.int64, device=dev)
    b_off = torch.empty_like(a_off)
    al, bl, extra, key = (torch.empty(P, dtype=torch.int32, device=dev)
                          for _ in range(4))
    w = _Widths(len(widths), (ctypes.c_int * 8)(*widths))
    fn = _cuda.lib("levenshtein").anchor_geometry_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, _Widths]
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    null = ctypes.c_void_p(0)
    _cuda.launch("anchor_geometry", fn, dev, _cuda.ptr(anc),
                 _cuda.ptr(aov), _cuda.ptr(ovm),
                 null if a_run is None else _cuda.ptr(a_run),
                 null if b_run is None else _cuda.ptr(b_run), P, w,
                 _cuda.ptr(a_off), _cuda.ptr(b_off), _cuda.ptr(al),
                 _cuda.ptr(bl), _cuda.ptr(extra), _cuda.ptr(key))
    return a_off, b_off, al, bl, extra, key


def anchor_rows(a_codes, b_codes, a_off, b_off, al, bl, idx, S):
    """K5's rows of the pair slots idx (int64 [n]): uint8 [n, S] rows
    of each side, row r holding codes[off[idx[r]]:][:len[idx[r]]] and
    zeros after it, with the int32 lengths, as (a, alen, b, blen).  S is
    a multiple of 4 and at least every length.  CPU tensors take the
    plain version, CUDA tensors the `anchor_rows` kernel
    (csrc/levenshtein.cu)."""
    if idx.device.type == "cpu":
        return _anchor_rows_plain(a_codes, b_codes, a_off, b_off, al, bl,
                                  idx, S)
    return _anchor_rows_cuda(a_codes, b_codes, a_off, b_off, al, bl, idx, S)


def _anchor_rows_plain(a_codes, b_codes, a_off, b_off, al, bl, idx, S):
    """Plain version of `anchor_rows`, on any device."""
    cols = torch.arange(S, device=idx.device)

    def side(codes, off, ln):
        o, n = off[idx], ln[idx]
        inside = cols < n[:, None]
        rows = codes[torch.where(inside, o[:, None] + cols, 0)]
        return torch.where(inside, rows, 0).to(torch.uint8), n

    return (*side(a_codes, a_off, al), *side(b_codes, b_off, bl))


def _anchor_rows_cuda(a_codes, b_codes, a_off, b_off, al, bl, idx, S):
    """Launch `anchor_rows` (csrc/levenshtein.cu)."""
    dev = idx.device
    n = idx.shape[0]
    if S % 4:
        raise ValueError(f"row width {S} is not a multiple of 4")
    _cuda.require(idx, "idx", torch.int64, (n,), dev)
    idx = idx.contiguous()
    a = torch.empty((n, S), dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    alen = torch.empty(n, dtype=torch.int32, device=dev)
    blen = torch.empty_like(alen)
    fn = _cuda.lib("levenshtein").anchor_rows_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    _cuda.launch("anchor_rows", fn, dev, _cuda.ptr(a_codes),
                 _cuda.ptr(b_codes), _cuda.ptr(idx), n, S,
                 _cuda.ptr(a_off), _cuda.ptr(b_off), _cuda.ptr(al),
                 _cuda.ptr(bl), _cuda.ptr(a), _cuda.ptr(b),
                 _cuda.ptr(alen), _cuda.ptr(blen))
    return a, alen, b, blen


def anchored_distances(a_res: ResidentStrands, b_res: ResidentStrands,
                       anchors: np.ndarray, anchor_ov: np.ndarray,
                       ov_strands: np.ndarray):
    """Edit distances of the segments between consecutive anchors, as
    `anchored_divergence` + `SegmentBatcher.run` score them, from the
    resident strands.

    anchors: [N, 2] (cur, ext) positions, each overlap's run of anchors
    ascending; anchor_ov: [N] the overlap of each anchor (runs of equal
    ids); ov_strands: [n_ov, 4] the overlap's a-side strand (its `base`
    in a_res, its length) and b-side strand in b_res.  Returns the
    distance of every pair slot j (anchors j and j + 1; 0 across two
    overlaps) as int64 numpy [N - 1]; the pairs scored are counted as
    `align.anchored_segments`.  The segments are derived by
    `anchor_geometry`, each bucket's rows gathered by `anchor_rows` and
    scored by `edit_distance_batch`, on the strands' device.
    """
    dev = a_res.device
    P = len(anchors) - 1
    if P <= 0:
        return np.zeros(0, dtype=np.int64)
    anc = torch.as_tensor(np.ascontiguousarray(anchors, np.int32)).to(dev)
    aov = torch.as_tensor(np.ascontiguousarray(anchor_ov, np.int32)).to(
        dev)
    ovm = torch.as_tensor(np.ascontiguousarray(ov_strands, np.int64)).to(
        dev)
    a_off, b_off, al, bl, extra, key = anchor_geometry(
        anc, aov, ovm, a_res.run, b_res.run, SEGMENT_BUCKETS)
    counts = trace.readback(torch.bincount(
        key.long(), minlength=1 + len(SEGMENT_BUCKETS))).cpu().tolist()
    order = torch.argsort(key, stable=True)
    dist = extra
    start = counts[0]
    for s, n in zip(SEGMENT_BUCKETS, counts[1:]):
        if not n:
            continue
        idx = order[start:start + n]
        start += n
        dist[idx] += edit_distance_batch(*anchor_rows(
            a_res.codes, b_res.codes, a_off, b_off, al, bl, idx, s))
    trace.count("align.anchored_segments", P - counts[0])
    return trace.readback(dist).cpu().numpy().astype(np.int64)
