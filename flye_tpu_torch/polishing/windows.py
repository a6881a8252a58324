"""Anchor-based bubble partitioning for polishing.

The reference partitions each contig at "solid" positions computed from
a base-level pileup profile (reference: flye/polishing/bubbles.py:317-359
_get_partition, solidity :220-236) that requires SAM alignments.  Here
solidity comes from the mapping anchors instead: a draft position where
many reads share an exact-match k-mer anchor is solid by construction.
Bubble boundaries are chosen at anchor-popular positions spaced at most
max_bubble apart; each covering read is sliced at its own anchor via
diagonal extrapolation from the nearest anchor (exact when no indel lies
between, off by at most the local indel count otherwise).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.utils import trace

logger = logging.getLogger("flye_tpu_torch")


@dataclass
class Bubble:
    target_id: int
    position: int                  # bubble index along the target
    start: int                     # draft coords (core, without pads)
    end: int
    candidate: np.ndarray          # uint8 codes incl. pads
    branches: List[np.ndarray] = field(default_factory=list)
    polished: Optional[np.ndarray] = None
    # overlap pads: the candidate/branches extend this many draft bases
    # beyond [start, end) on each side; compose() re-joins adjacent
    # polished bubbles at an exact-match switch point inside the
    # overlap, so junctions carry no slice noise (the same switch-point
    # idiom as the disjointig stitcher, assemble/stitch.py; reference
    # analog: consensus_generator.cpp:129-159 exact-run switch points)
    pad_left: int = 0
    pad_right: int = 0

    @property
    def sub_bubbles(self):
        return []


def _project(anchors: np.ndarray, p: int) -> Tuple[int, int]:
    """Read coordinate for draft position p by diagonal extrapolation
    from the nearest anchor (anchors [N,2] = (draft, read), ascending).
    Returns (read_pos, distance_to_nearest_anchor)."""
    i = int(np.searchsorted(anchors[:, 0], p))
    if i == 0:
        c, e = anchors[0]
    elif i >= len(anchors):
        c, e = anchors[-1]
    else:
        # nearest of the two flanking anchors
        if p - anchors[i - 1][0] <= anchors[i][0] - p:
            c, e = anchors[i - 1]
        else:
            c, e = anchors[i]
    return int(e) + (p - int(c)), abs(p - int(c))


_REFINE_M = 12  # boundary-marker length (bases)
# fine-partition constants (reference: flye/config/py_cfg.py:41-43 and
# _get_partition bubbles.py:317-359): boundaries land on
# anchor-supported positions whose sequence context is "simple" (no
# homopolymer / dinucleotide repeat), at least _MIN_SEP apart
_SIMPLE_HALF = 4   # reference simple_kmer_length = 4 -> +-4 context
_MIN_SEP = 10      # reference solid_kmer_length advance
_TARGET_SPAN = 44  # spans above this leave the W=128 kernel buckets


def _simple_mask(d: np.ndarray) -> np.ndarray:
    """Per-position 'simple k-mer' test, vectorized (behavioral port
    of _is_simple_kmer, reference: flye/polishing/bubbles.py:239-270):
    a center position p is simple iff no single-nucleotide repeat lies
    in d[p-2:p+2] and no dinucleotide repeat pattern in d[p-4:p+4]."""
    L = len(d)
    ok = np.ones(L, dtype=bool)
    if L < 2 * _SIMPLE_HALF + 1:
        ok[:] = False
        return ok
    # single-nucleotide: d[q] == d[q+1] kills centers p in {q, q+1, q+2}
    eq = d[:-1] == d[1:]                      # eq[q], q in [0, L-2]
    bad = np.zeros(L, dtype=bool)
    for off in range(3):                      # p = q + off
        n = min(len(eq), L - off)
        bad[off:off + n] |= eq[:n]
    # dinucleotide: d[q:q+2] == d[q+2:q+4] kills centers p in [q, q+4]
    if L >= 4:
        deq = (d[:-3] == d[2:-1]) & (d[1:-2] == d[3:])  # deq[q]
        for off in range(5):                  # p = q + off
            n = min(len(deq), L - off)
            bad[off:off + n] |= deq[:n]
    ok &= ~bad
    # context must fit inside the sequence
    ok[:_SIMPLE_HALF] = False
    ok[L - _SIMPLE_HALF:] = False
    return ok


def _refine(read_codes: np.ndarray, marker: np.ndarray, center: int,
            dist: int) -> int:
    """Snap an extrapolated read coordinate onto the exact occurrence of
    the draft's boundary marker k-mer nearest to it.

    Extrapolation across a gap of `dist` draft bases can be off by the
    local indel count (~15% of dist for raw reads); searching a window
    of that radius for the exact marker makes the slice boundary exact
    whenever the read matches the draft at the boundary — the same
    "solid position" invariant the reference's partition relies on
    (reference: flye/polishing/bubbles.py:220-236 solidity test)."""
    m = len(marker)
    if m < _REFINE_M:
        return center
    radius = min(48, 4 + (dist * 2) // 10)
    lo = max(0, center - radius)
    hi = min(len(read_codes) - m, center + radius)
    if hi < lo:
        return center
    win = np.lib.stride_tricks.sliding_window_view(
        read_codes[lo:hi + m], m)
    hits = np.nonzero((win == marker).all(axis=1))[0]
    if len(hits) == 0:
        return center
    return int(lo + hits[np.argmin(np.abs(hits + lo - center))])


def make_bubbles(target_id: int, draft: np.ndarray,
                 alignments: List[Overlap], reads: SequenceStore,
                 max_bubble: int = 500, min_aln_length: int = 500,
                 max_branches: int = 50,
                 min_boundary_frac: float = 0.3) -> List[Bubble]:
    """Partition one draft sequence into bubbles with read branches."""
    L = len(draft)
    alns = [a for a in alignments if a.cur_range >= min_aln_length
            and a.kmer_matches is not None and len(a.kmer_matches) >= 2]
    if not alns:
        return []

    with trace.span("bubbles: cut"):
        # anchor popularity + coverage per draft position
        anchor_count = np.zeros(L + 1, dtype=np.int32)
        coverage = np.zeros(L + 1, dtype=np.int32)
        for a in alns:
            km = a.kmer_matches
            pos = km[:, 0]
            anchor_count[np.clip(pos, 0, L)] += 1
            coverage[a.cur_begin:a.cur_end] += 1

        # boundaries: EVERY anchor-supported 'simple' position >= _MIN_SEP
        # from its predecessor (the fine partition that the reference's
        # solid/simple machinery produces — median bubble ~15-50 bp — where
        # round 2 cut ~125-500 bp windows; small bubbles are what lets the
        # single-edit hill climb + homopolymer pass reach reference
        # identity, reference: bubbles.py:317-359), with a max_bubble
        # fallback cut across anchor deserts.
        # anchor-span support: an exact-match anchor starting in
        # (p - k_w, p] certifies that its read agrees with the draft
        # across p — the anchor-based analog of the reference's
        # 10-consecutive-solid-positions test (bubbles.py:218-236, which
        # works from a base-level pileup we don't materialize).  The
        # windowed sum is dense wherever reads are locally exact, so
        # boundaries land every ~_MIN_SEP bases in clean sequence instead
        # of only at positions where many reads share the anchor START.
        k_w = 16
        acc = np.zeros(L + 1, dtype=np.int64)
        np.cumsum(anchor_count[:L], out=acc[1:])
        winsum = acc[1:] - acc[np.maximum(np.arange(L) - k_w + 1, 0)]
        qual = winsum / np.maximum(coverage[:L], 1)
        simple = _simple_mask(draft)
        # adaptive solidity: a cut needs at least half the contig's median
        # anchor density (cuts at weakly-supported positions put slice
        # noise at every junction — measured on the parity set, a fixed
        # low threshold cost ~1e-3 identity at ~15 bp bubbles)
        covered = coverage[:L] > 0
        med = float(np.median(qual[covered])) if covered.any() else 0.0
        thr = max(min_boundary_frac, 0.5 * med)
        cand = np.flatnonzero((qual >= thr) & simple)
        cand = cand[(cand >= _MIN_SEP) & (cand < L - _MIN_SEP)]
        # relaxed cut tier: spans longer than _TARGET_SPAN fall off the
        # fast kernel buckets (a span-50 window costs ~3-5x a span-20 one
        # per bubble — polisher bucket geometry), so inside long gaps a
        # weaker anchor-supported simple position still beats either a
        # long window or the blind max_bubble hard cut (which has no
        # anchor support at all)
        relax_ok = (qual >= max(0.5 * thr, 1e-9)) & simple
        relax_ok[:_MIN_SEP] = False
        relax_ok[max(0, L - _MIN_SEP):] = False
        qual_r = np.where(relax_ok, qual, -1.0)
        boundaries = [0]
        prev = 0

        def fill_gap(prev, nxt):
            """Insert relaxed cuts so pieces stay <= _TARGET_SPAN where any
            relaxed position allows it; fall back to max_bubble hard cuts
            across true anchor deserts."""
            while nxt - prev > _TARGET_SPAN:
                lo = prev + _MIN_SEP
                hi = min(prev + _TARGET_SPAN, nxt - _MIN_SEP)
                if hi <= lo:
                    break
                # prefer the upper half of the window (fewer junctions),
                # best quality within it
                half = max(lo, hi - (_TARGET_SPAN // 2))
                seg = qual_r[half:hi + 1]
                if seg.size and seg.max() > 0:
                    cut = half + int(seg.argmax())
                else:
                    seg = qual_r[lo:hi + 1]
                    if seg.size and seg.max() > 0:
                        cut = lo + int(seg.argmax())
                    elif nxt - prev > max_bubble:
                        cut = prev + max_bubble
                    else:
                        break
                boundaries.append(cut)
                prev = cut
            return prev

        for c in cand:
            c = int(c)
            prev = fill_gap(prev, c)
            if c - prev >= _MIN_SEP:
                boundaries.append(c)
                prev = c
        prev = fill_gap(prev, L)
        boundaries.append(L)
        # strict ascent: bubble index bi must equal its boundary-pair index
        # (the vectorized slicing below relies on that mapping)
        boundaries = [b for i, b in enumerate(boundaries)
                      if i == 0 or b > boundaries[i - 1]]

        pad = 12
        bubbles = []
        for bi, (p0, p1) in enumerate(zip(boundaries[:-1], boundaries[1:])):
            pl = min(pad, p0)
            pr = min(pad, L - p1)
            bubbles.append(Bubble(target_id, bi, int(p0), int(p1),
                                  draft[p0 - pl:p1 + pr].copy(),
                                  pad_left=int(pl), pad_right=int(pr)))

    with trace.span("bubbles: branches"):
        # boundary markers: the draft k-mer starting at each (padded) slice
        # position, used to snap extrapolated read slices onto exact matches
        from flye_tpu_torch import native
        mod = native.get()
        bub_l_arr = np.asarray([b.start - b.pad_left for b in bubbles],
                               dtype=np.int64)
        bub_r_arr = np.asarray([b.end + b.pad_right for b in bubbles],
                               dtype=np.int64)

        def marker_rows(pos):
            ml = np.minimum(_REFINE_M, L - pos).astype(np.int32)
            idx = np.minimum(pos[:, None] + np.arange(_REFINE_M), L - 1)
            return np.ascontiguousarray(draft[idx], dtype=np.uint8), ml

        if mod is not None:
            ML, MLl = marker_rows(bub_l_arr)
            MR, MRl = marker_rows(bub_r_arr)
            markers = None
        else:
            markers = {}
            for b in bubbles:
                for p in (b.start - b.pad_left, b.end + b.pad_right):
                    if p not in markers:
                        markers[p] = draft[p:min(p + _REFINE_M, L)]

        # slice branches: all of an alignment's boundary projections run
        # vectorized (at the fine partition there are ~20x more bubbles
        # than round 2's windows; a per-bubble Python loop would dominate)
        bounds_arr = np.asarray(boundaries, dtype=np.int64)
        bub_l = np.asarray([b.start - b.pad_left for b in bubbles],
                           dtype=np.int64)
        bub_r = np.asarray([b.end + b.pad_right for b in bubbles],
                           dtype=np.int64)
        # bubble index bi spans [boundaries[bi], boundaries[bi+1])
        for a in alns:
            km = a.kmer_matches
            read_codes = reads.get(a.ext_id)
            first = int(np.searchsorted(bounds_arr, a.cur_begin,
                                        side="left"))
            last = int(np.searchsorted(bounds_arr, a.cur_end,
                                       side="right")) - 1
            if last <= first:
                continue
            nb = last - first
            pts = np.concatenate([bub_l[first:last], bub_r[first:last]])
            # nearest-anchor diagonal extrapolation (vectorized _project)
            i = np.searchsorted(km[:, 0], pts)
            i0 = np.clip(i - 1, 0, len(km) - 1)
            i1 = np.clip(i, 0, len(km) - 1)
            d0 = np.abs(pts - km[i0, 0])
            d1 = np.abs(pts - km[i1, 0])
            use1 = d1 < d0
            c = np.where(use1, km[i1, 0], km[i0, 0])
            e = np.where(use1, km[i1, 1], km[i0, 1])
            rp = (e + (pts - c)).astype(np.int64)
            dist = np.abs(pts - c).astype(np.int64)
            if mod is not None:
                mk = np.concatenate([ML[first:last], MR[first:last]])
                mkl = np.concatenate([MLl[first:last], MRl[first:last]])
                rp = np.frombuffer(mod.refine_points(
                    np.ascontiguousarray(read_codes, dtype=np.uint8),
                    mk, np.ascontiguousarray(mkl), rp, dist,
                    len(rp), _REFINE_M), np.int64)
            else:
                for j in np.flatnonzero(dist):
                    rp[j] = _refine(read_codes, markers[int(pts[j])],
                                    int(rp[j]), int(dist[j]))
            n_read = len(read_codes)
            # vectorized slice bounds + validity; the Python loop below
            # only walks VALID branches (the per-t min/max/int scalar work
            # was ~60% of extraction wall at 420 kb, profiled)
            rp0 = np.clip(rp[:nb], 0, n_read)
            rp1 = np.maximum(rp0, np.clip(rp[nb:], 0, n_read))
            blen_a = rp1 - rp0
            span_a = bub_r[first:last] - bub_l[first:last]
            # discard wildly divergent branches (bad projections)
            ok = (blen_a >= span_a // 2) & (blen_a <= 2 * span_a + 16)
            for t in np.flatnonzero(ok):
                b = bubbles[first + t]
                if len(b.branches) < max_branches:
                    b.branches.append(read_codes[rp0[t]:rp1[t]])
    return bubbles


_SWITCH_M = 10  # junction switch-point marker length


def trim_low_coverage_ends(bubbles: List[Bubble],
                           min_branches: int = 2) -> List[Bubble]:
    """Drop leading/trailing bubbles with fewer than min_branches read
    branches before composing.

    At linear contig tips read coverage tapers to 1; a 1-branch bubble
    can only converge to that single read's raw sequence (~8-15% error
    measured over the last ~450 bp of the 420 kb parity assembly, 68 of
    its 75 total errors).  The reference avoids this class by building
    consensus strictly from the read pileup, which fades out with
    coverage (reference: flye/polishing/consensus.py:153-181
    _flatten_profile).  Only contig ENDS trim — interior low-coverage
    windows keep the contig intact — and a contig whose every bubble is
    below the threshold is kept whole (tiny/low-coverage sequences,
    e.g. short plasmids, must survive)."""
    bs = sorted(bubbles, key=lambda x: x.position)
    lo, hi = 0, len(bs)
    while lo < hi and len(bs[lo].branches) < min_branches:
        lo += 1
    while hi > lo and len(bs[hi - 1].branches) < min_branches:
        hi -= 1
    return bs[lo:hi] if lo < hi else bs


def compose(bubbles: List[Bubble]) -> np.ndarray:
    """Re-join polished bubbles into one sequence
    (reference: flye/polishing/polish.py:285-312 _compose_sequence).

    Adjacent bubbles overlap by their pads; each junction cuts at an
    exact _SWITCH_M-mer shared between the previous bubble's tail and
    the next bubble's head, nearest the nominal boundary — so slice
    noise at bubble edges never reaches the composed sequence (the
    switch-point idiom of assemble/stitch.py; reference analog:
    consensus_generator.cpp:129-159)."""
    bs = sorted(bubbles, key=lambda x: x.position)
    if not bs:
        return np.zeros(0, dtype=np.uint8)
    m = _SWITCH_M

    def seq_of(b):
        return b.polished if b.polished is not None else b.candidate

    parts = []
    cur = seq_of(bs[0])
    prev_b = bs[0]
    for b in bs[1:]:
        nxt = seq_of(b)
        pr, pl = prev_b.pad_right, b.pad_left
        W = pr + pl + 8
        tail_base = max(0, len(cur) - W - m)
        tb = cur[tail_base:].tobytes()
        hb = nxt[:min(len(nxt), W + m)].tobytes()
        target_i = len(cur) - pr
        best = None

        def _periodic(s: bytes) -> bool:
            # period-1/2/3 markers slide inside homo-/di-/tri-nucleotide
            # runs, which would let the junction gain or lose repeat
            # units; only aperiodic markers may anchor a switch
            return (s[1:] == s[:-1] or s[2:] == s[:-2]
                    or s[3:] == s[:-3])

        if len(hb) >= m and len(tb) >= m:
            head_pos = {}
            for j in range(len(hb) - m + 1):
                kmj = hb[j:j + m]
                if _periodic(kmj):
                    continue
                old_j = head_pos.get(kmj)
                if old_j is None or abs(j - pl) < abs(old_j - pl):
                    head_pos[kmj] = j
            for i in range(len(tb) - m + 1):
                j = head_pos.get(tb[i:i + m])
                if j is None:
                    continue
                gi = tail_base + i
                score = abs(gi - target_i) + abs(j - pl)
                if best is None or score < best[0]:
                    best = (score, gi, j)
        # accept only near-nominal switches: a marker that also occurs
        # ~10 bp away (local repeat) would otherwise duplicate or drop
        # a segment at the junction
        if best is not None and best[0] <= 2 * m:
            _, gi, j = best
            parts.append(cur[:gi])
            cur = nxt[j:]
        else:
            # no exact junction marker: nominal pad trim
            parts.append(cur[:max(0, len(cur) - pr)])
            cur = nxt[min(pl, len(nxt)):]
        prev_b = b
    parts.append(cur)
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)
