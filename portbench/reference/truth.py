"""Accuracy of an output FASTA against the truth genome the benchmark
made: plain numpy and torch, no import of the program.

Each contig is cut into windows of WIN bases (a shorter last one
counts from MIN_WIN bases).  A window is anchored by an exact K-mer at
one of a few offsets, on either strand, at up to MAX_OCC of the truth's
occurrences, on the circular genome; each anchored placement is
aligned against the truth slice around it, PAD bases each side, with
the window aligned whole and the slice's flanks free (semi-global
edit distance).  A window's errors are the least over its placements,
and every placement that reaches that least covers its truth span (an
exact repeat is covered by a window of any copy).  A window with no
anchor counts all its bases as errors.  The errors over the window
bases are what `qv` and the check read.  Truth bases that no placement
covers, after each span is widened by SLACK bases each side for indel
drift, are counted apart ("uncovered"): a part of the genome that the
assembly left out is no error in its bases, and an assembler may leave
one out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WIN = 2000
MIN_WIN = 200
K = 24
PAD = 200
SLACK = 50
MAX_OCC = 4
OFFSETS = (0.0, 0.25, 0.5, 0.75)
COMPLEMENT = np.array([3, 2, 1, 0], np.uint8)


def pack_kmers(seq: np.ndarray, k: int = K) -> np.ndarray:
    """2-bit packed k-mers at every start of seq, uint64."""
    n = len(seq) - k + 1
    out = np.zeros(max(n, 0), np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | seq[i:i + n].astype(np.uint64)
    return out


def semi_global(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                blen: torch.Tensor) -> torch.Tensor:
    """Least edits to align a[:alen] whole against any substring of
    b[:blen], per row: [B, Sa] and [B, Sb] uint8, lengths [B] int32 >= 1.
    One row of the DP per base of a; the in-row gap chain resolved by a
    cummin."""
    B, Sa = a.shape
    Sb = b.shape[1]
    dev = a.device
    js = torch.arange(Sb + 1, dtype=torch.int32, device=dev)
    prev = torch.zeros((B, Sb + 1), dtype=torch.int32, device=dev)
    big = torch.full((B, Sb + 1), 2 ** 30, dtype=torch.int32, device=dev)
    result = big
    bb = b.to(torch.int32)
    a32 = a.to(torch.int32)
    col_ok = js[None, :] <= blen[:, None]
    n = int(alen.max()) if B else 0
    for i in range(n):
        sub = (a32[:, i:i + 1] != bb).to(torch.int32)
        tmp = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
        tmp = torch.cat([torch.full((B, 1), i + 1, dtype=torch.int32,
                                    device=dev), tmp], dim=1)
        row = torch.cummin(tmp - js, dim=1).values + js
        result = torch.where((alen == i + 1)[:, None], row, result)
        prev = row
    return torch.where(col_ok, result, big).min(dim=1).values


class Truth:
    """A truth genome (circular) with its k-mer index."""

    def __init__(self, genome: np.ndarray):
        self.genome = genome
        self.glen = len(genome)
        ext = np.concatenate([genome, genome[:K - 1]])
        kms = pack_kmers(ext)
        self.order = np.argsort(kms, kind="stable")
        self.sorted = kms[self.order]
        self.ring = np.concatenate([genome] * 3)

    def occurrences(self, km: int) -> np.ndarray:
        lo = np.searchsorted(self.sorted, np.uint64(km), side="left")
        hi = np.searchsorted(self.sorted, np.uint64(km), side="right")
        return self.order[lo:min(hi, lo + MAX_OCC)]


def windows(contigs):
    """(contig index, start, length) of every window of the contigs."""
    out = []
    for ci, (_, seq) in enumerate(contigs):
        n = len(seq)
        for st in range(0, n, WIN):
            ln = min(WIN, n - st)
            if ln >= MIN_WIN:
                out.append((ci, st, ln))
    return out


def score_job(contigs, genome: np.ndarray, device) -> dict:
    """Errors of one job's output against its truth: {"errors",
    "bases"} over the windows, the windows with any error (an
    unanchored one among them), the windows anchored and not, and the
    truth bases no window covers."""
    truth = Truth(genome)
    glen = truth.glen
    rows = []      # (window id, aligned seq, truth start on the ring)
    wins = windows(contigs)
    for wid, (ci, st, ln) in enumerate(wins):
        w = contigs[ci][1][st:st + ln]
        for off in OFFSETS:
            o = min(int(off * ln), ln - K)
            if o < 0:
                break
            hits = []
            for strand, cand in (("+", w), ("-", COMPLEMENT[w[::-1]])):
                km = int(pack_kmers(cand[o:o + K])[0])
                for tpos in truth.occurrences(km):
                    rows.append((wid, cand, int(tpos) - o))
                    hits.append(tpos)
            if hits:
                break
    n_win = len(wins)
    win_bases = sum(ln for _, _, ln in wins)
    best = np.full(n_win, -1, np.int64)
    covered = np.zeros(glen, bool)
    if rows:
        Sa = max(len(r[1]) for r in rows)
        Sb = Sa + 2 * PAD
        A = np.zeros((len(rows), Sa), np.uint8)
        Bm = np.zeros((len(rows), Sb), np.uint8)
        alen = np.zeros(len(rows), np.int32)
        blen = np.zeros(len(rows), np.int32)
        for r, (_, seq, t0) in enumerate(rows):
            A[r, :len(seq)] = seq
            lo = glen + t0 - PAD
            sl = truth.ring[lo:lo + len(seq) + 2 * PAD]
            Bm[r, :len(sl)] = sl
            alen[r] = len(seq)
            blen[r] = len(sl)
        d = np.empty(len(rows), np.int64)
        step = 256
        for r0 in range(0, len(rows), step):
            sl = slice(r0, r0 + step)
            d[sl] = semi_global(
                torch.from_numpy(A[sl]).to(device),
                torch.from_numpy(alen[sl]).to(device),
                torch.from_numpy(Bm[sl]).to(device),
                torch.from_numpy(blen[sl]).to(device)).cpu().numpy()
        wid = np.array([r[0] for r in rows])
        for r in range(len(rows)):
            if best[wid[r]] < 0 or d[r] < best[wid[r]]:
                best[wid[r]] = d[r]
        for r, (w_, seq, t0) in enumerate(rows):
            if d[r] == best[w_]:
                lo = t0 - SLACK
                idx = np.arange(lo, t0 + len(seq) + SLACK) % glen
                covered[idx] = True
    lens = np.array([ln for _, _, ln in wins], np.int64)
    unanchored = best < 0
    win_errors = int(best[~unanchored].sum() + lens[unanchored].sum())
    uncovered = int(glen - covered.sum())
    return {"errors": win_errors, "bases": win_bases, "windows": n_win,
            "erring_windows": int((best != 0).sum()),
            "unanchored": int(unanchored.sum()), "uncovered": uncovered}


def qv(errors: int, bases: int) -> float:
    """Phred accuracy, -10 log10(errors / bases), with errors counted as
    at least 1: the cap is 10 log10(bases)."""
    if bases <= 0:
        return 0.0
    return -10.0 * math.log10(max(errors, 1) / bases)
