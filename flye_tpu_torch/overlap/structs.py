"""Overlap record: coordinates of an alignment between two sequences.

Behavioral port of OverlapRange (reference: src/sequence/overlap.h:60-251):
strand-aware ids, cur/ext coordinate pairs, score, divergence, optional
sparse k-mer match trace used for coordinate projection, and the
reverse()/complement()/project() coordinate algebra that the repeat graph
depends on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from flye_tpu_torch.io.seqstore import SeqId


@dataclass(slots=True)
class Overlap:
    cur_id: int
    ext_id: int
    cur_begin: int
    cur_end: int
    cur_len: int
    ext_begin: int
    ext_end: int
    ext_len: int
    score: int = 0
    divergence: float = 0.0
    # optional [N,2] int32 (cur_pos, ext_pos) sparse match anchors,
    # ascending in cur_pos, with the overlap ends appended
    kmer_matches: Optional[np.ndarray] = None

    # ---- ranges ----
    @property
    def cur_range(self) -> int:
        return self.cur_end - self.cur_begin

    @property
    def ext_range(self) -> int:
        return self.ext_end - self.ext_begin

    @property
    def min_range(self) -> int:
        return min(self.cur_range, self.ext_range)

    def left_shift(self) -> int:
        return self.cur_begin - self.ext_begin

    def right_shift(self) -> int:
        return (self.ext_len - self.ext_end) - (self.cur_len - self.cur_end)

    def lr_overhang(self) -> int:
        return max(min(self.cur_begin, self.ext_begin),
                   min(self.cur_len - self.cur_end,
                       self.ext_len - self.ext_end))

    # ---- transforms ----
    def reverse(self) -> "Overlap":
        """Swap cur and ext roles (reference: overlap.h:95-116)."""
        km = None
        if self.kmer_matches is not None:
            km = self.kmer_matches[:, ::-1]
            km = km[np.argsort(km[:, 0], kind="stable")]
        return Overlap(self.ext_id, self.cur_id,
                       self.ext_begin, self.ext_end, self.ext_len,
                       self.cur_begin, self.cur_end, self.cur_len,
                       self.score, self.divergence, km)

    def complement(self) -> "Overlap":
        """The same overlap seen from the opposite strands
        (reference: overlap.h:118-147)."""
        km = None
        if self.kmer_matches is not None:
            km = np.stack([self.cur_len - self.kmer_matches[::-1, 0] - 1,
                           self.ext_len - self.kmer_matches[::-1, 1] - 1],
                          axis=1)
        return Overlap(SeqId(self.cur_id).rc, SeqId(self.ext_id).rc,
                       self.cur_len - self.cur_end - 1,
                       self.cur_len - self.cur_begin - 1,
                       self.cur_len,
                       self.ext_len - self.ext_end - 1,
                       self.ext_len - self.ext_begin - 1,
                       self.ext_len,
                       self.score, self.divergence, km)

    def project(self, cur_pos: int) -> int:
        """Map a cur coordinate into ext coordinates, by linear
        interpolation or through the k-mer match trace
        (reference: overlap.h:149-183)."""
        if cur_pos <= self.cur_begin:
            return self.ext_begin
        if cur_pos >= self.cur_end:
            return self.ext_end
        if self.kmer_matches is None:
            ratio = self.ext_range / max(1, self.cur_range)
            p = self.ext_begin + int((cur_pos - self.cur_begin) * ratio)
            return max(self.ext_begin, min(p, self.ext_end))
        km = self.kmer_matches
        i = int(np.searchsorted(km[:, 0], cur_pos))
        if i == 0 or i >= len(km):
            raise ValueError("overlap projection out of range")
        c0, e0 = km[i - 1]
        c1, e1 = km[i]
        ratio = (e1 - e0) / max(1, c1 - c0)
        p = int(e0) + int((cur_pos - c0) * ratio)
        return max(int(e0), min(p, int(e1)))

    # ---- predicates ----
    def contains_point(self, cur_pos: int, ext_pos: int) -> bool:
        return (self.cur_begin <= cur_pos <= self.cur_end and
                self.ext_begin <= ext_pos <= self.ext_end)

    def contained_by(self, other: "Overlap") -> bool:
        if self.cur_id != other.cur_id or self.ext_id != other.ext_id:
            return False
        return (other.cur_begin <= self.cur_begin and
                self.cur_end <= other.cur_end and
                other.ext_begin <= self.ext_begin and
                self.ext_end <= other.ext_end)

    def cur_intersect(self, other: "Overlap") -> int:
        return (min(self.cur_end, other.cur_end) -
                max(self.cur_begin, other.cur_begin))

    def ext_intersect(self, other: "Overlap") -> int:
        return (min(self.ext_end, other.ext_end) -
                max(self.ext_begin, other.ext_begin))

    # ---- text serialization (reference-compatible dump format,
    # reference: overlap.h:227-251) ----
    def dump(self, cur_name: str, ext_name: str) -> str:
        return (f"{cur_name} {self.cur_begin} {self.cur_end} {self.cur_len} "
                f"{ext_name} {self.ext_begin} {self.ext_end} {self.ext_len} "
                f"-1 -1 {self.score} {self.divergence}")

    @classmethod
    def parse(cls, line: str, cur_id: int, ext_id: int) -> "Overlap":
        t = line.split()
        return cls(cur_id, ext_id,
                   int(t[1]), int(t[2]), int(t[3]),
                   int(t[5]), int(t[6]), int(t[7]),
                   score=int(t[10]), divergence=float(t[11]))
