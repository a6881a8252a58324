"""Packed columnar overlap storage.

The all-vs-all overlap cache is the pipeline's dominant host allocation
after the k-mer index: at 50 Mb/30x it held ~10M Python `Overlap`
dataclass objects, each carrying a small int32 anchor ndarray — ~15
bytes of RSS per read-base, mostly CPython object headers plus int32
anchor pairs (the reference stores overlap records in packed C++
structs and never retains anchor traces at all,
reference: src/sequence/overlap.h:60-110).

This module stores each read's forward-overlap list as ONE structured
record array plus a shared int16 delta-encoded anchor arena:

  record (52 B): ids, cur/ext coords, score, divergence, anchor count,
    first anchor pair, arena offset
  anchors: consecutive (cur, ext) anchor deltas as int16 pairs (4 B per
    anchor; anchors ascend and are ~10-100 bases apart, so deltas fit
    int16 except across rare giant gaps, which fall back to a raw int32
    arena flagged by a negative offset)

`Overlap` objects materialize on demand (`get`), complements derived at
materialization — so the resident cost is ~45-50 B/overlap + 4 B/anchor
(~3-4x less than the object cache, and ~10x fewer Python objects), while
every consumer keeps the object API.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from flye_tpu_torch.overlap.structs import Overlap

REC_DT = np.dtype([
    ("cur_id", "i4"), ("ext_id", "i4"),
    ("cb", "i4"), ("ce", "i4"), ("cl", "i4"),
    ("eb", "i4"), ("ee", "i4"), ("el", "i4"),
    ("score", "i4"), ("div", "f4"),
    ("a_n", "i4"), ("first_c", "i4"), ("first_e", "i4"),
    ("a_off", "i8"),
])

_D16_MAX = 32000  # per-component delta magnitude the int16 arena takes


def encode_overlaps(ovlps: List[Overlap]):
    """Flat (recs, d16, raw) arrays for a list of overlaps — the same
    layout PackedOverlaps stores per read, usable standalone for file
    transport (the task-bus mapping partition ships per-target
    alignment lists this way).

    Column-vectorized: the original per-overlap loop with per-field
    structured-array writes cost ~20 µs/overlap, which at the 4.6 Mb
    head-to-head's ~1.4 M ava overlaps was ~30-70 s of the prefetch
    wall (measured regression, round 5)."""
    n = len(ovlps)
    recs = np.zeros(n, REC_DT)
    if n == 0:
        return recs, np.zeros(0, np.int16), np.zeros(0, np.int32)
    recs["cur_id"] = [o.cur_id for o in ovlps]
    recs["ext_id"] = [o.ext_id for o in ovlps]
    recs["cb"] = [o.cur_begin for o in ovlps]
    recs["ce"] = [o.cur_end for o in ovlps]
    recs["cl"] = [o.cur_len for o in ovlps]
    recs["eb"] = [o.ext_begin for o in ovlps]
    recs["ee"] = [o.ext_end for o in ovlps]
    recs["el"] = [o.ext_len for o in ovlps]
    recs["score"] = [o.score for o in ovlps]
    recs["div"] = [o.divergence for o in ovlps]

    kms = [o.kmer_matches for o in ovlps]
    a_n = np.asarray([0 if km is None else len(km) for km in kms],
                     np.int64)
    recs["a_n"] = a_n
    with_a = np.flatnonzero(a_n > 0)
    if len(with_a) == 0:
        return recs, np.zeros(0, np.int16), np.zeros(0, np.int32)
    recs["first_c"][with_a] = [int(kms[i][0, 0]) for i in with_a]
    recs["first_e"][with_a] = [int(kms[i][0, 1]) for i in with_a]

    # one concatenated anchor stream; per-overlap deltas = adjacent
    # diffs with the rows crossing overlap boundaries masked out
    multi = np.flatnonzero(a_n > 1)
    if len(multi) == 0:
        return recs, np.zeros(0, np.int16), np.zeros(0, np.int32)
    cat = np.concatenate([np.asarray(kms[i], np.int64)
                          for i in multi], axis=0)
    lens = a_n[multi]
    ends = np.cumsum(lens)
    starts = ends - lens
    d_all = cat[1:] - cat[:-1]                  # (T-1, 2)
    # delta row j belongs to overlap g iff j, j+1 both inside g:
    # valid rows are everything except indices ends[:-1]-? — row j is a
    # boundary crossing iff j+1 is a segment start, i.e. j in ends[:-1]
    valid = np.ones(len(d_all), bool)
    valid[ends[:-1] - 1] = False
    d_seg = d_all[valid]                        # per-overlap deltas
    dlens = lens - 1
    dends = np.cumsum(dlens)
    dstarts = dends - dlens
    # per-overlap max |delta| (reduceat over the packed delta rows)
    absmax = np.maximum.reduceat(
        np.abs(d_seg).max(axis=1), dstarts)
    small = absmax <= _D16_MAX

    # int16 arena: deltas of the small overlaps, in order
    take16 = np.zeros(len(d_seg), bool)
    for gi in np.flatnonzero(small):
        take16[dstarts[gi]:dends[gi]] = True
    d16 = d_seg[take16].astype(np.int16).ravel()
    off16 = np.zeros(len(multi), np.int64)
    np.cumsum(dlens * small, out=off16)
    off16 = np.concatenate([[0], off16[:-1]])
    # raw arena: full anchors of the big overlaps
    big = np.flatnonzero(~small)
    if len(big):
        raw = np.concatenate([cat[starts[gi]:ends[gi]]
                              for gi in big]).astype(np.int32).ravel()
        offraw = np.zeros(len(multi), np.int64)
        np.cumsum(lens * ~small, out=offraw)
        offraw = np.concatenate([[0], offraw[:-1]])
    else:
        raw = np.zeros(0, np.int32)
        offraw = np.zeros(len(multi), np.int64)
    a_off = np.where(small, off16, ~offraw)
    recs["a_off"][multi] = a_off
    # single-anchor overlaps: a_off stays 0 (decode reads first_c/e)
    return recs, d16, raw


def decode_overlaps(recs, d16, raw) -> List[Overlap]:
    """Inverse of encode_overlaps."""
    out: List[Overlap] = []
    for r in recs:
        ov = Overlap(int(r["cur_id"]), int(r["ext_id"]),
                     int(r["cb"]), int(r["ce"]), int(r["cl"]),
                     int(r["eb"]), int(r["ee"]), int(r["el"]),
                     score=int(r["score"]),
                     divergence=float(r["div"]))
        n = int(r["a_n"])
        if n > 0:
            off = int(r["a_off"])
            if off >= 0:
                km = np.empty((n, 2), np.int32)
                km[0, 0] = r["first_c"]
                km[0, 1] = r["first_e"]
                if n > 1:
                    d = d16[off * 2:(off + n - 1) * 2]
                    km[1:] = d.reshape(n - 1, 2)
                    np.cumsum(km, axis=0, out=km)
            else:
                o = ~off
                km = raw[o * 2:(o + n) * 2].reshape(n, 2).copy()
            ov.kmer_matches = km
        out.append(ov)
    return out


class PackedOverlaps:
    """fwd_id -> packed forward-overlap list (complements derived)."""

    def __init__(self) -> None:
        self._recs: Dict[int, np.ndarray] = {}
        self._d16: Dict[int, np.ndarray] = {}
        self._raw: Dict[int, np.ndarray] = {}

    def __contains__(self, fwd_id: int) -> bool:
        return fwd_id in self._recs

    def reads(self) -> Iterable[int]:
        return self._recs.keys()

    def __len__(self) -> int:
        return len(self._recs)

    def n_overlaps(self) -> int:
        return sum(len(r) for r in self._recs.values())

    def nbytes(self) -> int:
        return (sum(r.nbytes for r in self._recs.values())
                + sum(a.nbytes for a in self._d16.values())
                + sum(a.nbytes for a in self._raw.values()))

    # ---- encode ----
    def add(self, fwd_id: int, ovlps: List[Overlap]) -> None:
        recs, d16, raw = encode_overlaps(ovlps)
        self._recs[fwd_id] = recs
        self._d16[fwd_id] = d16
        if len(raw):
            self._raw[fwd_id] = raw

    def pop(self, fwd_id: int) -> None:
        self._recs.pop(fwd_id, None)
        self._d16.pop(fwd_id, None)
        self._raw.pop(fwd_id, None)

    # ---- decode ----
    def get(self, fwd_id: int) -> List[Overlap]:
        return decode_overlaps(self._recs[fwd_id],
                               self._d16.get(fwd_id),
                               self._raw.get(fwd_id))
