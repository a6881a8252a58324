"""K-mer / minimizer posting-list index.

Replaces the reference's VertexIndex + KmerCounter
(reference: src/sequence/vertex_index.{h,cpp}) — a concurrent cuckoo map
of k-mer -> packed posting arrays — with sorted device arrays:

    uniq_kmers [U] sorted int64   (searchsorted lookup, log2 U gathers)
    offsets    [U+1] int32        (posting-list extents)
    post_seq / post_pos / post_flip [P]   (the postings)

Both reference build modes are provided:
- minimizers (reference: vertex_index.cpp:389-483 buildIndexMinimizers)
- per-read top-frequency solid k-mers for uneven coverage / raw reads
  (reference: vertex_index.cpp:25-125 buildIndexUnevenCoverage,
  yieldFrequentKmers vertex_index.cpp:440-480)

Only forward strands are indexed; a posting carries a `flip` flag when
the canonical k-mer is the reverse-complement of the forward-strand
k-mer, letting lookups synthesize reverse-strand matches exactly like
the reference's KmerPosIterator (reference: src/sequence/vertex_index.h:158-174).

Port of `flye_tpu/index/kmer_index.py` (the hash-sharded subclass is
`index/sharded.py`): the w > 1 minimizer selection runs
`ops.kmers.stream_select_packed` on the runtime's device, its row
batches split over an active mesh as the device selection's and the
device probe's are (`ParallelContext.map_rows`); by default the w = 1
extraction, counting, selection, sorting and probing run in the native
C++ helpers on the host, as in the JAX package's single-device path.  The device solid-k-mer selection
(`build_solid(device_select=True)`, or FLYE_TPU_DEVICE_COUNT=1) and the
device probe (`probe_stream_flat`, `probe_batch`, `lookup`) run on the
runtime's device and give the same index and hits.  The repeat-kmer cutoff (repeat_kmer_rate x mean frequency,
reference: vertex_index.cpp:173-212 filterFrequentKmers) drops postings
of repetitive k-mers but keeps them queryable via `is_repetitive`.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.ops.kmers import canonical_kmers, probe_words
from flye_tpu_torch.utils import trace

logger = logging.getLogger("flye_tpu_torch")

# streams shorter than this count on the native radix counter; longer
# ones on the flat 4^k table where k allows, else by a numpy argsort
# (the JAX package's 500 M cut)
RADIX_COUNT_MAX = 500 * 10**6


def _context_broken(e: Exception) -> bool:
    """Whether `e` is a CUDA error that leaves the context unusable (an
    illegal address, a failed launch, a device-side assert): torch
    reports these as "CUDA error: ..." and every later device call fails
    with them.  Running out of memory does not."""
    msg = str(e)
    return "CUDA error" in msg and "out of memory" not in msg


def _lookup_device(uniq, q, rmax):
    """Row of each query k-mer in the sorted table (clamped to rmax) and
    whether the k-mer is there."""
    row = torch.searchsorted(uniq, q).clamp_(0, rmax)
    return row, uniq[row] == q


def _probe_device(batch, lens, uniq, repet, rmax, k, narrow):
    """Fused canonicalize + index probe for a padded query batch: one
    packed word per position (`ops.kmers.probe_words`)."""
    canon, is_fwd, valid = canonical_kmers(batch, lens, k)
    return probe_words(canon, is_fwd, valid, uniq, repet, rmax, narrow)


class KmerIndex:
    """Posting-list index over a SequenceStore."""

    # single-device probing may run on the host (native probe_stream);
    # an index whose table is partitioned across devices (the JAX
    # package's ShardedKmerIndex) sets this False and keeps the device
    # path
    host_probe_ok = True

    def __init__(self, store: SequenceStore, k: int):
        self.store = store
        self.k = k
        self.uniq_kmers: np.ndarray = None  # [U] int64 sorted (host)
        self.offsets: np.ndarray = None    # [U+1] int64 (host)
        self.counts: np.ndarray = None     # [U] int32 (host, post-filter)
        self.post_seq: np.ndarray = None   # [P] int32 seq index
        self.post_pos: np.ndarray = None   # [P] int32 pos on indexed strand
        self.post_flip: np.ndarray = None  # [P] bool canonical==rc of fwd
        self.repetitive: np.ndarray = None  # [U] bool
        self.repetitive_cutoff: float = float("inf")
        self.sample_rate: float = 1.0  # mean bases per indexed position
        self._tables = None  # padded (uniq, repetitive) on the device

    # the fields that define a built index (the JAX KmerIndex's names)
    FIELDS = ("uniq_kmers", "offsets", "counts", "post_seq", "post_pos",
              "post_flip", "repetitive", "repetitive_cutoff",
              "sample_rate")

    @classmethod
    def from_numpy(cls, store: SequenceStore, k: int,
                   fields) -> "KmerIndex":
        """An index from already-built arrays: `fields` maps each name
        of FIELDS to its value (e.g. taken from a JAX package index),
        so two overlap engines can share one index."""
        idx = cls(store, k)
        for name in cls.FIELDS:
            val = fields[name]
            setattr(idx, name, float(val) if name in (
                "repetitive_cutoff", "sample_rate") else np.asarray(val))
        return idx

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    _STREAM_W = 16384       # chunk width of the flat-stream layout
    _STREAM_ROWS = 512      # device rows per large stream batch
    _STREAM_ROWS_SMALL = 64  # device rows per small stream batch

    @classmethod
    def _stream_row_batches(cls, n_rows: int):
        """Yield (r0, fixed_rows) batches covering n_rows: 512-row
        batches for bulk, 64-row batches for tails/small streams (the
        JAX package's two compiled shapes)."""
        R, S = cls._STREAM_ROWS, cls._STREAM_ROWS_SMALL
        r0 = 0
        while n_rows - r0 > 4 * S:
            yield r0, R
            r0 += min(R, n_rows - r0)
        while r0 < n_rows:
            yield r0, S
            r0 += min(S, n_rows - r0)

    @staticmethod
    def _read_stream(store, ids):
        """(starts [len(ids)+1] int64 read offsets, n_total, the reads
        concatenated) of the flat-stream layout."""
        lens = np.asarray([store.length(s) for s in ids], dtype=np.int64)
        starts = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        stream = (np.concatenate([store.get(s) for s in ids]) if ids
                  else np.zeros(0, dtype=np.uint8))
        return starts, n_total, stream

    @staticmethod
    def _padded_starts(starts, n_total):
        """starts padded with n_total to a power of two (>= 64)."""
        Sp = 1 << max(6, (len(starts) - 1).bit_length())
        starts_p = np.full(Sp, n_total, dtype=np.int64)
        starts_p[:len(starts)] = starts
        return starts_p

    def _stream_chunks(self, stream, n_total, w):
        """Yield (r0, chunk) over the stream cut into overlapping rows of
        _STREAM_W bases: row r holds stream positions r*step - (w-1) + col,
        step = W - (k-1) - 2*(w-1); chunk is a [512 or 64, W] uint8 host
        batch (_stream_row_batches), zero-padded past the last row."""
        k, W = self.k, self._STREAM_W
        step = W - (k - 1) - 2 * (w - 1)
        n_rows = max(1, -(-max(0, n_total - k + 1) // step))
        # left pad w-1 (row margins), right pad to the row grid
        pad_stream = np.zeros((w - 1) + n_rows * step + (W - step),
                              dtype=np.uint8)
        pad_stream[w - 1:w - 1 + n_total] = stream
        strided = np.lib.stride_tricks.as_strided(
            pad_stream, shape=(n_rows, W), strides=(step, 1))
        for r0, nr in self._stream_row_batches(n_rows):
            rows = strided[r0:r0 + nr]
            if len(rows) < nr:
                chunk = np.zeros((nr, W), dtype=np.uint8)
                chunk[:len(rows)] = rows
            else:
                chunk = np.ascontiguousarray(rows)
            yield r0, chunk

    def _extract_selected(self, ids, w: int, sample: int):
        """Run the fused selection over the flat read stream (on the
        runtime's device) and compact to triple arrays (canon kmer, seq
        index, pos, flip).

        All reads concatenate into one base stream cut into fixed-width
        overlapping chunks (transferred bytes ~= true base count); the
        selection packs (kmer, strand, selected) into one word per
        position and only the selected positions come back."""
        from flye_tpu_torch.ops.kmers import stream_select_packed

        k = self.k
        ids = list(ids)
        if not ids:
            z = np.zeros(0, dtype=np.int64)
            return z, z.astype(np.int32), z.astype(np.int32), z.astype(bool)
        starts, n_total, stream = self._read_stream(self.store, ids)

        if w == 1:
            # single-device w=1 extraction runs on the host (the JAX
            # package's default; `_solid_select_device` is the device
            # path), and the native rolling extraction is byte-identical
            from flye_tpu_torch import native
            mod = native.get()
            kb, rb, pb, fb = mod.extract_kmers(
                np.ascontiguousarray(stream, dtype=np.uint8),
                starts, len(ids), int(k), int(sample))
            rid = np.frombuffer(rb, np.int32)
            seq = np.asarray([s >> 1 for s in ids],
                             dtype=np.int32)[rid]
            return (np.frombuffer(kb, np.int64), seq,
                    np.frombuffer(pb, np.int32),
                    np.frombuffer(fb, np.uint8).astype(bool))

        from flye_tpu_torch.parallel.runtime import get_runtime
        rt = get_runtime()
        step = self._STREAM_W - (k - 1) - 2 * (w - 1)
        starts_dev = rt.shard_rows(self._padded_starts(starts, n_total))
        kmers_l, seq_l, pos_l, flip_l = [], [], [], []
        for r0, chunk in self._stream_chunks(stream, n_total, w):
            # the chunk's rows over the mesh (whole when inactive)
            packed = rt.map_rows(
                lambda lo, c: stream_select_packed(
                    c, starts_dev.to(c.device), r0 + lo, n_total, k=k, w=w,
                    sample=sample, step=step), chunk)
            rsel_t, cols_t = torch.nonzero(packed & 1, as_tuple=True)
            # int64 bit patterns of uint64 words (canon << 2 | flags):
            # at k = 31 a canon of 2^61 or more sets the sign bit, so
            # the k-mer comes out by a logical shift of the uint64 view
            p = trace.readback(packed[rsel_t, cols_t]).cpu().numpy()
            rsel = trace.readback(rsel_t).cpu().numpy()
            cols = trace.readback(cols_t).cpu().numpy()
            g = (r0 + rsel.astype(np.int64)) * step + cols - (w - 1)
            rid = np.searchsorted(starts, g, side="right") - 1
            kmers_l.append((p.view(np.uint64) >> np.uint64(2))
                           .astype(np.int64))
            seq_l.append(np.asarray([s >> 1 for s in ids],
                                    dtype=np.int32)[rid])
            pos_l.append((g - starts[rid]).astype(np.int32))
            flip_l.append((p >> 1) & 1 == 0)
        return (np.concatenate(kmers_l), np.concatenate(seq_l),
                np.concatenate(pos_l), np.concatenate(flip_l))

    @staticmethod
    def _p90_ranks(lens, k, sample, n_pad):
        """Per read, the rank of its p90 frequency (nearest rank) among
        the (read, freq)-sorted valid positions of the stream, zero-padded
        to n_pad: the selection keeps every sample-th position of a
        read, so the valid counts follow from the read lengths."""
        n_valid = np.where(lens >= k, -(-(lens - k + 1) // sample), 0)
        prefix = np.concatenate([[0], np.cumsum(n_valid)])
        idx90 = np.zeros(n_pad, dtype=np.int64)
        idx90[:len(lens)] = prefix[:-1] + np.minimum(
            np.maximum(n_valid - 1, 0), (0.9 * n_valid).astype(np.int64))
        return idx90

    def _solid_select_device(self, ids, select_rate: float,
                             tandem_freq: int, global_min_freq: int,
                             sample: int):
        """Device pass A of build_solid: the w = 1 selection words stay
        on the runtime's device, counting, the per-read threshold and
        the tandem filter run there (`ops.kmers.solid_select_device`),
        and only the selected postings come back.  Returns the selected
        (kmers, seq, pos, flip) in stream order, as
        `_solid_select_host`."""
        from flye_tpu_torch.ops.kmers import (solid_select_device,
                                              stream_select_packed)
        from flye_tpu_torch.parallel.runtime import get_runtime
        k, W = self.k, self._STREAM_W
        ids = list(ids)
        starts, n_total, stream = self._read_stream(self.store, ids)
        if n_total == 0:
            z = np.zeros(0, dtype=np.int64)
            return (z, z.astype(np.int32), z.astype(np.int32),
                    z.astype(bool))
        step = W - (k - 1)
        starts_p = self._padded_starts(starts, n_total)
        rt = get_runtime()
        starts_dev = rt.shard_rows(starts_p)
        # the row batches are consecutive (only the last is padded), so
        # row i of the whole buffer is stream row i
        batches = list(self._stream_chunks(stream, n_total, 1))
        packed = torch.empty(sum(len(c) for _, c in batches) * W,
                             dtype=torch.int64, device=rt.device)
        off = 0
        for r0, chunk in batches:
            packed[off:off + chunk.size] = rt.map_rows(
                lambda lo, c: stream_select_packed(
                    c, starts_dev.to(c.device), r0 + lo, n_total, k=k,
                    w=1, sample=sample, step=step), chunk).view(-1)
            off += chunk.size
        del batches

        idx90 = self._p90_ranks(np.diff(starts), k, sample, len(starts_p))
        pk, pg, _ = solid_select_device(
            packed, starts_dev, rt.shard_rows(idx90), select_rate, k=k,
            W=W, step=step, tandem_freq=tandem_freq,
            global_min=global_min_freq)
        del packed
        pk_h = trace.readback(pk).cpu().numpy()
        pg_h = trace.readback(pg).cpu().numpy()
        rid = np.searchsorted(starts, pg_h, side="right") - 1
        kmers = (pk_h.view(np.uint64) >> np.uint64(2)).astype(np.int64)
        flip = (pk_h >> 1) & 1 == 0
        seq = np.asarray([s >> 1 for s in ids], dtype=np.int32)[rid]
        pos = (pg_h - starts[rid]).astype(np.int32)
        return kmers, seq, pos, flip

    @staticmethod
    def _sort_triples(kmers, seq, pos, flip):
        """Deterministic sort by (kmer, seq, pos).

        Runs on the host (native radix sort): the triples originate
        host-side and the sorted postings are consumed host-side."""
        # payload layout: seq(30) | pos(32) | flip(1) in 63 bits — bit
        # 63 must stay clear because the native radix orders payloads
        # unsigned
        if len(seq) and int(seq.max()) >= (1 << 30):
            raise ValueError("k-mer payload packing supports < 2^30 "
                             "sequence ids")
        payload = ((seq.astype(np.int64) << 33)
                   | (pos.astype(np.int64) << 1)
                   | flip.astype(np.int64))
        from flye_tpu_torch import native
        mod = native.get()
        # threaded native radix, stable on the (kmer, payload) key
        abits = (int(kmers.max()).bit_length()
                 if len(kmers) else 1) or 1
        sk_b, sp_b = mod.radix_sort_pairs(
            np.ascontiguousarray(kmers, np.int64),
            np.ascontiguousarray(payload, np.int64), abits)
        sk = np.frombuffer(sk_b, np.int64)
        sp = np.frombuffer(sp_b, np.int64)
        return (sk, (sp >> 33).astype(np.int32),
                ((sp >> 1) & 0xFFFFFFFF).astype(np.int32),
                (sp & 1).astype(bool))

    def _finalize(self, kmers, seq, pos, flip, min_cov: int,
                  repeat_kmer_rate: float, drop_mask: Optional[np.ndarray] = None,
                  mean_freq_override: Optional[float] = None):
        """Group sorted triples, apply the repetitive-kmer filter, and
        publish the index arrays.

        mean_freq_override supplies the GLOBAL mean k-mer frequency
        when this index holds only one hash-shard partition (the
        multi-process partitioned build, parallel/partitioned.py):
        the repetitive cutoff is rate x global mean, which a partition
        cannot compute from its own counts alone."""
        if drop_mask is not None and drop_mask.any():
            keep = ~drop_mask
            kmers, seq, pos, flip = kmers[keep], seq[keep], pos[keep], flip[keep]
        n = len(kmers)
        self._tables = None
        if n == 0:
            self.uniq_kmers = np.zeros(0, dtype=np.int64)
            self.offsets = np.zeros(1, dtype=np.int64)
            self.counts = np.zeros(0, dtype=np.int32)
            self.post_seq = seq
            self.post_pos = pos
            self.post_flip = flip
            self.repetitive = np.zeros(0, dtype=bool)
            return
        starts = np.flatnonzero(np.concatenate([[True], kmers[1:] != kmers[:-1]]))
        uniq = kmers[starts]
        counts = np.diff(np.concatenate([starts, [n]])).astype(np.int64)

        # repetitive cutoff: rate x mean frequency over kmers with
        # count >= min_cov (reference: vertex_index.cpp:173-190)
        eligible = counts >= min_cov
        total = int(counts[eligible].sum())
        uniq_n = int(eligible.sum())
        mean_freq = (mean_freq_override if mean_freq_override is not None
                     else total / (uniq_n + 1))
        self.repetitive_cutoff = repeat_kmer_rate * mean_freq
        repetitive = counts > self.repetitive_cutoff
        n_rep = int(counts[repetitive].sum())
        logger.debug("Mean k-mer frequency: %.2f", mean_freq)
        logger.debug("Repetitive k-mer frequency cutoff: %.1f",
                     self.repetitive_cutoff)
        logger.debug("Filtered %d repetitive k-mer postings (%.4f)",
                     n_rep, n_rep / max(1, total))

        # drop postings of repetitive kmers, keep the uniq row (count 0)
        if repetitive.any():
            keep_post = np.ones(n, dtype=bool)
            for s, c in zip(starts[repetitive],
                            counts[repetitive]):
                keep_post[s:s + c] = False
            seq, pos, flip = seq[keep_post], pos[keep_post], flip[keep_post]
            counts = np.where(repetitive, 0, counts)

        self.uniq_kmers = np.ascontiguousarray(uniq)
        self.offsets = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self.counts = counts.astype(np.int32)
        self.post_seq = seq
        self.post_pos = pos
        self.post_flip = flip
        self.repetitive = repetitive
        total_entries = int(counts.sum())
        logger.debug("Selected k-mers: %d", len(uniq))
        logger.debug("K-mer index size: %d", total_entries)
        logger.debug("Mean k-mer index frequency: %.2f",
                     total_entries / max(1, len(uniq)))

    @classmethod
    def build_minimizers(cls, store: SequenceStore, k: int, w: int,
                         min_cov: int = 1, repeat_kmer_rate: float = 100,
                         ids: Optional[Sequence[int]] = None) -> "KmerIndex":
        """Minimizer index (reference: vertex_index.cpp:389-483)."""
        idx = cls(store, k)
        idx.w = w
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building minimizer index (k=%d, w=%d) over %d seqs",
                    k, w, len(ids))
        with trace.span("index: extract"):
            kmers, seq, pos, flip = idx._extract_selected(ids, w=w,
                                                          sample=1)
        with trace.span("index: sort"):
            kmers, seq, pos, flip = cls._sort_triples(kmers, seq, pos,
                                                      flip)
        with trace.span("index: finalize"):
            idx._finalize(kmers, seq, pos, flip, min_cov,
                          repeat_kmer_rate)
        total_len = sum(store.length(i) for i in ids)
        total_entries = int(idx.counts.sum()) if len(idx.counts) else 1
        idx.sample_rate = total_len / max(1, total_entries)
        logger.debug("Minimizer rate: %.2f", idx.sample_rate)
        return idx

    @classmethod
    def build_solid(cls, store: SequenceStore, k: int,
                    select_rate: float, tandem_freq: int,
                    global_min_freq: int = 2, sample: int = 1,
                    repeat_kmer_rate: float = 100,
                    ids: Optional[Sequence[int]] = None,
                    device_select: Optional[bool] = None) -> "KmerIndex":
        """Uneven-coverage solid-kmer index: per read, keep the top
        `select_rate` fraction of positions by global canonical-kmer
        frequency (ties extend the cut), drop within-read tandems
        (reference: vertex_index.cpp:25-125, 440-480).

        device_select: count and select on the runtime's device
        (`_solid_select_device`) instead of the host; None reads
        FLYE_TPU_DEVICE_COUNT=1, and the default is the host, as in the
        JAX package.  Both give the same index.  As in the JAX package,
        a failure of the device selection (e.g. the card's memory at a
        large read set) is logged and the index is counted on the host;
        a CUDA error that leaves the context broken (an illegal address,
        a failed launch) is raised instead, since every later device
        call would fail with it."""
        import os
        idx = cls(store, k)
        idx.w = 1
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building solid-kmer index (k=%d) over %d seqs",
                    k, len(ids))
        if device_select is None:
            device_select = os.environ.get(
                "FLYE_TPU_DEVICE_COUNT", "") == "1"
        if device_select:
            try:
                kmers, seq, pos, flip = idx._solid_select_device(
                    ids, select_rate, tandem_freq, global_min_freq,
                    sample)
                return idx._finish_solid(kmers, seq, pos, flip,
                                         global_min_freq,
                                         repeat_kmer_rate, ids)
            except Exception as e:
                if _context_broken(e):
                    raise
                logger.warning("device solid-kmer selection failed "
                               "(%s); falling back to host counting", e)
        # pass A: global canonical-kmer counts (sampled) and selection
        kmers, seq, pos, flip = idx._solid_select_host(
            ids, select_rate, tandem_freq, global_min_freq, sample)
        if len(kmers) == 0:
            # the JAX package's host path keeps sample_rate 1.0 here
            idx._finalize(kmers, seq, pos, flip, global_min_freq,
                          repeat_kmer_rate)
            return idx
        return idx._finish_solid(kmers, seq, pos, flip, global_min_freq,
                                 repeat_kmer_rate, ids)

    def _finish_solid(self, kmers, seq, pos, flip, global_min_freq,
                      repeat_kmer_rate, ids) -> "KmerIndex":
        """Sort and finalize the selected postings; the sample rate is
        the indexed bases per kept posting."""
        with trace.span("index: sort"):
            kmers, seq, pos, flip = self._sort_triples(kmers, seq, pos,
                                                       flip)
        with trace.span("index: finalize"):
            self._finalize(kmers, seq, pos, flip, global_min_freq,
                           repeat_kmer_rate)
        total_len = sum(self.store.length(i) for i in ids)
        total_entries = int(self.counts.sum()) if len(self.counts) else 1
        self.sample_rate = total_len / max(1, total_entries)
        return self

    def _solid_select_host(self, ids, select_rate, tandem_freq,
                           global_min_freq, sample):
        """Host counting + per-read frequency selection for the solid
        index; returns the selected (kmers, seq, pos, flip) triples in
        stream order."""
        with trace.span("index: extract"):
            kmers, seq, pos, flip = self._extract_selected(ids, w=1,
                                                           sample=sample)
        if len(kmers) == 0:
            return kmers, seq, pos, flip
        with trace.span("index: count"):
            freq = self._count_freqs(kmers)
        with trace.span("index: select"):
            return self._select_with_freq(kmers, seq, pos, flip, freq,
                                          select_rate, tandem_freq,
                                          global_min_freq)

    def _count_freqs(self, kmers: np.ndarray) -> np.ndarray:
        """Each stream position's global canonical-kmer frequency."""
        from flye_tpu_torch import native
        mod = native.get()
        table_bytes = 1 << (2 * self.k)
        if len(kmers) < RADIX_COUNT_MAX:
            # threaded radix-sort exact counting — linear time, ~28
            # bytes/key workspace; beats the numpy argsort at every
            # size (measured 10 M keys: 0.2 s vs 4.0 s) and the flat
            # 4^k table below ~500 M keys (its ~8-17 GB first touch);
            # above that the flat counter's fixed table wins on memory
            # int32 throughout: the int64 frequency copies were part
            # of the 50 Mb run's 78 Gb index-build peak
            freq = np.frombuffer(
                mod.count_kmer_freqs_radix(
                    np.ascontiguousarray(kmers, dtype=np.int64),
                    int(self.k)),
                np.int32)
        elif 2 * self.k <= 34 and (len(kmers) >= 150 * 10**6
                                   or table_bytes <= (1 << 28)):
            # flat saturating-counter pass (native; the reference's
            # KmerCounter design, vertex_index.cpp:504-557).  uint8
            # saturation at 255 cannot change the selection: the
            # per-read threshold below is clamped to <= 4, so any
            # count >= 4 is equivalent.  Replaces the full argsort of
            # the k-mer stream — 40 min / 87 Gb peak at 1.46 G k-mers
            # on the 50 Mb run — with two linear passes.  Only engaged
            # for large streams (or small tables): below the crossover
            # the 4^k-entry table's first-touch cost loses to the sort
            # (measured at k=17: 10 M kmers flat 105 s vs sort 2.7 s;
            # 100 M flat 89 s vs 43 s; 200 M flat 144 s vs 169 s — the
            # break-even interpolates to ~150 M), and the sort path's
            # ~6x int64 workspace still fits this host comfortably at
            # those sizes.
            freq = np.frombuffer(
                mod.count_kmer_freqs(
                    np.ascontiguousarray(kmers, dtype=np.int64),
                    int(self.k)),
                np.uint8).astype(np.int32)
        else:
            # exact counts by a stable argsort: group sizes, repeated
            # across each group's members and scattered back to stream
            # order through the sort permutation
            order = np.argsort(kmers, kind="stable")
            skmers = kmers[order]
            starts = np.flatnonzero(
                np.concatenate([[True], skmers[1:] != skmers[:-1]]))
            cnt_vals = np.diff(np.concatenate(
                [starts, [len(skmers)]])).astype(np.int64)
            freq = np.empty(len(kmers), dtype=np.int64)
            freq[order] = np.repeat(cnt_vals, cnt_vals)
        return freq

    def _select_with_freq(self, kmers, seq, pos, flip, freq,
                          select_rate, tandem_freq, global_min_freq):
        """Per-read frequency-threshold selection given each stream
        position's GLOBAL frequency.

        Keep positions whose global frequency marks them as genuine
        (error k-mers barely recur).  The reference keeps each read's
        top `select_rate` fraction by frequency rank
        (vertex_index.cpp:440-480); a rank cut drops
        spatially-contiguous low-coverage stretches and truncates
        chains on low-error data, so the threshold form is used
        instead: thr = max(global_min, min(4, select_rate * p90)),
        which adapts to each read's abundance (meta) while never
        gapping an isolate."""
        from flye_tpu_torch import native
        mod = native.get()
        read_starts = np.flatnonzero(
            np.concatenate([[True], seq[1:] != seq[:-1]]))
        # threaded native per-read selection
        bounds = np.concatenate(
            [read_starts, [len(kmers)]]).astype(np.int64)
        sel_mask = np.frombuffer(
            mod.select_solid_kmers(
                np.ascontiguousarray(kmers, dtype=np.int64),
                np.ascontiguousarray(freq, dtype=np.int32),
                np.ascontiguousarray(bounds),
                float(select_rate), int(tandem_freq),
                int(global_min_freq)),
            np.uint8).astype(bool)
        return (kmers[sel_mask], seq[sel_mask], pos[sel_mask],
                flip[sel_mask])

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    @property
    def num_kmers(self) -> int:
        return len(self.counts) if self.counts is not None else 0

    @property
    def index_size(self) -> int:
        return len(self.post_seq) if self.post_seq is not None else 0

    def _device_tables(self):
        """(uniq_kmers, repetitive) on the runtime's device, padded to a
        power of two (>= 1024) with max-int64 / False tails, built once
        per index."""
        if self._tables is None:
            from flye_tpu_torch.parallel.runtime import get_runtime
            U = self.num_kmers
            Up = 1 << max(10, (U - 1).bit_length())
            up = np.full(Up, np.iinfo(np.int64).max, np.int64)
            up[:U] = self.uniq_kmers
            rp = np.zeros(Up, dtype=bool)
            rp[:U] = self.repetitive
            self._tables = get_runtime().shard_rows(up, rp)
        return self._tables

    def lookup(self, query_kmers: np.ndarray):
        """[Q] int64 canonical k-mers -> (row [Q] int64 into the uniq
        arrays, found [Q] bool), on the runtime's device."""
        q = np.ascontiguousarray(query_kmers, dtype=np.int64)
        Q = len(q)
        if Q == 0 or self.num_kmers == 0:
            return np.zeros(Q, dtype=np.int64), np.zeros(Q, dtype=bool)
        up, _ = self._device_tables()
        row, found = _lookup_device(up, torch.from_numpy(q).to(up.device),
                                    self.num_kmers - 1)
        return (trace.readback(row).cpu().numpy(),
                trace.readback(found).cpu().numpy())

    def probe_batch(self, batch, lens):
        """Fused canonicalize + lookup over a padded query batch
        ([rows, pad] uint8 codes, [rows] lengths), on the runtime's
        device.  Returns (row [rows, pad] int64, hit, rep, fwd bool
        arrays) from one packed word per position (_probe_device)."""
        up, rp = self._device_tables()
        narrow = self.num_kmers < (1 << 28)
        b, ln = (torch.from_numpy(np.ascontiguousarray(x)).to(up.device)
                 for x in (batch, lens))
        packed = trace.readback(_probe_device(
            b, ln, up, rp, max(0, self.num_kmers - 1), self.k,
            narrow)).cpu().numpy()
        shift = 28 if narrow else 32
        row = (packed & ((1 << shift) - 1)).astype(np.int64)
        hit = ((packed >> shift) & 1).astype(bool)
        rep = ((packed >> (shift + 1)) & 1).astype(bool)
        fwd = ((packed >> (shift + 2)) & 1).astype(bool)
        return row, hit, rep, fwd

    def _remap_rows(self, row: np.ndarray) -> np.ndarray:
        """Hook for subclasses whose device probe table is a re-sorted
        view of the uniq arrays (the JAX package's ShardedKmerIndex)."""
        return row

    def _host_probe_lut(self):
        """16-bit-prefix lookup table into the sorted uniq array
        (prefix = kmer >> shift); bounds each native probe's binary
        search to a handful of entries."""
        cached = getattr(self, "_probe_lut", None)
        if cached is not None:
            return cached
        bits = min(16, 2 * self.k)
        shift = 2 * self.k - bits
        bounds = np.arange((1 << bits) + 1, dtype=np.int64) << shift
        lut = np.searchsorted(np.asarray(self.uniq_kmers), bounds) \
            .astype(np.int64)
        self._probe_lut = (np.ascontiguousarray(lut), shift)
        return self._probe_lut

    def probe_stream_host(self, store, sids):
        """Probe every k-mer of the given query strands against the
        index in the threaded native prober (the single-device default),
        or None when this index must be probed on the device
        (`host_probe_ok` False).

        Returns (g_hit, row_hit, fwd_hit, g_rep, starts, n_total):
          g_hit  [H] int64 ascending stream positions with index hits,
          row_hit[H] int64 uniq-row of each hit,
          fwd_hit[H] bool  query-kmer-was-forward flags,
          g_rep  [F] int64 stream positions filtered as repetitive,
          starts [len(sids)+1] int64 per-read stream offsets.
        """
        if not self.host_probe_ok:
            return None
        from flye_tpu_torch import native
        mod = native.get()
        starts, n_total, stream = self._read_stream(store, sids)
        z = np.zeros(0, dtype=np.int64)
        if n_total == 0 or self.num_kmers == 0:
            return z, z, z.astype(bool), z, starts, n_total
        lut, shift = self._host_probe_lut()
        g_hit_b, row_b, fwd_b, grep_b = mod.probe_stream(
            np.ascontiguousarray(stream, dtype=np.uint8), starts,
            len(sids),
            np.ascontiguousarray(self.uniq_kmers, dtype=np.int64),
            np.ascontiguousarray(self.repetitive).view(np.uint8),
            lut, int(self.k), int(shift))
        return (np.frombuffer(g_hit_b, np.int64),
                np.frombuffer(row_b, np.int64),
                np.frombuffer(fwd_b, np.uint8).astype(bool),
                np.frombuffer(grep_b, np.int64), starts, n_total)

    def probe_stream_flat(self, store, sids):
        """Probe every k-mer of the given query strands on the runtime's
        device (`ops.kmers.stream_probe_packed` over the flat stream,
        512- or 64-row batches); only the positions with a hit or a
        repetitive k-mer come back.  Returns what probe_stream_host
        returns, equal to it."""
        from flye_tpu_torch.ops.kmers import stream_probe_packed
        from flye_tpu_torch.parallel.runtime import get_runtime

        k = self.k
        starts, n_total, stream = self._read_stream(store, sids)
        if n_total == 0 or self.num_kmers == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z.astype(bool), z, starts, n_total
        rt = get_runtime()
        step = self._STREAM_W - (k - 1)
        starts_dev = rt.shard_rows(self._padded_starts(starts, n_total))
        up, rp = self._device_tables()
        narrow = self.num_kmers < (1 << 28)
        shift = 28 if narrow else 32
        g_l, p_l = [], []
        tables = {up.device: (starts_dev, up, rp)}

        def probe(lo, c):
            if c.device not in tables:     # a copy on each mesh device
                tables[c.device] = tuple(t.to(c.device) for t in
                                         tables[up.device])
            s_d, up_d, rp_d = tables[c.device]
            return stream_probe_packed(
                c, s_d, r0 + lo, n_total, up_d, rp_d,
                max(0, self.num_kmers - 1), k=k, step=step, narrow=narrow)
        for r0, chunk in self._stream_chunks(stream, n_total, 1):
            packed = rt.map_rows(probe, chunk)
            rsel, cols = torch.nonzero((packed >> shift) & 3,  # hit | rep
                                       as_tuple=True)
            p_l.append(trace.readback(packed[rsel, cols]).cpu().numpy())
            g_l.append(trace.readback((r0 + rsel) * step + cols)
                       .cpu().numpy())
        p, g = np.concatenate(p_l), np.concatenate(g_l)
        is_hit = ((p >> shift) & 1).astype(bool)
        ph = p[is_hit]
        row_hit = self._remap_rows(
            (ph & ((1 << shift) - 1)).astype(np.int64))
        fwd_hit = ((ph >> (shift + 2)) & 1).astype(bool)
        return g[is_hit], row_hit, fwd_hit, g[~is_hit], starts, n_total

    def kmer_freq(self, query_kmers: np.ndarray) -> np.ndarray:
        row, found = self.lookup(query_kmers)
        return np.where(found, self.counts[row], 0)

    def is_repetitive(self, query_kmers: np.ndarray) -> np.ndarray:
        row, found = self.lookup(query_kmers)
        return found & self.repetitive[row]

    def get_postings(self, row: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = self.offsets[row], self.offsets[row + 1]
        return self.post_seq[s:e], self.post_pos[s:e], self.post_flip[s:e]
