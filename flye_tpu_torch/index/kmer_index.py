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

Port of `flye_tpu/index/kmer_index.py`, single-device paths only: the
w > 1 minimizer selection runs `ops.kmers.stream_select_packed` on the
runtime's device; the w = 1 extraction, counting, selection, sorting and
probing run in the native C++ helpers on the host, as in the JAX
package's single-device path. The repeat-kmer cutoff (repeat_kmer_rate x mean frequency,
reference: vertex_index.cpp:173-212 filterFrequentKmers) drops postings
of repetitive k-mers but keeps them queryable via `is_repetitive`.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flye_tpu_torch.io.seqstore import SequenceStore

logger = logging.getLogger("flye_tpu_torch")

class KmerIndex:
    """Posting-list index over a SequenceStore."""

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
        lens = np.asarray([self.store.length(s) for s in ids],
                          dtype=np.int64)
        starts = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        stream = np.concatenate([self.store.get(s) for s in ids])

        W = self._STREAM_W
        step = W - (k - 1) - 2 * (w - 1)
        n_rows = max(1, -(-max(0, n_total - k + 1) // step))
        # left pad w-1 (row margins), right pad to the row grid
        pad_stream = np.zeros((w - 1) + n_rows * step + (W - step),
                              dtype=np.uint8)
        pad_stream[w - 1:w - 1 + n_total] = stream

        # starts table padded to a power of two (stable device shape)
        Sp = 1 << max(6, (len(starts) - 1).bit_length())
        starts_p = np.full(Sp, n_total, dtype=np.int64)
        starts_p[:len(starts)] = starts

        if w == 1:
            # single-device w=1 extraction runs on the host: the device
            # pass is latency/transfer-bound here (same trade as
            # probe_stream_host), and the native rolling extraction is
            # byte-identical (tests/test_index.py builds go through it)
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
        starts_dev = rt.shard_rows(starts_p)
        kmers_l, seq_l, pos_l, flip_l = [], [], [], []
        strided = np.lib.stride_tricks.as_strided(
            pad_stream, shape=(n_rows, W), strides=(step, 1))
        for r0, nr in self._stream_row_batches(n_rows):
            rows = strided[r0:r0 + nr]
            nb = len(rows)
            if nb < nr:
                chunk = np.zeros((nr, W), dtype=np.uint8)
                chunk[:nb] = rows
            else:
                chunk = np.ascontiguousarray(rows)
            packed = stream_select_packed(
                rt.shard_rows(chunk), starts_dev, r0, n_total,
                k=k, w=w, sample=sample, step=step)
            rsel_t, cols_t = torch.nonzero(packed & 1, as_tuple=True)
            # int64 bit patterns of uint64 words: canon < 2^62 keeps
            # them non-negative, so the host shifts below are exact
            p = packed[rsel_t, cols_t].cpu().numpy()
            rsel, cols = rsel_t.cpu().numpy(), cols_t.cpu().numpy()
            g = (r0 + rsel.astype(np.int64)) * step + cols - (w - 1)
            rid = np.searchsorted(starts, g, side="right") - 1
            kmers_l.append((p >> 2).astype(np.int64))
            seq_l.append(np.asarray([s >> 1 for s in ids],
                                    dtype=np.int32)[rid])
            pos_l.append((g - starts[rid]).astype(np.int32))
            flip_l.append((p >> 1) & 1 == 0)
        return (np.concatenate(kmers_l), np.concatenate(seq_l),
                np.concatenate(pos_l), np.concatenate(flip_l))

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
        kmers, seq, pos, flip = idx._extract_selected(ids, w=w, sample=1)
        kmers, seq, pos, flip = cls._sort_triples(kmers, seq, pos, flip)
        idx._finalize(kmers, seq, pos, flip, min_cov, repeat_kmer_rate)
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
                    ids: Optional[Sequence[int]] = None) -> "KmerIndex":
        """Uneven-coverage solid-kmer index: per read, keep the top
        `select_rate` fraction of positions by global canonical-kmer
        frequency (ties extend the cut), drop within-read tandems
        (reference: vertex_index.cpp:25-125, 440-480).

        Counting and selection run on the host (the JAX package's
        default); its device-resident selection is not yet ported."""
        idx = cls(store, k)
        idx.w = 1
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building solid-kmer index (k=%d) over %d seqs",
                    k, len(ids))
        # pass A: global canonical-kmer counts (sampled)
        kmers, seq, pos, flip = idx._solid_select_host(
            ids, select_rate, tandem_freq, global_min_freq, sample)
        if len(kmers) == 0:
            idx._finalize(kmers, seq, pos, flip, global_min_freq,
                          repeat_kmer_rate)
            return idx
        kmers, seq, pos, flip = cls._sort_triples(kmers, seq, pos, flip)
        idx._finalize(kmers, seq, pos, flip, global_min_freq,
                      repeat_kmer_rate)
        total_len = sum(store.length(i) for i in ids)
        total_entries = int(idx.counts.sum()) if len(idx.counts) else 1
        idx.sample_rate = total_len / max(1, total_entries)
        return idx

    def _solid_select_host(self, ids, select_rate, tandem_freq,
                           global_min_freq, sample):
        """Host counting + per-read frequency selection for the solid
        index; returns the selected (kmers, seq, pos, flip) triples in
        stream order."""
        kmers, seq, pos, flip = self._extract_selected(ids, w=1,
                                                       sample=sample)
        if len(kmers) == 0:
            return kmers, seq, pos, flip
        from flye_tpu_torch import native
        mod = native.get()
        table_bytes = 1 << (2 * self.k)
        if len(kmers) < 500 * 10**6:
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
            raise NotImplementedError(
                f"no native k-mer counter for {len(kmers)} k-mers at "
                f"k={self.k}")
        return self._select_with_freq(kmers, seq, pos, flip, freq,
                                      select_rate, tandem_freq,
                                      global_min_freq)

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
        index in the threaded native prober (the JAX package's
        single-device default; its device probe is not yet ported).

        Returns (g_hit, row_hit, fwd_hit, g_rep, starts, n_total):
          g_hit  [H] int64 ascending stream positions with index hits,
          row_hit[H] int64 uniq-row of each hit,
          fwd_hit[H] bool  query-kmer-was-forward flags,
          g_rep  [F] int64 stream positions filtered as repetitive,
          starts [len(sids)+1] int64 per-read stream offsets.
        """
        from flye_tpu_torch import native
        mod = native.get()
        k = self.k
        lens = np.asarray([store.length(s) for s in sids],
                          dtype=np.int64)
        starts = np.zeros(len(sids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        z = np.zeros(0, dtype=np.int64)
        if n_total == 0 or self.num_kmers == 0:
            return z, z, z.astype(bool), z, starts, n_total
        stream = np.ascontiguousarray(
            np.concatenate([store.get(s) for s in sids]),
            dtype=np.uint8)
        lut, shift = self._host_probe_lut()
        g_hit_b, row_b, fwd_b, grep_b = mod.probe_stream(
            stream, starts, len(sids),
            np.ascontiguousarray(self.uniq_kmers, dtype=np.int64),
            np.ascontiguousarray(self.repetitive).view(np.uint8),
            lut, int(k), int(shift))
        return (np.frombuffer(g_hit_b, np.int64),
                np.frombuffer(row_b, np.int64),
                np.frombuffer(fwd_b, np.uint8).astype(bool),
                np.frombuffer(grep_b, np.int64), starts, n_total)

    def get_postings(self, row: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = self.offsets[row], self.offsets[row + 1]
        return self.post_seq[s:e], self.post_pos[s:e], self.post_flip[s:e]
