"""Hash-sharded k-mer index.

Port of `flye_tpu/index/sharded.py`.  Shard s owns the k-mers with
splitmix64(kmer) % n_shards == s, the modulo taken on the uint64 hash.
Each shard is an independent sorted-array partition built like
`KmerIndex`; the mesh builds route every posting to its owning shard
with the posting exchange (`parallel/mesh.posting_exchange_step`)
before the per-shard sort.

The shards concatenate into globally addressable arrays, so the overlap
engine works unchanged: host lookups route to the owning shard's key
range, and the device probe searches a globally sorted view of the
keys and maps its rows back (`_device_tables`, `_remap_rows`).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from flye_tpu_torch.index.kmer_index import KmerIndex
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.ops.kmers import splitmix64
from flye_tpu_torch.utils import trace

logger = logging.getLogger("flye_tpu_torch")


def _pack(seq, pos, flip):
    return ((seq.astype(np.int64) << 33) | (pos.astype(np.int64) << 1)
            | flip.astype(np.int64))


class ShardedKmerIndex(KmerIndex):
    """KmerIndex partitioned by k-mer hash."""

    # the table is partitioned by hash, not globally sorted: probing
    # goes through the device path and its globally sorted view
    host_probe_ok = False

    def __init__(self, store: SequenceStore, k: int, n_shards: int):
        super().__init__(store, k)
        self.n_shards = n_shards
        # key-range starts of each shard in the concatenated uniq array
        self.shard_row_base: Optional[np.ndarray] = None
        self._probe_order: Optional[np.ndarray] = None
        self.n_dropped = 0   # postings the posting exchange dropped

    @staticmethod
    def shard_of(kmers: np.ndarray, n_shards: int) -> np.ndarray:
        """The owning shard of each k-mer: the uint64 hash modulo
        n_shards (the port's hash is its int64 bit pattern)."""
        h = splitmix64(torch.from_numpy(
            np.ascontiguousarray(kmers, dtype=np.int64))).numpy()
        return (h.view(np.uint64) % np.uint64(n_shards)).astype(np.int64)

    def _publish_shards(self, ids, label: str) -> "ShardedKmerIndex":
        """The shard row ranges of the finalized uniq array, and the
        sample rate (indexed bases per kept posting)."""
        n = self.n_shards
        uniq_shard = self.shard_of(np.asarray(self.uniq_kmers), n)
        self.shard_row_base = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(uniq_shard, minlength=n),
                  out=self.shard_row_base[1:])
        total_len = sum(self.store.length(i) for i in ids)
        total_entries = int(self.counts.sum()) if len(self.counts) else 1
        self.sample_rate = total_len / max(1, total_entries)
        logger.debug("%s: %s", label,
                     np.diff(self.shard_row_base).tolist())
        return self

    @classmethod
    def build_minimizers(cls, store: SequenceStore, k: int, w: int,
                         n_shards: int = 4, min_cov: int = 1,
                         repeat_kmer_rate: float = 100,
                         ids: Optional[Sequence[int]] = None
                         ) -> "ShardedKmerIndex":
        """Host shard build: each shard's postings sorted apart (the
        step after the all-to-all on a mesh), then concatenated."""
        idx = cls(store, k, n_shards)
        idx.w = w
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building sharded minimizer index "
                    "(k=%d, w=%d, %d shards) over %d seqs",
                    k, w, n_shards, len(ids))
        kmers, seq, pos, flip = idx._extract_selected(ids, w=w, sample=1)
        shard = cls.shard_of(kmers, n_shards)
        parts = [cls._sort_triples(kmers[m], seq[m], pos[m], flip[m])
                 for m in (shard == s for s in range(n_shards))]
        idx._finalize(*(np.concatenate([p[i] for p in parts])
                        for i in range(4)), min_cov, repeat_kmer_rate)
        return idx._publish_shards(ids, "Shard sizes")

    def _exchange(self, kmers, seq, pos, flip, mesh, cap_slack: float):
        """The postings through the mesh's posting exchange: each
        shard's received postings, sorted, concatenated in shard order
        as (kmers, seq, pos, flip)."""
        from flye_tpu_torch.parallel.mesh import posting_exchange_step
        n_dev = mesh.shape["data"]
        n_per_dev = -(-max(1, len(kmers)) // n_dev)
        cap = int(n_per_dev / n_dev * cap_slack) + 16
        fn, prepare = posting_exchange_step(mesh, n_per_dev, cap)
        sk, sp, n_dropped, n_recv = fn(*prepare(kmers, _pack(seq, pos,
                                                             flip)))
        sk = trace.readback(sk).cpu().numpy()
        sp = trace.readback(sp).cpu().numpy()
        n_recv = trace.readback(n_recv).cpu().numpy()
        self.n_dropped = int(trace.readback(n_dropped).sum())
        if self.n_dropped:
            logger.warning("posting exchange dropped %d postings "
                           "(capacity %d/pair); increase cap_slack",
                           self.n_dropped, cap)
        # per-shard sorted partitions; the padding trails each
        akmers = np.concatenate([sk[d, :int(n_recv[d])]
                                 for d in range(n_dev)])
        apayload = np.concatenate([sp[d, :int(n_recv[d])]
                                   for d in range(n_dev)])
        return (akmers, (apayload >> 33).astype(np.int32),
                ((apayload >> 1) & 0xFFFFFFFF).astype(np.int32),
                (apayload & 1).astype(bool))

    @classmethod
    def build_minimizers_mesh(cls, store: SequenceStore, k: int, w: int,
                              mesh, min_cov: int = 1,
                              repeat_kmer_rate: float = 100,
                              ids: Optional[Sequence[int]] = None,
                              cap_slack: float = 2.0
                              ) -> "ShardedKmerIndex":
        """Mesh build: postings route to their owning shard through the
        posting exchange and each shard sorts its partition (the
        collective replacing the concurrent-map inserts of
        vertex_index.cpp:389-483).  Equal to the host shard build with
        n_shards = the mesh's devices."""
        n_dev = mesh.shape["data"]
        idx = cls(store, k, n_dev)
        idx.w = w
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building mesh-sharded minimizer index "
                    "(k=%d, w=%d, %d devices) over %d seqs",
                    k, w, n_dev, len(ids))
        kmers, seq, pos, flip = idx._extract_selected(ids, w=w, sample=1)
        idx._finalize(*idx._exchange(kmers, seq, pos, flip, mesh,
                                     cap_slack), min_cov, repeat_kmer_rate)
        return idx._publish_shards(ids, "Mesh shard sizes")

    @classmethod
    def build_solid_mesh(cls, store: SequenceStore, k: int, mesh,
                         select_rate: float, tandem_freq: int,
                         global_min_freq: int = 2, sample: int = 1,
                         repeat_kmer_rate: float = 100,
                         ids: Optional[Sequence[int]] = None,
                         cap_slack: float = 2.0) -> "ShardedKmerIndex":
        """Mesh-sharded solid-k-mer (raw-read) build: host counting and
        per-read frequency selection (`_solid_select_host`, the pass
        `build_solid` runs), then the same posting exchange as
        `build_minimizers_mesh` (reference analog:
        vertex_index.cpp:25-125,499-633)."""
        n_dev = mesh.shape["data"]
        idx = cls(store, k, n_dev)
        idx.w = 1
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building mesh-sharded solid-kmer index "
                    "(k=%d, %d devices) over %d seqs", k, n_dev, len(ids))
        kmers, seq, pos, flip = idx._solid_select_host(
            ids, select_rate, tandem_freq, global_min_freq, sample)
        if len(kmers) == 0:
            idx._finalize(kmers, seq, pos, flip, global_min_freq,
                          repeat_kmer_rate)
            return idx
        idx._finalize(*idx._exchange(kmers, seq, pos, flip, mesh,
                                     cap_slack), global_min_freq,
                      repeat_kmer_rate)
        return idx._publish_shards(ids, "Mesh shard sizes")

    def _device_tables(self):
        """The device probe tables over a globally sorted view of the
        keys: uniq_kmers is sorted within each shard's range only, and
        the shards partition the hash space, so the keys are distinct;
        the probe's rows map back through `_probe_order`."""
        if self._tables is None:
            from flye_tpu_torch.parallel.runtime import get_runtime
            U = self.num_kmers
            uniq = np.asarray(self.uniq_kmers)
            order = np.argsort(uniq, kind="stable")
            self._probe_order = order
            Up = 1 << max(10, (U - 1).bit_length())
            up = np.full(Up, np.iinfo(np.int64).max, np.int64)
            up[:U] = uniq[order]
            rp = np.zeros(Up, dtype=bool)
            rp[:U] = self.repetitive[order]
            self._tables = get_runtime().shard_rows(up, rp)
        return self._tables

    def _remap_rows(self, row: np.ndarray) -> np.ndarray:
        order = self._probe_order
        if order is not None and len(order):
            return order[np.clip(row, 0, len(order) - 1)]
        return row

    def probe_batch(self, batch, lens):
        row, hit, rep, fwd = super().probe_batch(batch, lens)
        return self._remap_rows(row), hit, rep, fwd

    def lookup(self, query_kmers: np.ndarray):
        """Route each query to its owning shard's key range."""
        if self.num_kmers == 0:
            z = np.zeros(len(query_kmers), dtype=np.int64)
            return z, z.astype(bool)
        q = np.asarray(query_kmers)
        shard = self.shard_of(q, self.n_shards)
        uniq = np.asarray(self.uniq_kmers)
        row = np.zeros(len(q), dtype=np.int64)
        found = np.zeros(len(q), dtype=bool)
        for s in range(self.n_shards):
            m = shard == s
            if not m.any():
                continue
            lo, hi = self.shard_row_base[s], self.shard_row_base[s + 1]
            local = np.searchsorted(uniq[lo:hi], q[m])
            local = np.clip(local, 0, max(0, hi - lo - 1))
            row[m] = lo + local
            if hi > lo:
                found[m] = uniq[lo + local] == q[m]
        return row, found
