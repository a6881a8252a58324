"""Overlap detection engine: index probe -> chain -> score -> filter.

Port of `flye_tpu/overlap/engine.py` (behavioral port of
OverlapDetector/OverlapContainer, reference: src/sequence/overlap.{h,cpp}):

- index probing runs in the native C++ helpers by default, or on the
  runtime's device under FLYE_TPU_PROBE=device (or `auto`, which times
  both on the first batch and keeps the faster);
- posting expansion, group preparation, small-group chain DP,
  backtracking and overlap tests run in the native C++ helpers;
- groups wider than `host_dp_max` chain on the runtime's device through
  `ops.chain.chain_dp_multi` (the K1 CUDA kernel on a GPU);
- base-level divergence goes through the anchored segment batcher
  (ops.align) instead of edlib.

The JAX package's pure-Python fallback path (used there only when the
native module is missing) is not carried over: the port's native
module is required.

One engine serves every consumer like the reference's constructor flags
(reference: src/sequence/overlap.h:314-335): all-vs-all reads
(only_max_ext), ava-disjointigs with kept alignments + bad-mapping
partitioning (repeat graph), reads->edges and reads->contigs mapping.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flye_tpu_torch.index.kmer_index import KmerIndex
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.ops.align import (ResidentStrands, SegmentBatcher,
                                      anchored_distances,
                                      anchored_divergence)
from flye_tpu_torch.ops.chain import chain_dp_multi
from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.utils.ds import DisjointSet

logger = logging.getLogger("flye_tpu_torch")

# the prefetch thread pipeline may issue device calls from two threads;
# device sections take this lock so one batch's probe or DP runs at a
# time (host prep/finish still overlaps: native C++ sections release the
# GIL)
import threading as _threading
from contextlib import contextmanager as _contextmanager
from time import perf_counter as _pc

from flye_tpu_torch.utils import trace

_DEVICE_LOCK = _threading.Lock()


@_contextmanager
def _device_lock():
    """_DEVICE_LOCK, the wait for it a span of its own."""
    with trace.span("overlap: device wait"):
        _DEVICE_LOCK.acquire()
    try:
        yield
    finally:
        _DEVICE_LOCK.release()


# fraction of min_overlap that must be covered by unique k-mer matches
# for a target to be considered (reference: overlap.cpp:110-111)
_MIN_KMER_SURVIVAL_RATE = 0.01
# match-count buckets for the chaining DP batches
_CHAIN_BUCKETS = (64, 256, 1024, 4096, 16384)
_LOOKBACK = 1024


class OverlapEngine:
    """Finds overlaps of query sequences against an indexed target set."""

    # matches per posting-expansion chunk (memory bound; see
    # _collect_matches_batch)
    gather_cap = 64 << 20

    def __init__(
        self,
        target_store: SequenceStore,
        index: KmerIndex,
        max_jump: int,
        min_overlap: int,
        max_overhang: int,
        keep_alignment: bool = False,
        only_max_ext: bool = False,
        max_divergence: float = 1.0,
        nucl_alignment: bool = False,
        partition_bad_mappings: bool = False,
        use_hpc: bool = False,
        max_cur_overlaps: int = 0,
        thin_anchors: bool = True,
    ):
        self.targets = target_store
        self.index = index
        self.k = index.k
        self.max_jump = max_jump
        self.min_overlap = min_overlap
        self.max_overhang = max_overhang
        self.check_overhang = max_overhang > 0
        self.keep_alignment = keep_alignment
        self.only_max_ext = only_max_ext
        self.max_divergence = max_divergence
        self.nucl_alignment = nucl_alignment
        self.partition_bad_mappings = partition_bad_mappings
        self.use_hpc = use_hpc
        self.max_cur_overlaps = max_cur_overlaps
        # groups with at most this many matches chain on the host
        # (threaded native full-window DP, bit-identical to the device
        # DP's bounded window because host_dp_max <= lookback); wider
        # groups run the device DP.  See _finish_from_matches.
        self.host_dp_max = min(1024, _LOOKBACK)
        # index probe path: "host" (native), "device", or "auto" (time
        # both on the first real batch and latch the faster); set from
        # FLYE_TPU_PROBE on the first batch (see _probe_choice)
        self._probe_path: Optional[str] = None
        self._probe_lock = _threading.Lock()
        # mapping mode keeps every chain anchor (needed for window
        # partitioning); assembly thins to >k spacing like the
        # reference's kept-alignment trace
        self.thin_anchors = thin_anchors
        self._target_lengths = target_store.lengths
        # id(store) -> (store, its ResidentStrands) for the card's
        # base alignment (see _align_resident)
        self._resident: Dict[int, tuple] = {}
        self._resident_lock = _threading.Lock()
        # divergence stats windows (reference: overlap.cpp:210-211)
        self.div_stats: List[float] = []

    # ------------------------------------------------------------------

    def get_overlaps(self, query_store: SequenceStore, sid: int,
                     force_local: bool = False,
                     max_overlaps: int = 0) -> List[Overlap]:
        """All overlaps of one query strand (reference:
        overlap.cpp:99-508 getSeqOverlaps)."""
        return self.get_overlaps_batch(query_store, [sid], force_local,
                                       max_overlaps)[sid]

    def get_overlaps_batch(self, query_store: SequenceStore,
                           sids: Sequence[int], force_local: bool = False,
                           max_overlaps: int = 0
                           ) -> Dict[int, List[Overlap]]:
        """Overlaps for a batch of query strands: one k-mer extraction +
        index lookup pass and one chaining-DP bucket set for the whole
        batch (cross-read batching keeps the device busy; the reference
        parallelizes the same loop over threads,
        reference: overlap.cpp:630-668)."""
        symmetric = query_store is self.targets
        from flye_tpu_torch import native
        return self._batch_fast(native.get(), query_store, list(sids),
                                force_local, max_overlaps, symmetric)

    # ------------------------------------------------------------------

    def _probe_choice(self) -> str:
        """The probe path of this batch: the latched choice, else
        FLYE_TPU_PROBE (host | device | auto), default "host" as in the
        JAX package.  "auto" returns "measure" (see _match_streams)."""
        if self._probe_path is not None:
            return self._probe_path
        import os
        env = os.environ.get("FLYE_TPU_PROBE", "").lower()
        if env in ("host", "device"):
            self._probe_path = env
            return env
        if env == "auto":
            return "measure"
        self._probe_path = "host"
        return "host"

    def _tune_probe(self, query_store, sids):
        """FLYE_TPU_PROBE=auto: time both probe paths on this batch and
        latch the faster; returns the host result when the host won
        (the outputs are equal), else None."""
        t0 = _pc()
        host_res = self.index.probe_stream_host(query_store, sids)
        t_host = _pc() - t0
        if host_res is None:
            self._probe_path = "device"
            return None
        with _device_lock():
            # a warm-up pass, then the timed one
            self.index.probe_stream_flat(query_store, sids)
            t0 = _pc()
            self.index.probe_stream_flat(query_store, sids)
            t_dev = _pc() - t0
        self._probe_path = "host" if t_host <= t_dev else "device"
        logger.info("probe path auto-tune: host %.2fs vs device %.2fs "
                    "per batch -> %s", t_host, t_dev, self._probe_path)
        return host_res if self._probe_path == "host" else None

    def _batch_fast(self, mod, query_store, sids, force_local,
                    max_overlaps, symmetric):
        """Native-assisted batch path: the index probe (native
        probe_stream, or the device under FLYE_TPU_PROBE), then posting
        expansion, group segmentation / survival filters, small-group
        chain DP, and the backtrack + overlap tests + anchor thinning +
        divergence all run in C++ threads (native collect_matches /
        chain_group_prep / chain_dp_host / finish_overlaps); only wide
        groups' DP rides the device (reference analog:
        src/sequence/overlap.cpp:99-427)."""
        nq = len(sids)
        if nq == 0:
            return {}
        streams = self._match_streams(mod, query_store, sids, symmetric)
        return self._finish_from_matches(mod, query_store, sids,
                                         streams, force_local,
                                         max_overlaps, symmetric)

    def _match_streams(self, mod, query_store, sids, symmetric):
        """Probe + posting gather for a batch of query strands; returns
        the per-query match streams
        (qpos, extid, extpos, qbounds, filt, foff) — everything the
        chain/finish half needs."""
        nq = len(sids)
        lengths = [query_store.length(s) for s in sids]
        probe_res = None
        trace.count("overlap.queries", nq)
        trace.count("overlap.batches")
        with trace.span("overlap: probe"):
            if self._probe_choice() == "measure":
                # the prefetch threads' first batches arrive together:
                # one measures, the others wait for its choice
                with self._probe_lock:
                    if self._probe_path is None:
                        probe_res = self._tune_probe(query_store, sids)
            if probe_res is None and self._probe_path == "host":
                probe_res = self.index.probe_stream_host(query_store,
                                                         sids)
        if probe_res is None:  # the device path, or no host probe
            with trace.span("overlap: probe"), _device_lock():
                probe_res = self.index.probe_stream_flat(query_store,
                                                         sids)
        g_hit, row_hit, fwd_hit, g_rep, starts, _ = probe_res
        # per-query filtered (repetitive-kmer) positions: g_rep is
        # ascending in stream order, so per-query slices stay sorted
        rep_qi = np.searchsorted(starts, g_rep, side="right") - 1
        filt = np.ascontiguousarray(
            (g_rep - starts[rep_qi]), dtype=np.int64)
        foff = np.searchsorted(rep_qi, np.arange(nq + 1)).astype(
            np.int64)
        tlens = np.ascontiguousarray(self._target_lengths,
                                     dtype=np.int64)
        with trace.span("overlap: gather"):
            qpos_b, extid_b, extpos_b, qb_b = mod.collect_matches(
                np.ascontiguousarray(g_hit, dtype=np.int64),
                np.ascontiguousarray(row_hit, dtype=np.int64),
                np.ascontiguousarray(fwd_hit).view(np.uint8),
                np.ascontiguousarray(self.index.counts,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.offsets,
                                     dtype=np.int64),
                np.ascontiguousarray(self.index.post_seq,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.post_pos,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.post_flip).view(
                    np.uint8),
                tlens, np.ascontiguousarray(starts, dtype=np.int64),
                np.asarray(sids, dtype=np.int64),
                len(g_hit), nq, int(self.k), int(symmetric))
        return (np.frombuffer(qpos_b, dtype=np.int32),
                np.frombuffer(extid_b, dtype=np.int64),
                np.frombuffer(extpos_b, dtype=np.int32),
                np.frombuffer(qb_b, dtype=np.int64),
                filt, foff)

    def _finish_from_matches(self, mod, query_store, sids, streams,
                             force_local, max_overlaps, symmetric):
        """Chain + extract + divergence from match streams (the second
        half of the native batch path; see _match_streams)."""
        nq = len(sids)
        results: Dict[int, List[Overlap]] = {sid: [] for sid in sids}
        lengths = [query_store.length(s) for s in sids]
        query_meta = list(zip(sids, lengths))
        curlens = np.asarray(lengths, dtype=np.int32)
        tlens = np.ascontiguousarray(self._target_lengths,
                                     dtype=np.int64)
        qpos_m, extid_m, extpos_m, qb_m, filt, foff = streams
        qpos_b = np.ascontiguousarray(qpos_m, dtype=np.int32)
        extid_b = np.ascontiguousarray(extid_m, dtype=np.int64)
        extpos_b = np.ascontiguousarray(extpos_m, dtype=np.int32)
        qb_b = np.ascontiguousarray(qb_m, dtype=np.int64)
        filt = np.ascontiguousarray(filt, dtype=np.int64)
        foff = np.ascontiguousarray(foff, dtype=np.int64)
        min_surv = _MIN_KMER_SURVIVAL_RATE * self.min_overlap
        with trace.span("overlap: prep"):
            (qi_b, eid_b, elen_b, stride_b, goff_b, gcur_b, gext_b) = \
                mod.chain_group_prep(
                    qpos_b, extid_b, extpos_b,
                    qb_b, curlens, tlens, nq, float(min_surv),
                    int(self.min_overlap), int(self.max_overhang),
                    int(self.check_overhang and not force_local),
                    int(_CHAIN_BUCKETS[-1]), int(max_overlaps))
        g_qi = np.frombuffer(qi_b, dtype=np.int32)
        g_eid = np.frombuffer(eid_b, dtype=np.int64)
        g_elen = np.frombuffer(elen_b, dtype=np.int32)
        g_stride = np.frombuffer(stride_b, dtype=np.int32)
        goff = np.frombuffer(goff_b, dtype=np.int64)
        gcur = np.frombuffer(gcur_b, dtype=np.int32)
        gext = np.frombuffer(gext_b, dtype=np.int32)
        G = len(g_qi)
        if G == 0:
            return results
        glens = np.diff(goff)

        g_cid = np.asarray(sids, dtype=np.int64)[g_qi]
        g_clen = curlens[g_qi].astype(np.int32)

        flags = (1 * (self.check_overhang and not force_local)
                 | 2 * bool(force_local)
                 | 4 * bool(symmetric)
                 | 8 * bool(self.only_max_ext)
                 | 16 * bool(self.thin_anchors))

        # overlaps per group.  Small groups (the vast majority) run
        # their full-window chain DP in threaded native code; groups
        # wider than host_dp_max run the device DP.  For groups
        # <= the device lookback window the two are bit-identical
        # (full window == bounded window); host_dp_max must not exceed
        # the engine lookback for that to hold.
        per_group: List[Optional[tuple]] = [None] * G

        def finish_rows(gids_arr, score_flat, parent_flat, scoff, W):
            with trace.span("overlap: finish"):
                (row_of_b, coords_b, score_b, div_b, aoff_b,
                 anchors_b) = mod.finish_overlaps(
                    score_flat, parent_flat, scoff, len(gids_arr),
                    int(W), gcur, gext,
                    np.ascontiguousarray(goff[gids_arr]),
                    np.ascontiguousarray(glens[gids_arr]),
                    np.ascontiguousarray(g_eid[gids_arr]),
                    np.ascontiguousarray(g_elen[gids_arr]),
                    np.ascontiguousarray(g_stride[gids_arr]),
                    np.ascontiguousarray(g_qi[gids_arr]),
                    np.ascontiguousarray(g_cid[gids_arr]),
                    np.ascontiguousarray(g_clen[gids_arr]),
                    filt, foff, int(self.k), int(self.min_overlap),
                    int(self.max_overhang), int(flags),
                    float(self.index.sample_rate))
            row_of = np.frombuffer(row_of_b, dtype=np.int32)
            coords = np.frombuffer(coords_b, dtype=np.int32) \
                .reshape(-1, 4)
            vscore = np.frombuffer(score_b, dtype=np.int64)
            vdiv = np.frombuffer(div_b, dtype=np.float64)
            aoff = np.frombuffer(aoff_b, dtype=np.int64)
            # int32 anchors: at 50x coverage the anchor traces are
            # the cache's dominant per-overlap memory
            anchors = np.frombuffer(anchors_b, dtype=np.int32) \
                .reshape(-1, 2)
            # split per row (row_of ascending)
            starts_r = np.searchsorted(row_of,
                                       np.arange(len(gids_arr) + 1))
            for r, gi in enumerate(gids_arr):
                s, e = starts_r[r], starts_r[r + 1]
                if s < e:
                    per_group[gi] = (coords[s:e], vscore[s:e],
                                     vdiv[s:e],
                                     [anchors[aoff[v]:aoff[v + 1]]
                                      for v in range(s, e)])

        host_gids = np.flatnonzero(glens <= self.host_dp_max)
        dev_gids = np.flatnonzero(glens > self.host_dp_max)
        if len(host_gids):
            with trace.span("overlap: chain dp host"):
                scoff_b, hs_b, hp_b = mod.chain_dp_host(
                    gcur, gext, np.ascontiguousarray(goff[host_gids]),
                    np.ascontiguousarray(glens[host_gids]),
                    len(host_gids), int(self.k), int(self.max_jump))
            # scoff_b has n+1 entries (prefix sums); the finisher only
            # reads the first n
            finish_rows(host_gids, hs_b, hp_b, scoff_b,
                        max(int(self.host_dp_max), 1))
        for gids, W, score_mat, parent_mat in self._run_chain_dp_buckets(
                goff, glens, gcur, gext, dev_gids):
            gids_arr = np.asarray(gids, dtype=np.int64)
            nrows = len(gids)
            scoff = (np.arange(nrows, dtype=np.int64) * W)
            finish_rows(gids_arr,
                        np.ascontiguousarray(score_mat),
                        np.ascontiguousarray(parent_mat),
                        scoff, int(W))

        # assemble Overlap objects in original group order (determinism
        # + the max_overlaps economy both depend on this order)
        div_windows: Dict[int, Dict[int, Overlap]] = {}
        # (with base alignment, no overlap is kept before every one is
        # aligned, so max_overlaps cuts nothing until then)
        aligned = []
        with trace.span("overlap: overlaps"):
            for gi in range(G):
                entry = per_group[gi]
                if entry is None:
                    continue
                qi = int(g_qi[gi])
                sid, cur_len = query_meta[qi]
                detected = results[sid]
                if max_overlaps and len(detected) >= max_overlaps:
                    continue
                coords, vscore, vdiv, anchor_list = entry
                eid = int(g_eid[gi])
                elen = int(g_elen[gi])
                for v in range(len(vscore)):
                    ov = Overlap(sid, eid, int(coords[v, 0]),
                                 int(coords[v, 1]), cur_len,
                                 int(coords[v, 2]), int(coords[v, 3]),
                                 elen, score=int(vscore[v]),
                                 divergence=float(vdiv[v]))
                    ov.kmer_matches = anchor_list[v]
                    if self.nucl_alignment:
                        aligned.append((sid, ov))
                    else:
                        self._keep_or_trim(ov, None, detected,
                                           div_windows.setdefault(sid, {}))
        if aligned:
            device = self._resident_device(query_store)
            if device is None:
                self._align_host(query_store, aligned, results, div_windows)
            else:
                self._align_resident(query_store, aligned, device, results,
                                     div_windows)

        for sid_windows in div_windows.values():
            for ov in sid_windows.values():
                self.div_stats.append(ov.divergence)
        trace.count("overlap.kept", sum(len(v) for v in results.values()))
        return results

    def _run_chain_dp_buckets(self, goff, glens, gcur, gext,
                              gids_subset=None):
        """Bucketed device chain DP over array-form groups; yields
        (gids, W, score_mat, parent_mat) per bucket batch."""
        by_bucket: Dict[int, List[int]] = {}
        gi_iter = (enumerate(glens) if gids_subset is None
                   else ((int(gi), glens[gi]) for gi in gids_subset))
        for gi, m in gi_iter:
            bucket = next((b for b in _CHAIN_BUCKETS if m <= b),
                          _CHAIN_BUCKETS[-1])
            by_bucket.setdefault(bucket, []).append(gi)
        if not by_bucket:
            return
        t_buckets = (8, 32, 128, 512, 2048)
        # all buckets come back in one flattened fetch
        # (ops/chain.chain_dp_multi)
        from flye_tpu_torch.parallel.runtime import get_runtime
        bucket_specs = []
        with trace.span("overlap: chain dp"), _device_lock():
            for bucket in sorted(by_bucket):
                gids = by_bucket[bucket]
                T = next((t for t in t_buckets if len(gids) <= t),
                         len(gids))
                with trace.span("overlap: chain dp pack"):
                    cur = np.zeros((T, bucket), dtype=np.int32)
                    ext = np.zeros((T, bucket), dtype=np.int32)
                    nv = np.zeros(T, dtype=np.int32)
                    for r, gi in enumerate(gids):
                        s = goff[gi]
                        m = min(int(glens[gi]), bucket)
                        cur[r, :m] = gcur[s:s + m]
                        ext[r, :m] = gext[s:s + m]
                        nv[r] = m
                bucket_specs.append(
                    (gids, bucket, T,
                     get_runtime().shard_rows(cur, ext, nv)))
                trace.count("overlap.k1_rows", T)
            flat = chain_dp_multi(
                [arrs for _, _, _, arrs in bucket_specs],
                self.k, self.max_jump, _LOOKBACK)
            with trace.span("overlap: chain dp wait"):
                flat = trace.readback(flat).cpu().numpy()
        off = 0
        for gids, bucket, T, _ in bucket_specs:
            n = T * bucket
            score = flat[off:off + n].reshape(T, bucket)
            off += n
            parent = flat[off:off + n].reshape(T, bucket)
            off += n
            yield (gids, bucket, score[:len(gids)], parent[:len(gids)])

    def _resident_device(self, query_store) -> Optional["torch.device"]:
        """The card that scores this engine's segments from resident
        strands (`_align_resident`): the runtime's device when it is a
        card and the runtime's only device, and both stores' strands fit
        int32 positions; else None, and the segments take the host
        path (`anchored_divergence` + `SegmentBatcher.run`)."""
        from flye_tpu_torch.parallel.runtime import get_runtime
        rt = get_runtime()
        if rt.device.type != "cuda" or rt.n_devices > 1:
            return None
        if 2 * max(query_store.total_length,
                   self.targets.total_length) >= 2 ** 31:
            return None
        return rt.device

    def _flat_anchors(self, ovs: Sequence[Overlap]):
        """`_anchors_for` of every overlap as one flat int32 [N, 2]
        array and the overlaps' offsets into it ([len(ovs) + 1]): the
        matches strictly inside each overlap are kept with array
        operations, and only an overlap whose inner matches do not
        ascend runs `_anchors_for`'s greedy pass (counted as
        `align.anchor_fallbacks`)."""
        n = len(ovs)
        km = [np.asarray(ov.kmer_matches).reshape(-1, 2) for ov in ovs]
        cnt = np.fromiter((len(k) for k in km), np.int64, n)
        ends = np.array([(ov.cur_begin, ov.ext_begin, ov.cur_end,
                          ov.ext_end) for ov in ovs],
                        dtype=np.int32).reshape(n, 4)
        km = np.ascontiguousarray(np.concatenate(
            km + [np.zeros((0, 2), np.int32)]), dtype=np.int32)
        # each (cur, ext) pair moves as one 64-bit word
        pair = km.view(np.int64).reshape(-1)
        c, e = km[:, 0], km[:, 1]
        kov = np.repeat(np.arange(n, dtype=np.int32), cnt)
        inner = ((c > np.repeat(ends[:, 0], cnt))
                 & (c < np.repeat(ends[:, 2], cnt))
                 & (e > np.repeat(ends[:, 1], cnt))
                 & (e < np.repeat(ends[:, 3], cnt)))
        pair, kov = pair[inner], kov[inner]
        ce = pair.view(np.int32).reshape(-1, 2)
        bad = np.zeros(n, dtype=bool)
        bad[kov[1:][(kov[1:] == kov[:-1])
                    & ((np.diff(ce[:, 0]) <= 0)
                       | (np.diff(ce[:, 1]) <= 0))]] = True
        fallback = [(o, self._anchors_for(ovs[o])[1:-1].astype(np.int32))
                    for o in np.flatnonzero(bad)]
        trace.count("align.anchor_fallbacks", len(fallback))
        if fallback:
            keep = ~bad[kov]
            kov = np.concatenate([kov[keep]] + [
                np.full(len(f), o, np.int32) for o, f in fallback])
            pair = np.concatenate([pair[keep]] + [
                f.view(np.int64).reshape(-1) for _, f in fallback])
            order = np.argsort(kov, kind="stable")
            kov, pair = kov[order], pair[order]
        # overlap o's anchors: its start, its inner matches, its end
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(kov, minlength=n) + 2, out=off[1:])
        flat = np.empty((int(off[-1]), 2), dtype=np.int32)
        slot = np.ones(len(flat), dtype=bool)
        slot[off[:-1]] = slot[off[1:] - 1] = False
        flat.view(np.int64).reshape(-1)[slot] = pair
        flat[off[:-1]] = ends[:, :2]
        flat[off[1:] - 1] = ends[:, 2:]
        return flat, off

    def _align_host(self, query_store, aligned, results,
                    div_windows) -> None:
        """Score every aligned overlap of the batch and keep or trim it
        on the host path: each overlap's inter-anchor segments tiled by
        `anchored_divergence` ("overlap: segments") and queued on one
        `SegmentBatcher`, scored together ("overlap: base alignment")."""
        batcher = SegmentBatcher()
        with trace.span("overlap: segments"):
            pending = [(sid, ov, anchored_divergence(
                query_store.get(sid), self.targets.get(ov.ext_id),
                self._anchors_for(ov), self.k, use_hpc=self.use_hpc,
                batcher=batcher)) for sid, ov in aligned]
        with trace.span("overlap: base alignment"):
            dists = batcher.run()
        with trace.span("overlap: overlaps"):
            for sid, ov, finish in pending:
                div, per_seg, spans = finish(dists)
                ov.divergence = div
                self._keep_or_trim(ov, (per_seg, spans), results[sid],
                                   div_windows.setdefault(sid, {}))

    def _strands(self, store, device) -> ResidentStrands:
        """`store`'s strands on device, built on first use and kept while
        this engine lives (rebuilt when sequences were added)."""
        with self._resident_lock:
            held = self._resident.get(id(store))
            if (held is None or held[0] is not store
                    or held[1].n_seqs != len(store)
                    or held[1].device != device):
                held = self._resident[id(store)] = (
                    store, ResidentStrands(store, device, self.use_hpc))
            return held[1]

    def _align_resident(self, query_store, aligned, device, results,
                        div_windows) -> None:
        """Score every aligned overlap of the batch on the card and keep
        or trim it, as the host path does: the anchors flattened on the
        host ("overlap: segments"), the segments derived from them,
        gathered from the resident strands and scored on the device, the
        distances read back once ("overlap: base alignment"; see
        `ops.align.anchored_distances`)."""
        with trace.span("overlap: segments"):
            ovs = [ov for _, ov in aligned]
            flat, off = self._flat_anchors(ovs)
            n = len(ovs)
            # an overlap's inner anchors lie strictly between its ends,
            # so its anchors ascend unless its end precedes its start
            first = flat[off[:-1]].astype(np.int64)
            last = flat[off[1:] - 1].astype(np.int64)
            if (last < first).any():
                raise ValueError("anchors must ascend in both coordinates")
            anchor_ov = np.repeat(np.arange(n, dtype=np.int32),
                                  np.diff(off))
            sids = np.fromiter((sid for sid, _ in aligned), np.int64, n)
            eids = np.fromiter((ov.ext_id for ov in ovs), np.int64, n)
            q_res = self._strands(query_store, device)
            t_res = self._strands(self.targets, device)
            ov_strands = np.stack(
                [q_res.base(sids), query_store.lengths[sids >> 1],
                 t_res.base(eids), self.targets.lengths[eids >> 1]],
                axis=1)
        with trace.span("overlap: base alignment"):
            dist = anchored_distances(q_res, t_res, flat, anchor_ov,
                                      ov_strands)
        with trace.span("overlap: overlaps"):
            # per overlap as `anchored_divergence`'s finish: the total
            # over its segments (slots off[o] .. off[o + 1] - 2) over
            # the longer side of its anchored span plus k
            csum = np.concatenate([[0], np.cumsum(dist)])
            total = csum[off[1:] - 1] - csum[off[:-1]]
            span = (last - first).max(axis=1) + self.k
            divs = total / np.maximum(1, span)
            for o, (sid, ov) in enumerate(aligned):
                ov.divergence = divs[o]
                lo, hi = off[o], off[o + 1]
                self._keep_or_trim(
                    ov, (dist[lo:hi - 1],
                         np.diff(flat[lo:hi].astype(np.int64), axis=0)),
                    results[sid], div_windows.setdefault(sid, {}))

    def _anchors_for(self, ov: Overlap) -> np.ndarray:
        """The overlap's two ends with the k-mer matches strictly inside
        it between them, each kept only if it lies past the last kept
        one in both coordinates."""
        km = np.asarray(ov.kmer_matches, dtype=np.int64).reshape(-1, 2)
        c, e = km[:, 0], km[:, 1]
        inner = km[(ov.cur_begin < c) & (c < ov.cur_end)
                   & (ov.ext_begin < e) & (e < ov.ext_end)]
        if not ((np.diff(inner[:, 0]) > 0).all()
                and (np.diff(inner[:, 1]) > 0).all()):
            # matches out of order: keep the increasing ones greedily
            kept = [(ov.cur_begin, ov.ext_begin)]
            for c, e in inner.tolist():
                if c > kept[-1][0] and e > kept[-1][1]:
                    kept.append((c, e))
            inner = np.asarray(kept[1:], dtype=np.int64).reshape(-1, 2)
        return np.concatenate([[[ov.cur_begin, ov.ext_begin]], inner,
                               [[ov.cur_end, ov.ext_end]]]).astype(np.int64)

    def _keep_or_trim(self, ov: Overlap, seg_info, detected, div_windows):
        stat_wnd = 10000
        if ov.divergence < self.max_divergence:
            detected.append(ov)
        elif self.partition_bad_mappings and seg_info is not None:
            detected.extend(self._trim_bad_mapping(ov, *seg_info))
        w = ov.cur_begin // stat_wnd
        prev = div_windows.get(w)
        if prev is None or ov.cur_range > prev.cur_range:
            div_windows[w] = ov

    def _trim_bad_mapping(self, ov: Overlap, per_seg: np.ndarray,
                          spans: np.ndarray) -> List[Overlap]:
        """Find sub-intervals of a too-divergent overlap that individually
        pass the divergence threshold (behavioral equivalent of
        checkIdyAndTrim, reference: src/sequence/alignment.cpp:306-430,
        reformulated over anchor segments instead of CIGAR windows)."""
        km = self._anchors_for(ov)
        n_seg = len(per_seg)
        if n_seg == 0:
            return []
        out = []
        i = 0
        thr = self.max_divergence
        while i < n_seg:
            # greedy: grow [i, j) while the running divergence stays small
            edits = 0
            cspan = 0
            espan = 0
            j = i
            best_j = i
            while j < n_seg:
                e2 = edits + per_seg[j]
                c2 = cspan + spans[j][0]
                x2 = espan + spans[j][1]
                if e2 / max(1, max(c2, x2)) <= thr:
                    edits, cspan, espan = e2, c2, x2
                    j += 1
                    best_j = j
                else:
                    break
            if best_j > i and min(cspan, espan) >= self.min_overlap:
                sub = Overlap(ov.cur_id, ov.ext_id,
                              int(km[i][0]), int(km[best_j][0]), ov.cur_len,
                              int(km[i][1]), int(km[best_j][1]), ov.ext_len,
                              score=ov.score,
                              divergence=edits / max(1, max(cspan, espan)))
                sub.kmer_matches = km[i:best_j + 1]
                out.append(sub)
            i = max(best_j, i + 1)
        return out


class OverlapStore:
    """Lazy per-read overlap cache with symmetrization and dedup filtering
    (reference: OverlapContainer, src/sequence/overlap.cpp:528-741).

    packed=True stores the cache in the columnar arena
    (overlap/packed.py, ~3-4x less RSS than Overlap-object lists) and
    materializes objects on access through a small LRU; use it for
    read-only stores (the ava store: prefetch + lazy access).  Stores
    that mutate their lists in place (ensure_transitivity /
    filter_overlaps — the repeat driver's read-vs-disjointig store)
    must keep packed=False."""

    # materialized working set: the disjointig extender walks a local
    # neighborhood of reads repeatedly; ~1k reads x ~60 overlaps of
    # objects is ~25 MB — decode cost off the hot loop, RSS bounded
    _LRU_SIZE = 1024

    def __init__(self, engine: OverlapEngine, query_store: SequenceStore,
                 packed: bool = False):
        from collections import OrderedDict

        from flye_tpu_torch.overlap.packed import PackedOverlaps
        self.engine = engine
        self.queries = query_store
        self._cache: Dict[int, Tuple[List[Overlap], List[Overlap]]] = {}
        self._packed: Optional[PackedOverlaps] = (
            PackedOverlaps() if packed else None)
        self._lru: "OrderedDict[int, List[Overlap]]" = OrderedDict()
        self.mean_true_divergence: float = 0.5

    def _cached_reads(self):
        """All fwd ids present in either representation."""
        if self._packed is None:
            return list(self._cache.keys())
        seen = set(self._cache.keys())
        out = list(self._cache.keys())
        out.extend(r for r in self._packed.reads() if r not in seen)
        return out

    def _materialize(self, sid: int) -> List[Overlap]:
        """Packed-store access with an LRU of materialized lists."""
        lst = self._lru.get(sid)
        if lst is not None:
            self._lru.move_to_end(sid)
            return lst
        fwd_id = sid & ~1
        fwd = self._packed.get(fwd_id)
        lst = fwd if sid % 2 == 0 else [o.complement() for o in fwd]
        self._lru[sid] = lst
        if len(self._lru) > self._LRU_SIZE:
            self._lru.popitem(last=False)
        return lst

    def quick_overlaps(self, sid: int, max_overlaps: int = 0,
                       force_local: bool = False) -> List[Overlap]:
        return self.engine.get_overlaps(self.queries, sid,
                                        force_local=force_local,
                                        max_overlaps=max_overlaps)

    def lazy_overlaps(self, sid: int) -> List[Overlap]:
        fwd_id = sid & ~1
        entry = self._cache.get(fwd_id)
        if entry is None:
            if self._packed is not None and fwd_id in self._packed:
                return self._materialize(sid)
            ovlps = self.engine.get_overlaps(
                self.queries, fwd_id,
                max_overlaps=self.engine.max_cur_overlaps)
            if self._packed is not None:
                self._packed.add(fwd_id, ovlps)
                return self._materialize(sid)
            rev = [o.complement() for o in ovlps]
            entry = (ovlps, rev)
            self._cache[fwd_id] = entry
        return entry[0] if sid % 2 == 0 else entry[1]

    def prefetch(self, sids, batch_rows: int = 1024,
                 max_batch_bases: int = 8 << 20,
                 progress_every: int = 0) -> None:
        """Batch-fill the overlap cache (cross-read device batching).

        Batches go through a 2-deep thread pipeline: while one batch
        waits on the device, the other runs its native host prep/finish
        (GIL released in C++) —
        the two-core analog of the reference's thread pool over the
        same loop (reference: overlap.cpp:630-668).  Per-batch results
        are independent, so the cache contents are identical to
        sequential order."""
        todo = []
        seen = set()
        for sid in sids:
            fwd = sid & ~1
            if (fwd not in self._cache and fwd not in seen
                    and (self._packed is None
                         or fwd not in self._packed)):
                seen.add(fwd)
                todo.append(fwd)
        # group by similar length for padding efficiency
        todo.sort(key=lambda s: self.queries.length(s))
        groups = []
        i = 0
        while i < len(todo):
            group = [todo[i]]
            bases = self.queries.length(todo[i])
            i += 1
            while (i < len(todo) and len(group) < batch_rows and
                   bases + self.queries.length(todo[i]) <
                   max_batch_bases):
                group.append(todo[i])
                bases += self.queries.length(todo[i])
                i += 1
            groups.append(group)

        from concurrent.futures import ThreadPoolExecutor
        done = 0
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = []
            gi = 0
            while gi < len(groups) or futs:
                while gi < len(groups) and len(futs) < 2:
                    futs.append((groups[gi], ex.submit(
                        trace.carry(self.engine.get_overlaps_batch),
                        self.queries,
                        groups[gi],
                        max_overlaps=self.engine.max_cur_overlaps)))
                    gi += 1
                group, fut = futs.pop(0)
                res = fut.result()
                with trace.span("overlap: store"):
                    for sid, ovlps in res.items():
                        if self._packed is not None:
                            self._packed.add(sid, ovlps)
                        else:
                            self._cache[sid] = (
                                ovlps, [o.complement() for o in ovlps])
                done += len(group)
                if (progress_every and done // progress_every !=
                        (done - len(group)) // progress_every):
                    logger.info("overlaps: %d/%d reads", done,
                                len(todo))

    def overlaps(self, sid: int) -> List[Overlap]:
        return self.lazy_overlaps(sid)

    def _unsafe(self, sid: int) -> List[Overlap]:
        fwd_id = sid & ~1
        if fwd_id not in self._cache:
            self._cache[fwd_id] = ([], [])
        entry = self._cache[fwd_id]
        return entry[0] if sid % 2 == 0 else entry[1]

    def find_all_overlaps(self, progress_every: int = 0) -> None:
        """All-vs-all (reference: overlap.cpp:630-668)."""
        self.prefetch(self.queries.ids(),
                      progress_every=progress_every)
        self.ensure_transitivity(only_max_ext=False)
        n = sum(len(v[0]) * 2 for v in self._cache.values())
        logger.debug("Found %d overlaps", n)
        self.filter_overlaps()
        n = sum(len(v[0]) * 2 for v in self._cache.values())
        logger.debug("Left %d overlaps after filtering", n)

    def ensure_transitivity(self, only_max_ext: bool) -> None:
        """Make the overlap relation symmetric
        (reference: overlap.cpp:576-627)."""
        assert self._packed is None, \
            "transitivity mutates lists in place; use packed=False"
        all_ids = []
        for fwd_id in list(self._cache.keys()):
            all_ids.extend([fwd_id, fwd_id + 1])
        to_add: Dict[int, List[Overlap]] = {}
        # per-sid {ext_id: index} maps make each reverse lookup O(1)
        # instead of a linear scan of the ext list (the scans dominated
        # the host side of find_all_overlaps at high coverage)
        if only_max_ext:
            ext_pos: Dict[int, Dict[int, int]] = {}
            for sid in all_ids:
                d: Dict[int, int] = {}
                for i, ov in enumerate(self._unsafe(sid)):
                    d.setdefault(ov.ext_id, i)  # first entry wins
                ext_pos[sid] = d
        for sid in all_ids:
            for ov in self._unsafe(sid):
                if only_max_ext:
                    ext_list = self._unsafe(ov.ext_id)
                    i = ext_pos.get(ov.ext_id, {}).get(ov.cur_id)
                    if i is not None:
                        if ov.score > ext_list[i].score:
                            ext_list[i] = ov.reverse()
                    else:
                        to_add.setdefault(ov.ext_id, []).append(ov.reverse())
                else:
                    to_add.setdefault(ov.ext_id, []).append(ov.reverse())
        for sid, ovlps in to_add.items():
            self._unsafe(sid).extend(ovlps)

    def filter_overlaps(self) -> None:
        """Cluster near-duplicate overlaps per read and keep the best
        (reference: overlap.cpp:681-741).

        Pairwise comparisons run as NumPy broadcasts per (read, ext)
        group instead of Python object loops — the O(n^2)-pair
        attribute-access loop dominated host time at high coverage."""
        max_ends_diff = self.engine.k
        for sid in [i for f in self._cache for i in (f, f + 1)]:
            ovlps = self._unsafe(sid)
            n = len(ovlps)
            if not n:
                continue
            ext = np.fromiter((o.ext_id for o in ovlps), np.int64, n)
            cb = np.fromiter((o.cur_begin for o in ovlps), np.int64, n)
            ce = np.fromiter((o.cur_end for o in ovlps), np.int64, n)
            eb = np.fromiter((o.ext_begin for o in ovlps), np.int64, n)
            ee = np.fromiter((o.ext_end for o in ovlps), np.int64, n)
            order = np.argsort(ext, kind="stable")
            bounds = np.flatnonzero(np.concatenate(
                [[True], ext[order][1:] != ext[order][:-1]]))
            bounds = np.append(bounds, n)
            ds = DisjointSet()
            for i in range(n):
                ds.add(i)
            for s, e in zip(bounds[:-1], bounds[1:]):
                if e - s < 2:
                    continue
                g = order[s:e]
                # o1 = the earlier-listed overlap of the pair (matches
                # the original loop's o1/o2 orientation)
                ii, jj = np.meshgrid(g, g, indexing="ij")
                up = ii < jj
                cur_int = (np.minimum(ce[ii], ce[jj])
                           - np.maximum(cb[ii], cb[jj]))
                ext_int = (np.minimum(ee[ii], ee[jj])
                           - np.maximum(eb[ii], eb[jj]))
                cur_diff = (ce[ii] - cb[ii]) - cur_int
                ext_diff = (ee[ii] - eb[ii]) - ext_int
                close = (up & (cur_diff < max_ends_diff)
                         & (ext_diff < max_ends_diff))
                for a, b in zip(ii[close], jj[close]):
                    ds.union(int(a), int(b))
            new = []
            for members in ds.groups().values():
                best = max(members, key=lambda i: ovlps[i].score)
                new.append(ovlps[best])
            new.sort(key=lambda o: o.cur_begin)
            fwd_id = sid & ~1
            entry = self._cache[fwd_id]
            if sid % 2 == 0:
                self._cache[fwd_id] = (new, entry[1])
            else:
                self._cache[fwd_id] = (entry[0], new)

    def estimate_overlaper_parameters(self, max_seqs: int = 1000,
                                      seed: int = 42) -> None:
        """Median divergence of each sampled read's largest overlap
        (reference: overlap.cpp:744-817)."""
        rng = np.random.default_rng(seed)
        ids = self.queries.ids()
        if not ids:
            self.mean_true_divergence = 0.5
            return
        # sample distinct ids so the effective sample size is exactly
        # min(max_seqs, n) (reference: overlap.cpp:752-760 samples
        # without replacement via shuffled id list)
        n_sample = min(max_seqs, len(ids))
        sample = [ids[i] for i in
                  rng.choice(len(ids), size=n_sample, replace=False)]
        sample.sort(key=lambda s: self.queries.length(s))
        divs = []
        for lo in range(0, len(sample), 256):
            res = self.engine.get_overlaps_batch(
                self.queries, sample[lo:lo + 256])
            for ovlps in res.values():
                if ovlps:
                    best = max(ovlps, key=lambda o: o.cur_range)
                    divs.append(best.divergence)
        if divs:
            self.mean_true_divergence = float(np.median(divs))
        else:
            logger.warning("No overlaps found - unable to estimate "
                           "parameters")
            self.mean_true_divergence = 0.5
        logger.debug("Initial divergence estimate: %.4f",
                     self.mean_true_divergence)

    def log_divergence_stats(self) -> None:
        """Median + ASCII histogram of observed overlap divergences
        (behavioral equivalent of overlapDivergenceStats,
        reference: src/sequence/overlap.cpp:829-896): 100 columns over
        [0, 0.5), 20 rows, current max-divergence cutoff marked '|'."""
        divs = np.asarray(self.engine.div_stats, dtype=np.float64)
        if not len(divs):
            return
        logger.info("Median overlap divergence: %.6f",
                    float(np.median(divs)))
        cols, rows, dmax = 100, 20, 0.5
        hist, _ = np.histogram(divs, bins=cols, range=(0.0, dmax))
        peak = max(1, int(hist.max()))
        cutoff = int(self.engine.max_divergence / dmax * cols)
        lines = []
        for h in range(rows - 1, -1, -1):
            row = [("*" if hist[i] / peak > h / rows else
                    "|" if i == cutoff else " ") for i in range(cols)]
            lines.append("    |" + "".join(row))
        lines.append("    " + "-" * cols)
        footer = [" "] * cols
        for i in range(10):
            for j, ch in enumerate(f"{i * 5}%"):
                footer[i * cols // 10 + j] = ch
        lines.append("    " + "".join(footer))
        q25, q50, q75 = np.percentile(divs, [25, 50, 75])
        logger.debug("Sequence divergence distribution:\n%s\n"
                     "    Q25 = %.2f, Q50 = %.2f, Q75 = %.2f",
                     "\n".join(lines), q25, q50, q75)

    def set_divergence_threshold(self, threshold: float,
                                 relative: bool) -> None:
        self.engine.max_divergence = (
            (self.mean_true_divergence if relative else 0.0) + threshold)
        logger.debug("Max divergence threshold set to %.4f",
                     self.engine.max_divergence)

    def _fwd_list(self, fwd_id: int) -> List[Overlap]:
        entry = self._cache.get(fwd_id)
        if entry is not None:
            return entry[0]
        return self._packed.get(fwd_id)

    def all_overlaps(self) -> List[Overlap]:
        out = []
        for fwd_id in self._cached_reads():
            f = self._fwd_list(fwd_id)
            out.extend(f)
            out.extend(o.complement() for o in f)
        return out

    def dump_shard(self, path: str) -> None:
        """Serialize this process's overlap-cache partition to one npz
        (the multi-process ava exchange: each process computes overlaps
        for its read partition and ships the shard over the shared
        filesystem — the per-host generalization of the reference's
        inter-stage file bus, e.g. its alignment dumps,
        reference: src/repeat_graph/read_aligner.h:32-33).  The keys are
        the JAX package's."""
        reads = sorted(self._cached_reads())
        counts = []
        cur_id, ext_id = [], []
        coords = []
        score, div = [], []
        aoff = [0]
        anchors = []
        for fwd in reads:
            ovlps = self._fwd_list(fwd)
            counts.append(len(ovlps))
            for o in ovlps:
                cur_id.append(o.cur_id)
                ext_id.append(o.ext_id)
                coords.append((o.cur_begin, o.cur_end, o.cur_len,
                               o.ext_begin, o.ext_end, o.ext_len))
                score.append(o.score)
                div.append(o.divergence)
                km = (o.kmer_matches if o.kmer_matches is not None
                      else np.zeros((0, 2), np.int32))
                anchors.append(np.asarray(km, dtype=np.int32))
                aoff.append(aoff[-1] + len(km))
        # publish atomically: a reader must never see a half-written
        # shard (the barrier only proves the writer REACHED the dump)
        tmp = f"{path}.tmp{os.getpid()}"
        np.savez_compressed(
            tmp, reads=np.asarray(reads, np.int64),
            counts=np.asarray(counts, np.int64),
            cur_id=np.asarray(cur_id, np.int64),
            ext_id=np.asarray(ext_id, np.int64),
            coords=np.asarray(coords, np.int64).reshape(-1, 6),
            score=np.asarray(score, np.int64),
            div=np.asarray(div, np.float64),
            aoff=np.asarray(aoff, np.int64),
            anchors=(np.concatenate(anchors) if anchors
                     else np.zeros((0, 2), np.int32)))
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    def load_shard(self, path: str) -> None:
        """Merge a dumped shard into the cache (complement lists are
        rebuilt, exactly as prefetch builds them)."""
        z = np.load(path)
        reads = z["reads"]
        counts = z["counts"]
        coords = z["coords"]
        aoff = z["aoff"]
        anchors = z["anchors"]
        # hoist npz members: NpzFile decompresses the whole array on
        # every [] access, so per-overlap indexing of z[...] would make
        # the merge quadratic
        cur_id = z["cur_id"]
        ext_id = z["ext_id"]
        score = z["score"]
        div = z["div"]
        v = 0
        for fwd, n in zip(reads, counts):
            ovlps = []
            for _ in range(n):
                ov = Overlap(int(cur_id[v]), int(ext_id[v]),
                             *(int(x) for x in coords[v]),
                             score=int(score[v]),
                             divergence=float(div[v]))
                km = anchors[aoff[v]:aoff[v + 1]]
                ov.kmer_matches = km if len(km) else None
                ovlps.append(ov)
                v += 1
            if self._packed is not None:
                self._packed.add(int(fwd), ovlps)
            else:
                self._cache[int(fwd)] = (ovlps,
                                         [o.complement() for o in ovlps])
