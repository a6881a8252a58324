"""Hash-partitioned multi-process index + ava (memory scale-out).

Port of `flye_tpu/parallel/partitioned.py`.  The classic multi-process
ava (assemble/driver.py) gives every process the FULL k-mer index and
splits only the query reads: time scales, memory does not.  This mode
partitions the INDEX by k-mer hash across the run's processes
(reference analog: the packed postings in bounded arenas,
vertex_index.h:85-114, at the process level):

  1. count exchange   — each process counts k-mers over its READ
                        partition only, buckets (kmer, count) pairs by
                        hash shard, and the shard owner merge-sums them
                        into the global counts of its shard;
  2. freq join        — each process reads the global shard-count
                        tables one at a time to give its own stream
                        positions their exact global frequencies;
  3. select + posting — per-read selection is local
                        exchange           (KmerIndex._select_with_freq);
                        selected postings go to their hash-owning
                        shard, which sorts ONLY its partition and
                        finalizes with the globally exchanged mean
                        frequency (repetitive cutoff): each process
                        holds ~1/P of the index;
  4. partitioned probe — every query position carries one k-mer, which
                        lives in one shard, so each shard owner probes
                        ALL reads against its partition
                        (OverlapEngine._match_streams) and ships
                        per-read-owner match streams over the file bus;
                        the read owner merges them with one stable sort
                        by query position, which gives the full-index
                        match stream byte for byte, and finishes chain
                        DP + overlap extraction for its read partition
                        (OverlapEngine._finish_from_matches).

Every transport is an atomic npz file under work_dir/.partition with
file_barrier rendezvous (the bus of the ava shard exchange), so
processes on the card and on the CPU can run it together.  Enabled with
FLYE_TPU_PARTITIONED=1 on a multi-process run.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

import numpy as np

from flye_tpu_torch.index.kmer_index import KmerIndex
from flye_tpu_torch.index.sharded import ShardedKmerIndex
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.parallel.distributed import (_publish, file_barrier,
                                                 host_partition)
from flye_tpu_torch.utils import trace

logger = logging.getLogger("flye_tpu_torch")


def _pdir(work_dir: str) -> str:
    d = os.path.join(work_dir, ".partition")
    os.makedirs(d, exist_ok=True)
    return d


def _save(path: str, **arrays) -> None:
    """Atomic npz publish (a writer's crash must not leave a readable
    half-file; the barrier only proves the writer reached the dump)."""
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz", path)


def _owner_of(fwd_ids: np.ndarray, order: Dict[int, int],
              count: int) -> np.ndarray:
    """Read-owner process of each forward id (host_partition's
    round-robin over sorted forward ids)."""
    return np.asarray([order[int(f)] % count for f in fwd_ids],
                      dtype=np.int64)


def _group_counts(sorted_kmers: np.ndarray):
    """(unique k-mers, their run starts) of a sorted k-mer array."""
    starts = np.flatnonzero(np.concatenate(
        [[True], sorted_kmers[1:] != sorted_kmers[:-1]]))
    return sorted_kmers[starts], starts


def build_partitioned_index(store: SequenceStore, cfg, work_dir: str,
                            rt) -> KmerIndex:
    """Build this process's hash-shard partition of the read index.

    Equal to the full build restricted to the shard's k-mers: counts
    are exact (summed over partitions), selection is per read with the
    exchanged global frequencies, postings sort per shard (hash shards
    partition the key space, so a shard's order is its order inside
    the full sorted array), and the repetitive cutoff and sample_rate
    use globally exchanged sums."""
    p, P = rt.process_index, rt.process_count
    pdir = _pdir(work_dir)
    k = cfg.kmer_size
    ids = store.ids()
    my_ids = host_partition(ids, p, P)
    idx = KmerIndex(store, k)

    if cfg.use_minimizers:
        idx.w = cfg.minimizer_window
        min_cov = 1
        with trace.span("partitioned extract"):
            kmers, seq, pos, flip = idx._extract_selected(
                my_ids, w=cfg.minimizer_window, sample=1)
    else:
        idx.w = 1
        with trace.span("partitioned extract"):
            kmers, seq, pos, flip = idx._extract_selected(
                my_ids, w=1, sample=cfg.assemble_kmer_sample)

        # ---- 1. count exchange ----
        with trace.span("partitioned count exchange"):
            order = np.argsort(kmers)
            uk, starts = _group_counts(kmers[order])
            uc = np.diff(np.concatenate(
                [starts, [len(kmers)]])).astype(np.int64)
            # each stream position's row in uk, for the freq join
            inv = np.empty(len(kmers), dtype=np.int64)
            inv[order] = np.repeat(np.arange(len(uk)), uc)
            del order, starts
            ushard = ShardedKmerIndex.shard_of(uk, P)
            for s in range(P):
                m = ushard == s
                _save(os.path.join(pdir, f"counts_{p}_{s}.npz"),
                      uk=uk[m], uc=uc[m])
            del uc
            file_barrier(work_dir, "part_counts")

            # merge-sum my shard's counts from every sender
            zs = [np.load(os.path.join(pdir, f"counts_{q}_{p}.npz"))
                  for q in range(P)]
            mk = np.concatenate([z["uk"] for z in zs])
            mc = np.concatenate([z["uc"] for z in zs])
            del zs
            o = np.argsort(mk, kind="stable")
            mk, mc = mk[o], mc[o]
            del o
            guk, gstarts = _group_counts(mk)
            guc = np.add.reduceat(mc, gstarts) if len(mc) else mc
            del mk, mc, gstarts
            _save(os.path.join(pdir, f"gcounts_{p}.npz"),
                  uk=guk, uc=guc.astype(np.int64))
            del guk, guc
            file_barrier(work_dir, "part_gcounts")

        # ---- 2. freq join (one shard table in memory at a time) ----
        # looked up once per distinct k-mer, in ascending order (a
        # search with sorted queries walks the table in order), then
        # spread to the stream positions
        with trace.span("partitioned freq join"):
            ufreq = np.zeros(len(uk), dtype=np.int64)
            for s in range(P):
                z = np.load(os.path.join(pdir, f"gcounts_{s}.npz"))
                guk, guc = z["uk"], z["uc"]
                m = ushard == s
                if not m.any() or len(guk) == 0:
                    continue
                q = uk[m]
                rows = np.clip(np.searchsorted(guk, q), 0, len(guk) - 1)
                ufreq[m] = np.where(guk[rows] == q, guc[rows], 0)
            freq = ufreq[inv]
            del uk, ushard, inv, ufreq

        # ---- per-read selection with exact global frequencies ----
        with trace.span("partitioned select"):
            kmers, seq, pos, flip = idx._select_with_freq(
                kmers, seq, pos, flip, freq.astype(np.int32),
                cfg.meta_read_top_kmer_rate,
                cfg.meta_read_filter_kmer_freq, 2)
            del freq
        min_cov = 2

    # ---- 3. posting exchange; shard-local sort + finalize ----
    with trace.span("partitioned posting exchange"):
        shard = ShardedKmerIndex.shard_of(kmers, P)
        for s in range(P):
            m = shard == s
            _save(os.path.join(pdir, f"post_{p}_{s}.npz"),
                  kmers=kmers[m], seq=seq[m], pos=pos[m], flip=flip[m])
        del kmers, seq, pos, flip, shard
        file_barrier(work_dir, "part_postings")

        parts = [np.load(os.path.join(pdir, f"post_{q}_{p}.npz"))
                 for q in range(P)]
        kmers, seq, pos, flip = KmerIndex._sort_triples(
            *(np.concatenate([z[name] for z in parts])
              for name in ("kmers", "seq", "pos", "flip")))
        del parts

    # local (total, uniq_n) of count >= min_cov k-mers, then the global
    # sums: the repetitive cutoff is rate x GLOBAL mean frequency
    with trace.span("partitioned finalize"):
        if len(kmers):
            _, gs = _group_counts(kmers)
            cnts = np.diff(np.concatenate(
                [gs, [len(kmers)]])).astype(np.int64)
            eligible = cnts >= min_cov
            total = int(cnts[eligible].sum())
            uniq_n = int(eligible.sum())
        else:
            total = uniq_n = 0
        _publish(os.path.join(pdir, f"stats_{p}.json"),
                 json.dumps({"total": total, "uniq_n": uniq_n}))
        file_barrier(work_dir, "part_stats")
        g_total = g_uniq = 0
        for q in range(P):
            with open(os.path.join(pdir, f"stats_{q}.json")) as f:
                st = json.load(f)
            g_total += st["total"]
            g_uniq += st["uniq_n"]
        mean_freq = g_total / (g_uniq + 1)
        idx._finalize(kmers, seq, pos, flip, min_cov,
                      cfg.repeat_kmer_rate, mean_freq_override=mean_freq)

        # global sample_rate (total read bases / total index entries)
        entries = int(idx.counts.sum()) if len(idx.counts) else 0
        _publish(os.path.join(pdir, f"entries_{p}.json"),
                 json.dumps({"entries": entries}))
        file_barrier(work_dir, "part_entries")
        g_entries = 0
        for q in range(P):
            with open(os.path.join(pdir, f"entries_{q}.json")) as f:
                g_entries += json.load(f)["entries"]
        total_len = sum(store.length(i) for i in ids)
        idx.sample_rate = total_len / max(1, g_entries)
    logger.info("partitioned index: shard %d/%d holds %d k-mers / %d "
                "postings (global mean freq %.2f)", p, P,
                idx.num_kmers, entries, mean_freq)
    return idx


# ---------------------------------------------------------------------
# partitioned ava
# ---------------------------------------------------------------------

def _prefetch_groups(store: SequenceStore, sids,
                     batch_rows: int = 1024,
                     max_batch_bases: int = 8 << 20):
    """The batch grouping OverlapStore.prefetch builds, computed alike
    on every process (it follows from the id list alone)."""
    todo = []
    seen = set()
    for sid in sids:
        fwd = sid & ~1
        if fwd not in seen:
            seen.add(fwd)
            todo.append(fwd)
    todo.sort(key=lambda s: store.length(s))
    groups = []
    i = 0
    while i < len(todo):
        group = [todo[i]]
        bases = store.length(todo[i])
        i += 1
        while (i < len(todo) and len(group) < batch_rows and
               bases + store.length(todo[i]) < max_batch_bases):
            group.append(todo[i])
            bases += store.length(todo[i])
            i += 1
        groups.append(group)
    return groups


def _split_streams(streams, owners: np.ndarray) -> Dict[int, dict]:
    """Split one _match_streams result by read-owner process."""
    qpos, extid, extpos, qb, filt, foff = streams
    out = {}
    for o in np.unique(owners):
        qi = np.flatnonzero(owners == o)
        # per-query slices stay contiguous; gather them per owner
        mlens = qb[qi + 1] - qb[qi]
        flens = foff[qi + 1] - foff[qi]
        m_idx = (np.concatenate([np.arange(qb[q], qb[q + 1]) for q in qi])
                 if mlens.sum() else np.zeros(0, np.int64))
        f_idx = (np.concatenate([np.arange(foff[q], foff[q + 1])
                                 for q in qi])
                 if flens.sum() else np.zeros(0, np.int64))
        out[int(o)] = dict(
            qsel=qi.astype(np.int64),
            qpos=qpos[m_idx], extid=extid[m_idx], extpos=extpos[m_idx],
            qb=np.concatenate([[0], np.cumsum(mlens)]).astype(np.int64),
            filt=filt[f_idx],
            foff=np.concatenate([[0], np.cumsum(flens)]).astype(np.int64))
    return out


def _merge_streams(parts: List[dict], n_query: int):
    """Merge per-shard match streams of one query list into the
    full-index stream byte for byte: concatenate per query, then
    stable-sort by query position (all matches of one position come
    from one shard, already in posting order there)."""
    per = {name: [[] for _ in range(n_query)]
           for name in ("qpos", "extid", "extpos", "filt")}
    for part in parts:
        qb, foff = part["qb"], part["foff"]
        for qi in range(n_query):
            s, e = qb[qi], qb[qi + 1]
            if e > s:
                for name in ("qpos", "extid", "extpos"):
                    per[name][qi].append(part[name][s:e])
            fs, fe = foff[qi], foff[qi + 1]
            if fe > fs:
                per["filt"][qi].append(part["filt"][fs:fe])
    qpos_all, extid_all, extpos_all, filt_all = [], [], [], []
    qb = np.zeros(n_query + 1, np.int64)
    foff = np.zeros(n_query + 1, np.int64)
    for qi in range(n_query):
        if per["qpos"][qi]:
            qp = np.concatenate(per["qpos"][qi])
            o = np.argsort(qp, kind="stable")
            qpos_all.append(qp[o])
            extid_all.append(np.concatenate(per["extid"][qi])[o])
            extpos_all.append(np.concatenate(per["extpos"][qi])[o])
            qb[qi + 1] = qb[qi] + len(qp)
        else:
            qb[qi + 1] = qb[qi]
        if per["filt"][qi]:
            fp = np.sort(np.concatenate(per["filt"][qi]))
            filt_all.append(fp)
            foff[qi + 1] = foff[qi] + len(fp)
        else:
            foff[qi + 1] = foff[qi]

    def cat(lst, dt):
        return np.concatenate(lst) if lst else np.zeros(0, dt)
    return (cat(qpos_all, np.int32), cat(extid_all, np.int64),
            cat(extpos_all, np.int32), qb, cat(filt_all, np.int64), foff)


def _load_parts(paths) -> List[dict]:
    parts = []
    for path in paths:
        z = np.load(path)
        parts.append({k: z[k] for k in z.files})
    return parts


def partitioned_prefetch(ovlp_store, work_dir: str, rt,
                         progress_every: int = 0) -> None:
    """All-vs-all over the hash-partitioned index (phase 4 above).

    Each process probes EVERY read batch against its index partition
    (shard-owner role: ~1/P of the postings), ships match streams to
    the read owners over the file bus, then finishes chain DP and
    extraction for its own read partition (read-owner role).  The
    overlap cache it fills equals the full-index prefetch of the same
    partition."""
    from flye_tpu_torch import native
    engine = ovlp_store.engine
    store = engine.targets
    mod = native.get()
    p, P = rt.process_index, rt.process_count
    pdir = _pdir(work_dir)
    groups = _prefetch_groups(store, store.ids())
    fwd_sorted = sorted({i & ~1 for i in store.ids()})
    order = {f: n for n, f in enumerate(fwd_sorted)}

    # shard-owner pass: probe every group against my index partition
    for gi, group in enumerate(groups):
        streams = engine._match_streams(mod, store, group, symmetric=True)
        owners = _owner_of(np.asarray(group, np.int64), order, P)
        for o, part in _split_streams(streams, owners).items():
            _save(os.path.join(pdir, f"ms_{p}_{o}_{gi}.npz"), **part)
        if progress_every and gi % progress_every == 0:
            logger.info("partitioned probe: %d/%d batches", gi,
                        len(groups))
    file_barrier(work_dir, "part_probe")

    # read-owner pass: merge the shards' streams, finish my reads
    n_done = 0
    for gi, group in enumerate(groups):
        owners = _owner_of(np.asarray(group, np.int64), order, P)
        mine_qi = np.flatnonzero(owners == p)
        if len(mine_qi) == 0:
            continue
        my_sids = [group[q] for q in mine_qi]
        parts = _load_parts(
            path for path in (os.path.join(pdir, f"ms_{s}_{p}_{gi}.npz")
                              for s in range(P))
            if os.path.exists(path))
        merged = _merge_streams(parts, len(my_sids))
        res = engine._finish_from_matches(
            mod, store, my_sids, merged, force_local=False,
            max_overlaps=engine.max_cur_overlaps, symmetric=True)
        for sid, ovlps in res.items():
            if ovlp_store._packed is not None:
                ovlp_store._packed.add(sid, ovlps)
            else:
                ovlp_store._cache[sid] = (
                    ovlps, [o.complement() for o in ovlps])
        n_done += len(my_sids)
    logger.info("partitioned ava: process %d finished %d reads", p, n_done)


def partitioned_estimate_divergence(ovlp_store, work_dir: str, rt,
                                    max_seqs: int = 1000,
                                    seed: int = 42) -> None:
    """estimate_overlaper_parameters over the partitioned index: every
    process probes the SAME deterministic sample against its shard; the
    coordinator merges and finishes (the sample is small), publishes
    the median, and every process loads it."""
    from flye_tpu_torch import native
    engine = ovlp_store.engine
    store = engine.targets
    mod = native.get()
    p, P = rt.process_index, rt.process_count
    pdir = _pdir(work_dir)
    rng = np.random.default_rng(seed)
    ids = store.ids()
    out_path = os.path.join(pdir, "divergence.json")
    if not ids:
        ovlp_store.mean_true_divergence = 0.5
        return
    n_sample = min(max_seqs, len(ids))
    sample = [ids[i] for i in
              rng.choice(len(ids), size=n_sample, replace=False)]
    sample.sort(key=lambda s: store.length(s))
    batches = [sample[lo:lo + 256] for lo in range(0, len(sample), 256)]
    for bi, batch in enumerate(batches):
        streams = engine._match_streams(mod, store, batch, symmetric=True)
        owners = np.zeros(len(batch), np.int64)  # the coordinator finishes
        _save(os.path.join(pdir, f"est_{p}_{bi}.npz"),
              **_split_streams(streams, owners)[0])
    file_barrier(work_dir, "part_est")
    if p == 0:
        divs = []
        for bi, batch in enumerate(batches):
            parts = _load_parts(os.path.join(pdir, f"est_{s}_{bi}.npz")
                                for s in range(P))
            res = engine._finish_from_matches(
                mod, store, batch, _merge_streams(parts, len(batch)),
                force_local=False, max_overlaps=0, symmetric=True)
            for ovlps in res.values():
                if ovlps:
                    best = max(ovlps, key=lambda o: o.cur_range)
                    divs.append(best.divergence)
        med = float(np.median(divs)) if divs else 0.5
        if not divs:
            logger.warning("No overlaps found - unable to estimate "
                           "parameters")
        _publish(out_path, json.dumps({"median": med}))
    file_barrier(work_dir, "part_est_done")
    with open(out_path) as f:
        ovlp_store.mean_true_divergence = json.load(f)["median"]
    logger.debug("Initial divergence estimate: %.4f",
                 ovlp_store.mean_true_divergence)
