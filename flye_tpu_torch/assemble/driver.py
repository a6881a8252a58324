"""Disjointig assembly stage driver.

Orchestrates the pipeline of the reference's `flye-modules assemble`
entry point (reference: src/assemble/main_assemble.cpp:123-257): load
reads -> build index (minimizer or solid-kmer path per config) -> overlap
engine in only-max-ext mode -> divergence auto-threshold -> greedy
extension -> stitched disjointig sequences.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

from flye_tpu_torch.assemble.chimera import ChimeraDetector
from flye_tpu_torch.assemble.extender import Extender
from flye_tpu_torch.assemble.stitch import generate_disjointig_sequences
from flye_tpu_torch.config import Config
from flye_tpu_torch.index import (KmerIndex, build_minimizer_index,
                                  build_solid_index)
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.overlap import OverlapEngine, OverlapStore
from flye_tpu_torch.utils.logs import stage_timer

logger = logging.getLogger("flye_tpu_torch")


def build_read_index(store: SequenceStore, cfg: Config) -> KmerIndex:
    """Index construction per read type
    (reference: main_assemble.cpp:207-223)."""
    k = cfg.kmer_size
    if cfg.use_minimizers:
        return build_minimizer_index(
            store, k, cfg.minimizer_window, min_cov=1,
            repeat_kmer_rate=cfg.repeat_kmer_rate)
    return build_solid_index(
        store, k,
        select_rate=cfg.meta_read_top_kmer_rate,
        tandem_freq=cfg.meta_read_filter_kmer_freq,
        global_min_freq=2,
        sample=cfg.assemble_kmer_sample,
        repeat_kmer_rate=cfg.repeat_kmer_rate)


def assemble_disjointigs(store: SequenceStore, cfg: Config,
                         min_overlap: Optional[int] = None,
                         genome_size: Optional[int] = None,
                         work_dir: Optional[str] = None
                         ) -> Optional[List[Tuple[str, np.ndarray]]]:
    """Full assemble stage: returns (name, codes) disjointigs.

    Multi-process (process_count > 1): every process builds the same
    index and computes overlaps for ITS host_partition of the reads;
    shards are exchanged through `work_dir` on the shared filesystem and
    the coordinator merges them before the (sequential) extension walk.
    Worker processes return None after contributing their shard.  With
    FLYE_TPU_PARTITIONED=1 each process instead builds and holds only
    its k-mer hash shard of the index, and the divergence estimation
    and the ava probes route through the file bus
    (`parallel/partitioned.py`)."""
    min_overlap = min_overlap or cfg.min_overlap

    # maxCurOverlaps economy: bound per-read overlap collection at
    # factor * expected coverage so repetitive/trashy reads can't blow
    # up the ava phase (reference: main_assemble.cpp:204,228 +
    # overlap.cpp:218-219; off by default like the reference release,
    # enable with --extra-params max_read_overlaps_factor=5)
    max_cur_overlaps = 0
    factor = int(cfg.max_read_overlaps_factor
                 if "max_read_overlaps_factor" in cfg else 0)
    if factor > 0 and genome_size and not bool(cfg.uneven_coverage):
        total_bases = int(store.lengths.sum())
        coverage = max(1, total_bases // genome_size)
        max_cur_overlaps = factor * coverage
        logger.debug("Expected read coverage: %d; capping per-read "
                     "overlaps at %d", coverage, max_cur_overlaps)

    import os

    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    # hash-partitioned multi-process mode: each process builds and
    # holds only its k-mer hash shard of the index (~1/P memory) and
    # the ava probes route through the file bus
    partitioned = (rt.process_count > 1 and
                   os.environ.get("FLYE_TPU_PARTITIONED") == "1")
    with stage_timer("index build"):
        if partitioned:
            if work_dir is None:
                raise ValueError("partitioned build needs a shared "
                                 "work_dir")
            from flye_tpu_torch.parallel.partitioned import \
                build_partitioned_index
            index = build_partitioned_index(store, cfg, work_dir, rt)
        else:
            index = build_read_index(store, cfg)

    engine = OverlapEngine(
        store, index,
        max_jump=cfg.maximum_jump,
        min_overlap=min_overlap,
        max_overhang=cfg.maximum_overhang,
        keep_alignment=False,
        only_max_ext=True,
        max_divergence=1.0,
        nucl_alignment=bool(cfg.reads_base_alignment),
        use_hpc=bool(cfg.hpc_scoring_on),
        max_cur_overlaps=max_cur_overlaps,
    )
    # packed columnar cache: the ava store is prefetch + read-only
    # access, the dominant host allocation at scale (overlap/packed.py)
    ovlp_store = OverlapStore(engine, store, packed=True)
    with stage_timer("divergence estimation"):
        if partitioned:
            from flye_tpu_torch.parallel.partitioned import \
                partitioned_estimate_divergence
            partitioned_estimate_divergence(ovlp_store, work_dir, rt)
        else:
            ovlp_store.estimate_overlaper_parameters()
        ovlp_store.set_divergence_threshold(
            cfg.assemble_ovlp_divergence,
            relative=bool(cfg.assemble_divergence_relative))
        ovlp_store.log_divergence_stats()

    chim = ChimeraDetector(
        store, ovlp_store,
        window=cfg.chimera_window,
        max_overhang=cfg.maximum_overhang,
        max_drop_rate=cfg.max_coverage_drop_rate,
        uneven_coverage=bool(cfg.uneven_coverage))

    extender = Extender(
        store, ovlp_store, chim,
        safe_overlap=min_overlap,
        max_jump=cfg.maximum_jump,
        max_overhang=cfg.maximum_overhang,
        max_extensions_drop_rate=cfg.max_extensions_drop_rate,
        min_reads_in_disjointig=cfg.min_reads_in_disjointig,
        max_inner_reads=cfg.max_inner_reads,
        max_inner_fraction=cfg.max_inner_fraction,
        add_unassembled_reads=bool(cfg.add_unassembled_reads))

    if rt.process_count > 1:
        from flye_tpu_torch.parallel.distributed import (BarrierAborted,
                                                         file_barrier,
                                                         host_partition,
                                                         is_coordinator)
        if work_dir is None:
            raise ValueError("multi-process run needs a shared work_dir "
                             "for the ava shard exchange")
        with stage_timer("overlap prefetch (host shard)"):
            if partitioned:
                from flye_tpu_torch.parallel.partitioned import \
                    partitioned_prefetch
                partitioned_prefetch(ovlp_store, work_dir, rt,
                                     progress_every=50)
            else:
                mine = host_partition(store.ids(), rt.process_index,
                                      rt.process_count)
                logger.info("host %d/%d: computing overlaps for %d of "
                            "%d reads", rt.process_index,
                            rt.process_count, len(mine),
                            len(store.ids()))
                ovlp_store.prefetch(mine, progress_every=1000)
            if not is_coordinator():
                ovlp_store.dump_shard(os.path.join(
                    work_dir, f"ava_shard_{rt.process_index}.npz"))
        try:
            file_barrier(work_dir, "ava_shards")
        except BarrierAborted:
            if is_coordinator():
                raise
            logger.info("host %d: coordinator shut down before the ava "
                        "barrier; dropping shard", rt.process_index)
            return None
        if not is_coordinator():
            logger.info("host %d: ava shard contributed; the "
                        "coordinator carries the host-plane stages",
                        rt.process_index)
            return None
        with stage_timer("ava shard merge"):
            for p in range(1, rt.process_count):
                ovlp_store.load_shard(os.path.join(
                    work_dir, f"ava_shard_{p}.npz"))
    else:
        with stage_timer("overlap prefetch"):
            ovlp_store.prefetch(store.ids(), progress_every=1000)
    with stage_timer("disjointig extension"):
        extender.assemble_disjointigs()

    with stage_timer("sequence generation"):
        seqs = generate_disjointig_sequences(
            extender.disjointig_paths, store, cfg.kmer_size,
            cfg.maximum_jump)
    total = sum(len(s) for _, s in seqs)
    logger.info("Generated %d disjointig sequences, total length %d",
                len(seqs), total)
    return seqs
