"""Repeat-analysis stage driver.

Orchestrates the `flye-modules repeat` pipeline (reference:
src/repeat_graph/main_repeat.cpp:127-298): build graph from disjointig
self-overlaps -> align reads to the graph -> estimate coverage ->
iterate simplification {trim tips, find repeats, resolve repeats} until
no actions -> store dumps.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from flye_tpu_torch.config import Config
from flye_tpu_torch.index import build_minimizer_index
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.overlap import OverlapEngine, OverlapStore
from flye_tpu_torch.repeat.graph import RepeatGraph
from flye_tpu_torch.repeat.multiplicity import MultiplicityInferer
from flye_tpu_torch.repeat.read_aligner import ReadAligner
from flye_tpu_torch.repeat.resolver import RepeatResolver
from flye_tpu_torch.utils.logs import stage_timer

logger = logging.getLogger("flye_tpu_torch")


def analyse_repeats(disjointigs: SequenceStore, reads: SequenceStore,
                    cfg: Config, out_dir: Optional[str] = None,
                    min_overlap: Optional[int] = None):
    """Returns (graph, aligner, inferer) after simplification."""
    min_overlap = min_overlap or cfg.min_overlap

    with stage_timer("repeat graph construction"):
        k = cfg.kmer_size
        w = cfg.minimizer_window if cfg.use_minimizers else 1
        index = build_minimizer_index(
            disjointigs, k, max(1, w),
            repeat_kmer_rate=cfg.repeat_kmer_rate)
        engine = OverlapEngine(
            disjointigs, index,
            max_jump=cfg.maximum_jump,
            min_overlap=min_overlap,
            max_overhang=0,
            keep_alignment=True,
            only_max_ext=False,
            max_divergence=cfg.repeat_graph_ovlp_divergence,
            nucl_alignment=True,
            partition_bad_mappings=True,
            use_hpc=bool(cfg.hpc_scoring_on),
        )
        ovlp_store = OverlapStore(engine, disjointigs)
        ovlp_store.find_all_overlaps()
        graph = RepeatGraph(disjointigs)
        graph.build(ovlp_store, cfg.max_separation, min_overlap)
        problems = graph.validate()
        for p in problems[:10]:
            logger.warning("graph invariant: %s", p)
        logger.info("Built repeat graph: %d nodes, %d edges",
                    len(graph.nodes), len(graph.edges))

    with stage_timer("read-to-graph alignment"):
        aligner = ReadAligner(graph, reads, cfg, min_overlap)
        aligner.align_reads()

    with stage_timer("graph simplification"):
        inferer = MultiplicityInferer(graph, aligner, cfg)
        inferer.estimate_coverage()
        inferer.remove_unsupported_edges(only_tips=True)
        resolver = RepeatResolver(graph, reads, aligner, cfg, inferer)
        from flye_tpu_torch.repeat.haplotype import HaplotypeResolver
        hap = HaplotypeResolver(graph, cfg, aligner=aligner, reads=reads)
        is_meta = "uneven_coverage" in cfg and cfg.uneven_coverage
        if is_meta:
            # (reference: main_repeat.cpp:231-239)
            resolver.find_repeats()
            resolver.resolve_simple_repeats()
        # iterate until fixpoint (reference: main_repeat.cpp:239-270)
        for iteration in range(10):
            actions = 0
            actions += inferer.split_nodes()
            if is_meta:
                actions += inferer.disconnect_minor_paths()
            actions += inferer.trim_tips()
            # haplotype masking is recomputed from scratch each
            # iteration and does not count as an action
            # (reference: main_repeat.cpp:252-257)
            hap.reset_edges()
            hap.find_heterozygous_loops()
            hap.find_heterozygous_bulges()
            if is_meta:
                # complex variation masking (reference:
                # main_repeat.cpp:258-260)
                hap.find_roundabouts()
                hap.find_superbubbles()
            resolver.find_repeats()
            actions += resolver.resolve_repeats()
            if actions == 0:
                break
            logger.debug("simplification iteration %d: %d actions",
                         iteration + 1, actions)
        # meta mode: detach weak fork branches
        # (reference: main_repeat.cpp:272-275 resolveForks)
        if is_meta:
            inferer.resolve_forks()
        keep_haplotypes = ("keep_haplotypes" in cfg and
                           cfg.keep_haplotypes)
        if not keep_haplotypes:
            hap.collapse_haplotypes()
            resolver.resolve_simple_repeats()
        inferer.remove_unsupported_edges(only_tips=True)
        resolver.find_repeats()
        resolver.finalize_graph()

    if out_dir:
        graph.store(os.path.join(out_dir, "repeat_graph_dump"))
        aligner.store(os.path.join(out_dir, "read_alignment_dump"))
    return graph, aligner, inferer
