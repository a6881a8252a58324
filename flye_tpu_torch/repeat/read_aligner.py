"""Read-to-graph alignment.

Behavioral port of ReadAligner (reference: src/repeat_graph/read_aligner.cpp):
every edge segment's disjointig subsequence is indexed; reads get local
overlaps against segments; per-read overlaps chain across graph adjacency
with the active/frozen chain DP (read_aligner.cpp:24-154); greedy
non-overlapping chain selection; per-chain divergence filter.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from flye_tpu_torch.index import build_minimizer_index
from flye_tpu_torch.io.seqstore import SeqId, SequenceStore
from flye_tpu_torch.overlap.engine import OverlapEngine
from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.repeat.graph import GraphEdge, RepeatGraph

logger = logging.getLogger("flye_tpu_torch")

_SMALL_ALN = 100
_BIG_ALN = 500
_LONG_EDGE = 900
_MAX_READ_OVLP = 50


@dataclass
class EdgeAlignment:
    overlap: Overlap            # cur = read, ext = edge segment seq
    edge: GraphEdge


GraphAlignment = List[EdgeAlignment]


class ReadAligner:
    def __init__(self, graph: RepeatGraph, reads: SequenceStore,
                 cfg, min_overlap: int):
        self.graph = graph
        self.reads = reads
        self.cfg = cfg
        self.min_overlap = min_overlap
        self.alignments: List[GraphAlignment] = []

    def _build_segment_store(self):
        """One sequence per edge segment + id maps (reference:
        read_aligner.cpp:160-175)."""
        store = SequenceStore()
        id_to_edge: Dict[int, Tuple[GraphEdge, bool]] = {}
        for edge in self.graph.iter_edges():
            if edge.edge_id % 2 == 1 and not edge.self_complement:
                continue  # add only fwd strands; rc resolved via id^1
            for si, seg in enumerate(edge.seq_segments):
                codes = self.graph.asm.get_sub(seg.orig_seq_id, seg.start,
                                               seg.end)
                sid = store.add(f"edge{edge.edge_id}_seg{si}", codes)
                id_to_edge[sid] = edge
                comp = (edge if edge.self_complement
                        else self.graph.edges[edge.edge_id ^ 1])
                id_to_edge[SeqId(sid).rc] = comp
        return store, id_to_edge

    def align_reads(self) -> None:
        seg_store, id_to_edge = self._build_segment_store()
        if not len(seg_store):
            self.alignments = []
            return
        k = self.cfg.kmer_size
        w = (self.cfg.minimizer_window
             if self.cfg.use_minimizers else 1)
        index = build_minimizer_index(seg_store, k, max(1, w))
        engine = OverlapEngine(
            seg_store, index,
            max_jump=self.cfg.maximum_jump,
            min_overlap=_SMALL_ALN,
            max_overhang=0,
            only_max_ext=False,
            max_divergence=1.0,
        )
        max_div = self.cfg.read_align_ovlp_divergence
        n_aligned = 0
        total_aln_len = 0
        self.alignments = []
        todo = [rid for rid in self.reads.ids()
                if self.reads.length(rid) > self.min_overlap]
        todo.sort(key=self.reads.length)
        batches = [todo[i:i + 48] for i in range(0, len(todo), 48)]
        for group in batches:
            batch_res = engine.get_overlaps_batch(self.reads, group,
                                                  force_local=True)
            for rid in group:
                ovlps = batch_res.get(rid, [])
                alns = []
                for ov in ovlps:
                    if (ov.ext_len < _LONG_EDGE or
                            min(ov.cur_range, ov.ext_range) > _BIG_ALN):
                        alns.append(EdgeAlignment(ov,
                                                  id_to_edge[ov.ext_id]))
                alns.sort(key=lambda a: a.overlap.cur_begin)
                chains = self._chain_alignments(alns)
                good = [c for c in chains
                        if self._chain_divergence(c) < max_div]
                for chain in good:
                    self.alignments.append(chain)
                    comp = [EdgeAlignment(
                        a.overlap.complement(),
                        self.graph.complement_edge(a.edge))
                        for a in reversed(chain)]
                    self.alignments.append(comp)
                if good:
                    n_aligned += 1
                    total_aln_len += sum(a.overlap.cur_range
                                         for c in good for a in c)
        logger.info("Aligned %d reads, total alignment length %d",
                    n_aligned, total_aln_len)

    def update_alignments(self) -> None:
        """Re-sync alignments with the (edited) graph: drop alignments
        to deleted edges and split chains at broken junctions
        (reference: read_aligner.cpp:295-319 updateAlignments)."""
        new_alignments: List[GraphAlignment] = []
        edges = self.graph.edges
        for aln in self.alignments:
            cur: GraphAlignment = []
            for i in range(len(aln) - 1):
                if edges.get(aln[i].edge.edge_id) is not aln[i].edge:
                    continue
                cur.append(aln[i])
                nxt = aln[i + 1]
                if (edges.get(nxt.edge.edge_id) is not nxt.edge or
                        aln[i].edge.node_right is not nxt.edge.node_left):
                    new_alignments.append(cur)
                    cur = []
            if edges.get(aln[-1].edge.edge_id) is aln[-1].edge:
                cur.append(aln[-1])
            if cur:
                new_alignments.append(cur)
        self.alignments = new_alignments

    def _chain_divergence(self, chain: GraphAlignment) -> float:
        divs = [a.overlap.divergence for a in chain]
        return float(np.mean(divs)) if divs else 1.0

    def _chain_alignments(self, alns: List[EdgeAlignment]
                          ) -> List[GraphAlignment]:
        """(reference: read_aligner.cpp:24-154 chainReadAlignments)."""
        max_jump = self.cfg.maximum_jump
        max_sep = self.cfg.max_separation
        min_aln = self.min_overlap

        active: List[Tuple[List[EdgeAlignment], int]] = []
        frozen: List[Tuple[List[EdgeAlignment], int]] = []
        for ea in alns:
            ov = ea.overlap
            can_extend = ov.ext_begin < max_jump
            can_be_extended = ov.ext_len - ov.ext_end < max_jump
            best_score = 0
            best_chain = None
            n_outdated = 0
            if can_extend:
                for chain in active:
                    prev = chain[0][-1]
                    pov = prev.overlap
                    read_diff = ov.cur_begin - pov.cur_end
                    g_left = ov.ext_begin
                    g_right = pov.ext_len - pov.ext_end
                    if (prev.edge.node_right is ea.edge.node_left and
                            max_jump > read_diff > -_MAX_READ_OVLP and
                            g_left + g_right < max_jump):
                        jump_div = abs(read_diff - (g_left + g_right))
                        gap = jump_div // 50 if jump_div > 100 else 0
                        score = chain[1] + ov.score - gap
                        if score > best_score:
                            best_score = score
                            best_chain = chain
                    if read_diff > max_jump:
                        n_outdated += 1
            if best_chain is not None:
                active.append((best_chain[0] + [ea], best_score))
            else:
                entry = ([ea], ov.score)
                (active if can_be_extended else frozen).append(entry)

            if n_outdated > len(active) // 2:
                still = []
                for chain in active:
                    if (ov.cur_begin - chain[0][-1].overlap.cur_end >
                            max_jump):
                        frozen.append(chain)
                    else:
                        still.append(chain)
                active = still

        all_chains = active + frozen
        all_chains.sort(key=lambda c: -c[1])
        accepted: List[GraphAlignment] = []
        for chain, _score in all_chains:
            aln_len = chain[-1].overlap.cur_end - chain[0].overlap.cur_begin
            if aln_len < min_aln:
                continue
            overlaps_existing = False
            for ex in accepted:
                inter = (min(chain[-1].overlap.cur_end,
                             ex[-1].overlap.cur_end) -
                         max(chain[0].overlap.cur_begin,
                             ex[0].overlap.cur_begin))
                if inter > max_sep:
                    overlaps_existing = True
                    break
            if not overlaps_existing:
                accepted.append(list(chain))
        return accepted

    # ------------------------------------------------------------------

    @classmethod
    def load(cls, graph: RepeatGraph, reads: SequenceStore, cfg,
             min_overlap: int, path: str) -> "ReadAligner":
        """Reconstruct alignments from a dump written by store()."""
        aligner = cls(graph, reads, cfg, min_overlap)
        aligner.alignments = []
        chain: GraphAlignment = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if parts[0] == "Chain":
                    if chain:
                        aligner.alignments.append(chain)
                    chain = []
                elif parts[0] == "Aln":
                    signed = parts[1]
                    eid = (int(signed[1:]) - 1) * 2 + (signed[0] == "-")
                    edge = graph.edges.get(eid)
                    if edge is None:
                        continue
                    rid = reads.id_by_name(parts[2])
                    if parts[3] == "-":
                        rid = SeqId(rid).rc
                    ov = Overlap(int(rid), -1,
                                 int(parts[4]), int(parts[5]),
                                 int(parts[6]), int(parts[7]),
                                 int(parts[8]), int(parts[9]),
                                 score=int(parts[10]),
                                 divergence=float(parts[11]))
                    chain.append(EdgeAlignment(ov, edge))
        if chain:
            aligner.alignments.append(chain)
        logger.info("Loaded %d alignment chains", len(aligner.alignments))
        return aligner

    def store(self, path: str) -> None:
        """Text dump compatible in spirit with the reference's alignment
        dump (reference: read_aligner.h:32-33; python mirror
        flye/repeat_graph/graph_alignment.py)."""
        with open(path, "w") as f:
            for chain in self.alignments:
                f.write("Chain\n")
                for a in chain:
                    ov = a.overlap
                    sign = "+" if a.edge.edge_id % 2 == 0 else "-"
                    eid = a.edge.edge_id // 2 + 1
                    f.write(f"\tAln\t{sign}{eid}\t"
                            f"{self.reads.name(ov.cur_id)}\t"
                            f"{'-+'[ov.cur_id % 2 == 0]}\t"
                            f"{ov.cur_begin}\t{ov.cur_end}\t{ov.cur_len}\t"
                            f"{ov.ext_begin}\t{ov.ext_end}\t{ov.ext_len}\t"
                            f"{ov.score}\t{ov.divergence:.4f}\n")
