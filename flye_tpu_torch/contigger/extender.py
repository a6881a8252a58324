"""Contig generation from the simplified repeat graph.

Behavioral port of the contigger module (reference:
src/contigger/contig_extender.cpp): contigs come from unique
unbranching paths, extended into flanking repeats by the longest
spanning read alignment (:61-260 generateContigs), with the
stats table (:300+) and scaffold connections via DFS through repeat
edges reaching exactly one unique edge (:389-460).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from flye_tpu_torch.io.fasta import reverse_complement, write_fasta
from flye_tpu_torch.io.seqstore import SeqId
from flye_tpu_torch.repeat.graph import RepeatGraph
from flye_tpu_torch.repeat.output import (output_dot, output_gfa,
                                          path_sequence, paths_fasta)
from flye_tpu_torch.repeat.processing import (UnbranchingPath,
                                              get_unbranching_paths)

logger = logging.getLogger("flye_tpu_torch")

_EMPTY = np.zeros(0, dtype=np.uint8)


@dataclass
class ContigInfo:
    name: str
    sequence: np.ndarray
    length: int
    coverage: int
    circular: bool
    repetitive: bool
    multiplicity: int
    alt_group: int
    graph_path: str


def generate_contigs(graph: RepeatGraph, aligner, cfg,
                     out_dir: Optional[str] = None
                     ) -> Tuple[List[ContigInfo], List[Tuple[str, str]]]:
    """Returns (contigs, scaffold_links)."""
    paths = get_unbranching_paths(graph)
    mean_cov = max(1, int(np.median(
        [p.mean_coverage for p in paths])) if paths else 1)

    extender = _RepeatExtender(graph, aligner, cfg, paths)

    contigs: List[ContigInfo] = []
    emitted: Set[int] = set()
    idx = 1
    for p in paths:
        if p.repetitive:
            continue
        comp_id = graph.complement_edge(p.path[-1]).edge_id
        if p.id in emitted or comp_id in emitted:
            continue
        emitted.add(p.id)
        core = path_sequence(graph, p)
        if len(core) == 0:
            continue
        left_edges, left_seq, right_edges, right_seq = \
            extender.extend_both(p)
        seq = np.concatenate([left_seq, core, right_seq]) \
            if (len(left_seq) or len(right_seq)) else core
        mult = 1
        alt = next((e.alt_group_id for e in p.path
                    if e.alt_haplotype), -1)
        contigs.append(ContigInfo(
            name=f"contig_{idx}",
            sequence=seq,
            length=len(seq),
            coverage=p.mean_coverage,
            circular=p.circular,
            repetitive=p.repetitive,
            multiplicity=mult,
            alt_group=alt,
            graph_path=_edges_str(left_edges + list(p.path) +
                                  right_edges),
        ))
        idx += 1

    # repetitive paths not absorbed by any extension become their own
    # contigs (reference: contig_extender.cpp:246-260)
    for p in paths:
        if not p.repetitive:
            continue
        comp_id = graph.complement_edge(p.path[-1]).edge_id
        if p.id in emitted or comp_id in emitted:
            continue
        if any(e.edge_id in extender.covered_repeats for e in p.path):
            continue
        emitted.add(p.id)
        seq = path_sequence(graph, p)
        if len(seq) == 0:
            continue
        mult = max(1, round(p.mean_coverage / mean_cov))
        alt = next((e.alt_group_id for e in p.path
                    if e.alt_haplotype), -1)
        contigs.append(ContigInfo(
            name=f"contig_{idx}",
            sequence=seq,
            length=len(seq),
            coverage=p.mean_coverage,
            circular=p.circular,
            repetitive=True,
            multiplicity=mult,
            alt_group=alt,
            graph_path=_path_str(p),
        ))
        idx += 1

    links = scaffold_connections(graph, paths)

    if out_dir:
        write_fasta([(c.name, c.sequence) for c in contigs],
                    os.path.join(out_dir, "contigs.fasta"))
        write_stats(contigs, os.path.join(out_dir, "contigs_stats.txt"))
        output_gfa(graph, paths, os.path.join(out_dir, "graph_final.gfa"))
        output_dot(graph, paths, os.path.join(out_dir, "graph_final.gv"))
        paths_fasta(graph, paths,
                    os.path.join(out_dir, "graph_final.fasta"))
        with open(os.path.join(out_dir, "scaffolds_links.txt"), "w") as f:
            for a, b in links:
                f.write(f"{a}\t{b}\n")
    return contigs, links


class _RepeatExtender:
    """Extends unique paths into flanking repeats using the longest
    spanning read (reference: contig_extender.cpp:61-260).  Repeat
    edges get a committed traversal direction so two contigs never
    absorb the same repeat copy in conflicting orientations."""

    def __init__(self, graph, aligner, cfg, paths):
        self.graph = graph
        self.aligner = aligner
        self.cfg = cfg
        self.graph_continue = bool(
            cfg.extend_contigs_with_repeats
            if "extend_contigs_with_repeats" in cfg else 0)
        self.covered_repeats: Set[int] = set()
        self._directions: Dict[int, bool] = {}
        self._edge_to_upath: Dict[int, UnbranchingPath] = {}
        for p in paths:
            for e in p.path:
                self._edge_to_upath[e.edge_id] = p
        self._upath_by_id = {p.id: p for p in paths}
        self._core: Dict[int, np.ndarray] = {
            p.id: path_sequence(graph, p) for p in paths}
        # chains (len > 1) indexed by every edge they touch
        self._aln_index: Dict[int, List] = {}
        for chain in aligner.alignments:
            if len(chain) < 2:
                continue
            for ealn in chain:
                self._aln_index.setdefault(
                    ealn.edge.edge_id, []).append(chain)

    def extend_both(self, upath: UnbranchingPath):
        right_edges, right_seq = self._extend_right(upath)
        comp_id = self.graph.complement_edge(upath.path[-1]).edge_id
        comp = self._upath_by_id.get(comp_id)
        if comp is None:  # self-complement path
            return [], _EMPTY, right_edges, right_seq
        cedges, cseq = self._extend_right(comp)
        left_edges = self.graph.complement_path(cedges)
        left_seq = reverse_complement(cseq) if len(cseq) else _EMPTY
        return left_edges, left_seq, right_edges, right_seq

    def _can_traverse(self, edge) -> bool:
        return self._directions.get(edge.edge_id, True)

    def _extend_right(self, upath: UnbranchingPath):
        last_edge = upath.path[-1]
        if not last_edge.node_right.out_edges:
            return [], _EMPTY
        # longest read alignment continuing right through repeats
        best_ext = 0
        best = None
        for chain in self._aln_index.get(last_edge.edge_id, []):
            for i, ealn in enumerate(chain):
                if ealn.edge is last_edge and i < len(chain) - 1:
                    j = i + 1
                    while (j < len(chain) and
                           chain[j].edge.repetitive and
                           not chain[j].edge.alt_haplotype and
                           self._can_traverse(chain[j].edge)):
                        j += 1
                    if j == i + 1:
                        break
                    aln_len = (chain[j - 1].overlap.cur_end -
                               chain[i + 1].overlap.cur_begin)
                    if aln_len > best_ext:
                        best_ext = aln_len
                        best = chain[i + 1:j]
                    break
        if not best:
            return [], _EMPTY

        ualn = self._as_upath_alignment(best)
        last_upath, last_alns = ualn[-1]
        overhang = (len(self._core[last_upath.id]) -
                    last_alns[-1].overlap.cur_end +
                    last_alns[0].overlap.cur_begin)
        last_incomplete = overhang > self.cfg.max_separation

        for i, (p, alns) in enumerate(ualn):
            # without graph continuation an incompletely-traversed
            # final upath is not claimed
            if (i == len(ualn) - 1 and last_incomplete and
                    not self.graph_continue):
                break
            for a in alns:
                comp_e = self.graph.complement_edge(a.edge)
                self._directions[a.edge.edge_id] = True
                self._directions[comp_e.edge_id] = False
                self.covered_repeats.add(a.edge.edge_id)
                self.covered_repeats.add(comp_e.edge_id)

        if last_incomplete and self.graph_continue:
            ualn = ualn[:-1]
        ext_seq = _EMPTY
        if ualn:
            read_id = best[0].overlap.cur_id
            read_start = ualn[0][1][0].overlap.cur_begin
            read_end = ualn[-1][1][-1].overlap.cur_end
            ext_seq = np.ascontiguousarray(
                self.aligner.reads.get(read_id)[read_start:read_end])
        if last_incomplete and self.graph_continue:
            core = self._core[last_upath.id]
            ext_seq = np.concatenate([ext_seq, core]) if len(core) \
                else ext_seq

        ext_edges = [a.edge for _, alns in ualn for a in alns]
        if last_incomplete and self.graph_continue:
            ext_edges.extend(last_upath.path)
        return ext_edges, ext_seq

    def _as_upath_alignment(self, chain):
        """Group consecutive edge alignments by unbranching path
        (reference: contig_extender.cpp asUpathAlignment)."""
        groups = []
        for ealn in chain:
            p = self._edge_to_upath[ealn.edge.edge_id]
            if groups and groups[-1][0] is p:
                groups[-1][1].append(ealn)
            else:
                groups.append((p, [ealn]))
        return groups


def _path_str(p: UnbranchingPath) -> str:
    return _edges_str(list(p.path))


def _edges_str(edges) -> str:
    out = []
    for e in edges:
        sign = "-" if e.edge_id % 2 else ""
        out.append(f"{sign}{e.edge_id // 2 + 1}")
    return ",".join(out)


def write_stats(contigs: List[ContigInfo], path: str) -> None:
    """(reference: contig_extender outputStatsTable; consumed by
    flye/assembly/scaffolder.py)."""
    with open(path, "w") as f:
        f.write("#seq_name\tlength\tcoverage\tcircular\trepeat\t"
                "mult\talt_group\tgraph_path\n")
        for c in contigs:
            f.write(f"{c.name}\t{c.length}\t{c.coverage}\t"
                    f"{'Y' if c.circular else 'N'}\t"
                    f"{'Y' if c.repetitive else 'N'}\t{c.multiplicity}\t"
                    f"{c.alt_group if c.alt_group >= 0 else '*'}\t"
                    f"{c.graph_path}\n")


def scaffold_connections(graph: RepeatGraph,
                         paths: List[UnbranchingPath]
                         ) -> List[Tuple[str, str]]:
    """Unique paths connected through repeat edges where the DFS from a
    unique path's right end reaches exactly one other unique path
    (reference: contig_extender.cpp:389-460 outputScaffoldConnections)."""
    unique_paths = [p for p in paths if not p.repetitive]
    path_by_first: Dict[int, UnbranchingPath] = {}
    for p in unique_paths:
        path_by_first[p.path[0].edge_id] = p

    links: List[Tuple[str, str]] = []
    seen = set()
    for p in unique_paths:
        # DFS through repetitive edges from the right node
        reached: Set[int] = set()
        stack = [e for e in p.path[-1].node_right.out_edges]
        visited_e = set()
        while stack:
            e = stack.pop()
            if e.edge_id in visited_e:
                continue
            visited_e.add(e.edge_id)
            if not e.repetitive:
                reached.add(e.edge_id)
                continue
            for nxt in e.node_right.out_edges:
                stack.append(nxt)
        if len(reached) == 1:
            target_edge = next(iter(reached))
            target = path_by_first.get(target_edge)
            if target is not None and target is not p:
                key = tuple(sorted((p.id, SeqId(target.id).rc)))
                if key not in seen:
                    seen.add(key)
                    links.append((p.name, target.name))
    return links
