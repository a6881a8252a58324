"""Heterozygous variation masking.

Behavioral port of HaplotypeResolver essentials
(reference: src/repeat_graph/haplotype_resolver.cpp): simple bubbles —
two parallel unbranching paths between a 1-in/2-out and a 2-in/1-out
node pair, branch length <= max_bubble_length (:13-133
findHeterozygousBulges) and heterozygous loops (:139).  BOTH bubble
sides are masked altHaplotype and the flanking edges are linked with a
bridging sequence (the lower-coverage side); collapseHaplotypes (:576)
then reroutes the flanks through a new bridge edge, leaving the masked
branches as separate alternative-haplotype components — sequence is
never deleted.

Meta mode also masks complex variation: roundabouts from read-path
groups (:230-482 findVariantSegment + findRoundabouts) and superbubbles
by a double-Dijkstra reachability check (:694-1119 findSuperbubbles).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from flye_tpu_torch.io.fasta import reverse_complement
from flye_tpu_torch.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_tpu_torch.repeat.processing import get_unbranching_paths

logger = logging.getLogger("flye_tpu_torch")


@dataclass
class VariantPaths:
    start_edge: Optional[GraphEdge] = None
    end_edge: Optional[GraphEdge] = None
    # (chain-as-edge-list, score) branches between start and end
    alt_paths: List[Tuple[List[GraphEdge], int]] = field(
        default_factory=list)
    bridging_seq: Optional[np.ndarray] = None


class HaplotypeResolver:
    def __init__(self, graph: RepeatGraph, cfg, aligner=None, reads=None):
        self.graph = graph
        self.cfg = cfg
        self.aligner = aligner
        self.reads = reads
        self._next_group = 0
        # (in_edge_id, out_edge_id) -> bridging sequence codes
        self._bridging_seqs: Dict[Tuple[int, int], np.ndarray] = {}

    def reset_edges(self) -> None:
        """Clear masking state before re-discovery
        (reference: haplotype_resolver.cpp resetEdges)."""
        for edge in self.graph.iter_edges():
            edge.left_link = None
            edge.right_link = None
            edge.alt_haplotype = False
            edge.alt_group_id = -1
        self._bridging_seqs.clear()

    def _link(self, in_edge: GraphEdge, out_edge: GraphEdge) -> None:
        """(reference: repeat_graph.h linkEdges, both strands)."""
        in_edge.right_link = out_edge
        out_edge.left_link = in_edge
        ci = self.graph.complement_edge(in_edge)
        co = self.graph.complement_edge(out_edge)
        co.right_link = ci
        ci.left_link = co

    def _store_bridge(self, in_edge: GraphEdge, out_edge: GraphEdge,
                      seq: np.ndarray) -> None:
        self._bridging_seqs[(in_edge.edge_id, out_edge.edge_id)] = seq
        ci = self.graph.complement_edge(in_edge)
        co = self.graph.complement_edge(out_edge)
        self._bridging_seqs[(co.edge_id, ci.edge_id)] = \
            reverse_complement(seq)

    def find_heterozygous_bulges(self) -> int:
        """(reference: haplotype_resolver.cpp:13-133)."""
        from flye_tpu_torch.repeat.output import path_sequence
        max_len = self.cfg.max_bubble_length
        paths = get_unbranching_paths(self.graph)
        path_index = {}
        for p in paths:
            for e in p.path:
                path_index[e.edge_id] = p

        used = set()
        n_masked = 0
        for path in paths:
            if path.node_left() is path.node_right():
                continue
            nl, nr = path.node_left(), path.node_right()
            if (len(nl.in_edges) != 1 or len(nl.out_edges) != 2 or
                    len(nr.out_edges) != 1 or len(nr.in_edges) != 2):
                continue
            two = [path_index[e.edge_id] for e in nl.out_edges
                   if path_index[e.edge_id].node_right() is nr]
            if len(two) != 2:
                continue
            if two[0].id == two[1].id ^ 1:
                continue
            if two[0].id in used or two[1].id in used:
                continue
            entrance = path_index[nl.in_edges[0].edge_id]
            exit_p = path_index[nr.out_edges[0].edge_id]
            if entrance.id == exit_p.id ^ 1:
                continue
            if max(two[0].length, two[1].length) > max_len:
                continue
            for p in two:
                used.add(p.id)
                used.add(p.id ^ 1)
            if two[0].mean_coverage > two[1].mean_coverage:
                two = [two[1], two[0]]
            if (not two[0].path[0].alt_haplotype or
                    not two[1].path[0].alt_haplotype):
                n_masked += 1
            for p in two:
                for e in p.path:
                    e.alt_haplotype = True
                    e.alt_group_id = self._next_group
                    ce = self.graph.complement_edge(e)
                    ce.alt_haplotype = True
                    ce.alt_group_id = self._next_group + 1
            self._next_group += 2

            in_edge = entrance.path[-1]
            out_edge = exit_p.path[0]
            if in_edge.right_link or out_edge.left_link:
                continue
            logger.debug("Regular bubble: %r %r", in_edge, out_edge)
            self._link(in_edge, out_edge)
            self._store_bridge(in_edge, out_edge,
                               path_sequence(self.graph, two[0]))
        if n_masked:
            logger.debug("[SIMPL] Masked %d heterozygous bulges", n_masked)
        return n_masked

    def find_heterozygous_loops(self) -> int:
        """Low-coverage self-loop at a 2-in/2-out node: mask it and
        bridge the flanks — removing the loop if its coverage is very
        low, unrolling one copy otherwise
        (reference: haplotype_resolver.cpp:139-216)."""
        from flye_tpu_torch.repeat.output import path_sequence
        cov_mult = self.cfg.loop_coverage_rate
        max_len = self.cfg.max_bubble_length
        paths = get_unbranching_paths(self.graph)
        n_masked = 0
        for loop in paths:
            if loop.id % 2:
                continue
            if loop.node_left() is not loop.node_right():
                continue
            if loop.path[0].self_complement:
                continue
            if loop.length > max_len:
                continue
            node = loop.node_left()
            if len(node.in_edges) != 2 or len(node.out_edges) != 2:
                continue
            entrance = exit_p = None
            for cand in paths:
                if cand.node_right() is node and cand.id != loop.id:
                    entrance = cand
                if cand.node_left() is node and cand.id != loop.id:
                    exit_p = cand
            if entrance is None or exit_p is None:
                continue
            if entrance.node_left() is entrance.node_right():
                continue
            if entrance.id == exit_p.id ^ 1:
                continue
            if loop.mean_coverage > cov_mult * entrance.mean_coverage:
                continue
            if loop.length > max(entrance.length, exit_p.length):
                continue

            if not loop.path[0].alt_haplotype:
                n_masked += 1
            for e in loop.path:
                e.alt_haplotype = True
                e.alt_group_id = self._next_group
                ce = self.graph.complement_edge(e)
                ce.alt_haplotype = True
                ce.alt_group_id = self._next_group + 1
            self._next_group += 2

            in_edge = entrance.path[-1]
            out_edge = exit_p.path[0]
            if in_edge.right_link or out_edge.left_link:
                continue
            logger.debug("Bubble-loop: %r %r", in_edge, out_edge)
            self._link(in_edge, out_edge)
            low_cov = (loop.mean_coverage <
                       (entrance.mean_coverage +
                        exit_p.mean_coverage) / 4)
            seq = (np.zeros(1, np.uint8) if low_cov
                   else path_sequence(self.graph, loop))
            self._store_bridge(in_edge, out_edge, seq)
        if n_masked:
            logger.debug("[SIMPL] Masked %d heterozygous loops", n_masked)
        return n_masked

    # ------------------------------------------------------------------
    # complex variation (meta mode)
    # ------------------------------------------------------------------

    def _make_alignment_index(self) -> Dict[int, List[List]]:
        index: Dict[int, List[List]] = {}
        if self.aligner is None:
            return index
        for chain in self.aligner.alignments:
            seen = set()
            for a in chain:
                if a.edge.edge_id not in seen:
                    seen.add(a.edge.edge_id)
                    index.setdefault(a.edge.edge_id, []).append(chain)
        return index

    def _looped_edge_ids(self) -> set:
        looped = set()
        for p in get_unbranching_paths(self.graph):
            if p.node_left() is p.node_right():
                looped.update(e.edge_id for e in p.path)
        return looped

    def _find_variant_segment(self, start_edge: GraphEdge,
                              alignments: List[List],
                              looped: set) -> VariantPaths:
        """Group read-paths out of start_edge, locate where >=2
        well-supported groups diverge and re-converge
        (reference: haplotype_resolver.cpp:230-482 findVariantSegment)."""
        out_paths = []
        for aln in alignments:
            for i, a in enumerate(aln):
                if a.edge is start_edge and i + 1 < len(aln):
                    out_paths.append(aln[i:])
                    break
        if not out_paths:
            return VariantPaths()
        out_paths.sort(key=lambda p: -(p[-1].overlap.cur_end -
                                       p[0].overlap.cur_end))

        # group by prefix containment; longest path is each group's ref
        min_score = 2
        groups: List[List] = []   # [path, score]
        for trg in out_paths:
            placed = False
            for grp in groups:
                ref = grp[0]
                if all(trg[i].edge is ref[i].edge
                       for i in range(min(len(trg), len(ref)))):
                    grp[1] += 1
                    placed = True
                    break
            if not placed:
                groups.append([trg, 1])
        groups = [g for g in groups if g[1] >= min_score]
        if len(groups) < 2:
            return VariantPaths()

        # edges appearing >1 time inside a group are local repeats
        repeats = set()
        for path, _score in groups:
            seen = set()
            for a in path:
                if a.edge.edge_id in seen:
                    repeats.add(a.edge.edge_id)
                seen.add(a.edge.edge_id)

        ref_path = groups[0][0]
        convergence = {a.edge.edge_id for a in ref_path
                       if a.edge.edge_id not in looped and
                       a.edge.edge_id not in repeats}
        for path, _score in groups[1:]:
            convergence &= {a.edge.edge_id for a in path}

        # bubble start: last edge on which all groups still agree
        bubble_start = 0
        while True:
            agreement = True
            for path, _score in groups[1:]:
                if (bubble_start + 1 >= len(path) or
                        bubble_start + 1 >= len(ref_path) or
                        ref_path[bubble_start + 1].edge.edge_id
                        not in convergence or
                        path[bubble_start + 1].edge is not
                        ref_path[bubble_start + 1].edge):
                    agreement = False
                    break
            if not agreement:
                break
            bubble_start += 1
        if ref_path[bubble_start].edge.edge_id not in convergence:
            return VariantPaths()

        bubble_end = -1
        for i in range(bubble_start + 1, len(ref_path)):
            if ref_path[i].edge.edge_id in convergence:
                bubble_end = i
                break
        if bubble_end < 0:
            return VariantPaths()

        start_e = ref_path[bubble_start].edge
        end_e = ref_path[bubble_end].edge

        # shorten branches to [start_e, end_e], dedup identical ones
        branches: List[Tuple[List[GraphEdge], int]] = []
        for path, score in groups:
            g_start = g_end = 0
            for i, a in enumerate(path):
                if a.edge is start_e:
                    g_start = i
                if a.edge is end_e:
                    g_end = i
            edges = [a.edge for a in path[g_start:g_end + 1]]
            for b_edges, _ in branches:
                if len(b_edges) == len(edges) and all(
                        x is y for x, y in zip(b_edges, edges)):
                    for j, (be, bs) in enumerate(branches):
                        if be is b_edges:
                            branches[j] = (be, bs + score)
                    break
            else:
                branches.append((edges, score))
        if len(branches) < 2:
            return VariantPaths()

        # bridging sequence from the median spanning read
        bridging = []
        for aln in alignments:
            start_pos = end_pos = -1
            for i, a in enumerate(aln):
                if a.edge is start_edge:
                    start_pos = i
                if start_pos != -1 and a.edge is end_e:
                    end_pos = i
                    break
            if start_pos != -1 and end_pos != -1:
                bridging.append(aln[start_pos:end_pos + 1])
        if not bridging:
            logger.warning("No bridging reads for variant segment")
            return VariantPaths()
        bridging.sort(key=lambda c: (c[-1].overlap.cur_begin -
                                     c[0].overlap.cur_end))
        med = bridging[len(bridging) // 2]
        read_start = med[0].overlap.cur_end
        read_end = max(read_start + 99, med[-1].overlap.cur_begin)
        codes = self.reads.get(med[0].overlap.cur_id)
        seq = np.ascontiguousarray(codes[read_start:read_end])
        if not len(seq):
            seq = np.zeros(1, np.uint8)
        return VariantPaths(start_e, end_e, branches, seq)

    def find_roundabouts(self) -> int:
        """Mask complex (>2-branch) heterogeneity revealed by read
        paths (reference: haplotype_resolver.cpp:485-574)."""
        if self.aligner is None or self.reads is None:
            return 0
        aln_index = self._make_alignment_index()
        looped = self._looped_edge_ids()
        paths = get_unbranching_paths(self.graph)

        used = set()
        variants: List[VariantPaths] = []
        for start_path in paths:
            start_edge = start_path.path[-1]
            if start_edge.edge_id in looped or start_edge.edge_id in used:
                continue
            var = self._find_variant_segment(
                start_edge, aln_index.get(start_edge.edge_id, []), looped)
            if (var.start_edge is None or var.end_edge is None or
                    var.start_edge is
                    self.graph.complement_edge(var.end_edge)):
                continue
            rev_start = self.graph.complement_edge(var.end_edge)
            rev = self._find_variant_segment(
                rev_start, aln_index.get(rev_start.edge_id, []), looped)
            if rev.end_edge is self.graph.complement_edge(var.start_edge):
                variants.append(var)
                used.add(rev.start_edge.edge_id)

        found_new = 0
        for var in variants:
            new_variant = True
            for edges, _score in var.alt_paths:
                for e in edges[1:-1]:
                    if e.alt_haplotype:
                        new_variant = False
            if new_variant:
                found_new += 1
                logger.debug("Roundabout: %r : %r", var.start_edge,
                             var.end_edge)
            for edges, _score in var.alt_paths:
                for e in edges[1:-1]:
                    e.alt_haplotype = True
                    e.alt_group_id = self._next_group
                    ce = self.graph.complement_edge(e)
                    ce.alt_haplotype = True
                    ce.alt_group_id = self._next_group + 1
            self._next_group += 2
            if var.start_edge.right_link or var.end_edge.left_link:
                continue
            self._link(var.start_edge, var.end_edge)
            self._store_bridge(var.start_edge, var.end_edge,
                               var.bridging_seq)
        logger.debug("[SIMPL] Masked %d complex haplotypes", found_new)
        return len(variants)

    # -- superbubbles ---------------------------------------------------

    def _any_path(self, start_edge: GraphEdge, max_depth: int,
                  ) -> List[GraphEdge]:
        """DFS for any path of length > max_depth (or the longest
        dead-end path) (reference: haplotype_resolver.cpp:705-747)."""
        dead_ends: List[Tuple[List[GraphEdge], int]] = []
        stack: List[Tuple[List[GraphEdge], int]] = [([start_edge], 0)]
        while stack:
            path, length = stack.pop()
            if length > max_depth:
                return path
            dead_end = True
            for nxt in path[-1].node_right.out_edges:
                if any(e is nxt for e in path):
                    continue
                if nxt.is_looped and nxt.length() < max_depth:
                    continue
                dead_end = False
                stack.append((path + [nxt], length + nxt.length()))
            if dead_end:
                dead_ends.append((path, length))
        if not dead_ends:
            return []
        return max(dead_ends, key=lambda d: d[1])[0]

    def _shortest_paths_len(self, source: GraphEdge, sink: GraphEdge,
                            max_bubble: int
                            ) -> Optional[Dict[int, Tuple[GraphEdge, int]]]:
        """Dijkstra from source; None signals failure: a dead end, a
        cycle back to source, or distance over max_bubble
        (reference: haplotype_resolver.cpp:770-830)."""
        dist: Dict[int, Tuple[GraphEdge, int]] = {
            source.edge_id: (source, 0)}
        heap: List[Tuple[int, int]] = [(0, source.edge_id)]
        edges_by_id = {source.edge_id: source}
        while heap:
            d, eid = heapq.heappop(heap)
            cur = edges_by_id[eid]
            if dist[eid][1] != d:
                continue  # stale entry
            if not cur.node_right.out_edges:
                return None  # dead end inside the bubble
            for nxt in cur.node_right.out_edges:
                if nxt is sink:
                    continue
                if nxt is source:
                    return None  # looped back to source
                new_dist = d + nxt.length() + 1
                prev = dist.get(nxt.edge_id)
                if prev is None or new_dist < prev[1]:
                    if new_dist > max_bubble:
                        return None
                    dist[nxt.edge_id] = (nxt, new_dist)
                    edges_by_id[nxt.edge_id] = nxt
                    if not nxt.is_looped:
                        heapq.heappush(heap, (new_dist, nxt.edge_id))
        del dist[source.edge_id]
        return dist

    def _is_right_superbubble(self, start_edge: GraphEdge,
                              max_len: int, looped: set):
        """(reference: haplotype_resolver.cpp:845-990)."""
        ref_path = self._any_path(start_edge, max_len)
        if not ref_path:
            return None
        for end_cand in ref_path:
            if end_cand is start_edge:
                continue
            if end_cand.edge_id in looped:
                continue
            if not end_cand.node_left.is_bifurcation:
                continue
            d_src = self._shortest_paths_len(start_edge, end_cand, max_len)
            if d_src is None:
                continue
            d_sink = self._shortest_paths_len(
                self.graph.complement_edge(end_cand),
                self.graph.complement_edge(start_edge), max_len)
            if d_sink is None:
                continue
            good = True
            for _eid, (edge, d) in d_src.items():
                comp = self.graph.complement_edge(edge)
                entry = d_sink.get(comp.edge_id)
                if entry is None:
                    good = False
                    break
                if d + entry[1] - comp.length() > max_len:
                    good = False
                    break
            if good:
                for _eid, (edge, _d) in d_sink.items():
                    comp = self.graph.complement_edge(edge)
                    if comp.edge_id not in d_src and comp is not start_edge \
                            and comp is not end_cand:
                        good = False
                        break
            if good:
                internal = [edge for eid, (edge, _d) in d_src.items()
                            if edge is not start_edge and
                            edge is not end_cand]
                return (start_edge, end_cand, internal, ref_path)
        return None

    def find_superbubbles(self) -> int:
        """(reference: haplotype_resolver.cpp:997-1119)."""
        from flye_tpu_torch.repeat.output import edge_sequence
        max_len = int(self.cfg.max_bubble_length)
        looped = self._looped_edge_ids()
        found_new = 0
        used = set()
        for start_edge in self.graph.iter_edges():
            if start_edge.edge_id in looped or start_edge.edge_id in used:
                continue
            n_out = sum(1 for e in start_edge.node_right.out_edges
                        if e.edge_id not in looped)
            if n_out < 2:
                continue
            bubble = self._is_right_superbubble(start_edge, max_len,
                                                looped)
            if bubble is None:
                continue
            start, end, internal, ref_path = bubble
            if (end is start or
                    start is self.graph.complement_edge(end)):
                continue
            used.add(self.graph.complement_edge(end).edge_id)

            if all(not e.alt_haplotype for e in internal):
                found_new += 1
            for e in internal:
                e.alt_haplotype = True
                e.alt_group_id = self._next_group
                ce = self.graph.complement_edge(e)
                ce.alt_haplotype = True
                ce.alt_group_id = self._next_group + 1
            self._next_group += 2

            if start.right_link or end.left_link:
                continue
            self._link(start, end)
            bridge_edges = []
            for e in ref_path[1:]:
                if e is end:
                    break
                bridge_edges.append(e)
            parts = [edge_sequence(self.graph, e) for e in bridge_edges]
            parts = [p for p in parts if len(p)]
            seq = (np.concatenate(parts) if parts
                   else np.zeros(1, np.uint8))
            self._store_bridge(start, end, seq)
            logger.debug("Superbubble: %r %r (%d internal)", start, end,
                         len(internal))
        logger.debug("[SIMPL] Masked %d superbubbles", found_new)
        return found_new

    # ------------------------------------------------------------------

    def collapse_haplotypes(self) -> int:
        """Reroute each linked flank pair through its bridging sequence;
        masked branches stay in the graph as separate alt components
        (reference: haplotype_resolver.cpp:576-631 collapseHaplotypes)."""
        n_bridged = 0
        separated = set()
        for in_edge in self.graph.iter_edges():
            if in_edge.right_link is None:
                continue
            if in_edge.edge_id in separated:
                continue
            out_edge = in_edge.right_link
            if self.graph.edges.get(out_edge.edge_id) is not out_edge:
                logger.warning("Missing linked edge")
                continue
            if out_edge.left_link is not in_edge:
                logger.warning("Broken link")
                continue
            key = (in_edge.edge_id, out_edge.edge_id)
            if key not in self._bridging_seqs:
                logger.warning("No bridging path!")
                continue

            n_bridged += 1
            comp_in = self.graph.complement_edge(out_edge)
            comp_out = self.graph.complement_edge(in_edge)
            separated.add(comp_in.edge_id)

            seq = self._bridging_seqs[key]
            has_comp = (comp_in.edge_id, comp_out.edge_id) != key
            if len(seq) < 10:  # marker for "drop the branch entirely"
                self._separate_adjacent(in_edge, out_edge)
                if has_comp:
                    self._separate_adjacent(comp_in, comp_out)
            else:
                sid = self.graph.asm.add(
                    f"haplotype_bridge_{in_edge.edge_id}_"
                    f"{out_edge.edge_id}", np.ascontiguousarray(seq))
                base_id = self.graph._next_edge_id
                self._separate_distant(in_edge, out_edge, int(sid),
                                       len(seq), base_id)
                if has_comp:
                    self._separate_distant(comp_in, comp_out,
                                           int(sid) ^ 1, len(seq),
                                           base_id + 1)
                self.graph._next_edge_id = base_id + 2
        if n_bridged:
            logger.debug("[SIMPL] Collapsed %d haplotypes", n_bridged)
        return n_bridged

    def _separate_adjacent(self, in_edge: GraphEdge,
                           out_edge: GraphEdge) -> None:
        """(reference: haplotype_resolver.cpp separeteAdjacentEdges)."""
        new_node = self.graph.add_node()
        in_edge.node_right.in_edges.remove(in_edge)
        in_edge.node_right = new_node
        new_node.in_edges.append(in_edge)
        out_edge.node_left.out_edges.remove(out_edge)
        out_edge.node_left = new_node
        new_node.out_edges.append(out_edge)

    def _separate_distant(self, in_edge: GraphEdge, out_edge: GraphEdge,
                          seq_id: int, seq_len: int,
                          new_id: int) -> None:
        """(reference: haplotype_resolver.cpp separateDistantEdges)."""
        left = self.graph.add_node()
        in_edge.node_right.in_edges.remove(in_edge)
        in_edge.node_right = left
        left.in_edges.append(in_edge)
        right = self.graph.add_node()
        bridge = GraphEdge(left, right, new_id)
        bridge.seq_segments.append(
            EdgeSequence(seq_id, seq_len, 0, seq_len))
        bridge.mean_coverage = (in_edge.mean_coverage +
                                out_edge.mean_coverage) // 2
        self.graph.add_edge(bridge)
        out_edge.node_left.out_edges.remove(out_edge)
        out_edge.node_left = right
        right.out_edges.append(out_edge)
