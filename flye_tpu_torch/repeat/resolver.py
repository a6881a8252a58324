"""Repeat classification and resolution by read bridging.

Behavioral port of RepeatResolver
(reference: src/repeat_graph/repeat_resolver.cpp): repeat marking from
coverage / structure / read alignments including the read-extension
voting pass (:190-531 findRepeats + checkByReadExtension +
checkForTandemCopies + maskUnsupportedEdges), read-spanned connections
between unique edges (:615-800 getConnections), max-weight matching on
the transition graph with support confidence >= min_repeat_res_support
(:22-170 resolveConnections; an exact general max-weight matching,
`utils/matching.py`, replaces lemon), path separation splicing the
median spanning read's sequence as a new edge (:963 separatePath),
removal of fully-resolved repeat subgraphs (:719 clearResolvedRepeats)
and finalizeGraph (:533-571).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from flye_tpu_torch.io.seqstore import SeqId
from flye_tpu_torch.repeat.graph import (EdgeSequence, GraphEdge,
                                         GraphNode, RepeatGraph)
from flye_tpu_torch.repeat.processing import get_unbranching_paths
from flye_tpu_torch.utils.ds import DisjointSet
from flye_tpu_torch.utils.matching import (add_weighted_edge,
                                           max_weight_matching)

logger = logging.getLogger("flye_tpu_torch")

_MAGIC_100 = 100
_MIN_RELIABLE_LOOP = 5000
_TANDEM_NEEDED_READS = 5


@dataclass
class Connection:
    path: List[GraphEdge]          # [unique_in, repeats..., unique_out]
    read_id: int
    read_start: int
    read_end: int


def _node_degree(node: GraphNode) -> Tuple[int, int]:
    n_in = sum(1 for e in node.in_edges if not e.is_looped)
    n_out = sum(1 for e in node.out_edges if not e.is_looped)
    return n_in, n_out


def _is_resolved_node(node: GraphNode) -> bool:
    """1-in-1-out ignoring loops (reference: repeat_graph.h:209-222)."""
    n_in, n_out = _node_degree(node)
    return n_in == 1 and n_out == 1


class RepeatResolver:
    def __init__(self, graph: RepeatGraph, reads, aligner, cfg, inferer):
        self.graph = graph
        self.reads = reads
        self.aligner = aligner
        self.cfg = cfg
        self.inferer = inferer
        # coverage taken out of repeat edges by separatePath; applied to
        # the graph only in finalize_graph (reference:
        # repeat_resolver.cpp:546-571 + _substractedCoverage)
        self._subtracted: Dict[int, int] = {}

    @property
    def _uneven(self) -> bool:
        return bool("uneven_coverage" in self.cfg and
                    self.cfg.uneven_coverage)

    # ------------------------------------------------------------------
    # repeat classification
    # ------------------------------------------------------------------

    def _make_alignment_index(self) -> Dict[int, List[List]]:
        """edge_id -> alignment chains traversing that edge
        (reference: read_aligner makeAlignmentIndex)."""
        index: Dict[int, List[List]] = {}
        for chain in self.aligner.alignments:
            seen = set()
            for a in chain:
                if a.edge.edge_id not in seen:
                    seen.add(a.edge.edge_id)
                    index.setdefault(a.edge.edge_id, []).append(chain)
        return index

    def _mask_unsupported_edges(self) -> int:
        """Mark low-coverage paths repetitive
        (reference: repeat_resolver.cpp:283-331 maskUnsupportedEdges)."""
        min_cutoff = int(round(self.cfg.min_read_cov_cutoff))
        if not self._uneven:
            threshold = max(min_cutoff, int(round(
                self.inferer.mean_coverage / self.cfg.graph_cov_drop_rate)))
        else:
            threshold = min_cutoff
        logger.debug("Read coverage cutoff: %d", threshold)
        n_masked = 0
        for path in get_unbranching_paths(self.graph):
            if path.mean_coverage < threshold:
                logger.debug("Low-coverage: %s %d", path.edges_str(),
                             path.mean_coverage)
                for edge in path.path:
                    edge.repetitive = True
                    self.graph.complement_edge(edge).repetitive = True
                n_masked += 1
        return n_masked

    def _check_for_tandem_copies(self, edge: GraphEdge,
                                 alignments: List[List]) -> bool:
        """>=5 reads containing >=2 interior copies of the edge
        (reference: repeat_resolver.cpp:172-188)."""
        evidence = 0
        for aln in alignments:
            copies = sum(1 for a in aln[1:-1] if a.edge is edge)
            if copies > 1:
                evidence += 1
        return evidence >= _TANDEM_NEEDED_READS

    def _check_by_read_extension(self, check_edge: GraphEdge,
                                 alignments: List[List]) -> bool:
        """Vote on distinct unique-edge extensions past check_edge; >1
        well-supported out-path means the edge is repetitive
        (reference: repeat_resolver.cpp:190-281)."""
        out_flanks: Dict[int, List[int]] = {}
        check_rc = int(SeqId(check_edge.edge_id).rc)
        for aln in alignments:
            passed_start = False
            left_flank = 0
            for a in aln:
                if not passed_start and a.edge is check_edge:
                    passed_start = True
                    left_flank = (a.overlap.cur_end -
                                  aln[0].overlap.cur_begin)
                    continue
                if passed_start and not a.edge.repetitive:
                    if (a.edge.edge_id != check_edge.edge_id and
                            a.edge.edge_id != check_rc):
                        right_flank = (aln[-1].overlap.cur_end -
                                       a.overlap.cur_begin)
                        out_flanks.setdefault(a.edge.edge_id, []).append(
                            min(left_flank, right_flank))
                    break
        if not out_flanks:
            return False
        max_support = max(len(v) for v in out_flanks.values())
        min_support = max_support // int(self.cfg.out_paths_ratio)
        if max_support > 1:
            min_support = max(min_support, 1)
        unique_mult = sum(1 for v in out_flanks.values()
                          if len(v) > min_support)
        return unique_mult > 1

    def find_repeats(self) -> None:
        """(reference: repeat_resolver.cpp:334-531 findRepeats)."""
        aln_index = self._make_alignment_index()
        for edge in self.graph.iter_edges():
            edge.repetitive = False
        self._mask_unsupported_edges()

        paths = get_unbranching_paths(self.graph)

        def mark(path_edges: List[GraphEdge]) -> None:
            for e in path_edges:
                e.repetitive = True
                self.graph.complement_edge(e).repetitive = True

        # simple conditions first (coverage / structure)
        done = set()
        for path in paths:
            if path.path[0].edge_id in done:
                continue
            for e in path.path:
                done.add(e.edge_id)
                done.add(self.graph.complement_edge(e).edge_id)
            if (not self._uneven and path.mean_coverage >
                    self.inferer.unique_cov_threshold):
                mark(path.path)
                logger.debug("High-cov: %s %d %d", path.edges_str(),
                             path.length, path.mean_coverage)
            if (path.node_left() is path.node_right() and
                    path.length < _MIN_RELIABLE_LOOP):
                mark(path.path)
                logger.debug("Short-loop: %s", path.edges_str())
            if any(e.self_complement for e in path.path):
                mark(path.path)
                logger.debug("Self-compl: %s", path.edges_str())
            if any(e.alt_haplotype for e in path.path):
                mark(path.path)
                logger.debug("Haplo-edge: %s", path.edges_str())
            for e in path.path:
                if (not e.repetitive and self._check_for_tandem_copies(
                        e, aln_index.get(e.edge_id, []))):
                    mark(path.path)
                    logger.debug("Tandem: %s", path.edges_str())
                    break

        # read-extension voting, short paths first; two passes in meta
        # mode so mosaic-repeat members detected late still propagate
        sorted_paths = sorted(paths, key=lambda p: p.length)
        n_iters = 2 if self._uneven else 1
        for it in range(n_iters):
            done = set()
            for path in sorted_paths:
                if path.path[0].edge_id in done:
                    continue
                for e in path.path:
                    done.add(e.edge_id)
                    done.add(self.graph.complement_edge(e).edge_id)
                if path.path[0].repetitive:
                    continue
                right_edge = path.path[-1]
                left_edge = self.graph.complement_edge(path.path[0])
                right_rep = self._check_by_read_extension(
                    right_edge, aln_index.get(right_edge.edge_id, []))
                left_rep = self._check_by_read_extension(
                    left_edge, aln_index.get(left_edge.edge_id, []))
                if right_rep or left_rep:
                    mark(path.path)
                    logger.debug("Mult: %s %d %d (%d,%d)",
                                 path.edges_str(), path.length,
                                 path.mean_coverage, left_rep, right_rep)

        # propagate repetitiveness through 1-in-1-out chains and
        # haplotype links (reference: repeat_resolver.cpp:487-531)
        for edge in self.graph.iter_edges():
            if not edge.repetitive:
                continue
            cur = edge
            while True:
                cur.repetitive = True
                node = cur.node_right
                if (len(node.in_edges) == 1 and len(node.out_edges) == 1
                        and not node.out_edges[0].repetitive):
                    cur = node.out_edges[0]
                elif cur.right_link is not None and \
                        not cur.right_link.repetitive:
                    cur = cur.right_link
                else:
                    break
            cur = edge
            while True:
                cur.repetitive = True
                node = cur.node_left
                if (len(node.in_edges) == 1 and len(node.out_edges) == 1
                        and not node.in_edges[0].repetitive):
                    cur = node.in_edges[0]
                elif cur.left_link is not None and \
                        not cur.left_link.repetitive:
                    cur = cur.left_link
                else:
                    break

        n_rep = sum(1 for e in self.graph.iter_edges() if e.repetitive)
        logger.debug("Repetitive edges: %d / %d", n_rep,
                     len(self.graph.edges))

    # ------------------------------------------------------------------
    # connections
    # ------------------------------------------------------------------

    def get_connections(self) -> List[Connection]:
        """(reference: repeat_resolver.cpp:615-800)."""
        def safe(edge: GraphEdge) -> bool:
            return not edge.repetitive

        connections: List[Connection] = []
        for chain in self.aligner.alignments:
            current: List = []
            read_start = 0
            for aln in chain:
                if not current:
                    if not safe(aln.edge):
                        continue
                    read_start = (aln.overlap.cur_end +
                                  aln.overlap.ext_len - aln.overlap.ext_end)
                    read_start = min(read_start,
                                     aln.overlap.cur_len - _MAGIC_100)
                current.append(aln)
                if safe(aln.edge) and current[0].edge is not aln.edge:
                    reliable = True
                    if (not current[0].edge.node_right.is_bifurcation or
                            not current[-1].edge.node_left.is_bifurcation):
                        reliable = False
                    if current[0].edge.resolved and current[-1].edge.resolved:
                        reliable = False
                    if (current[0].edge.right_link or
                            current[-1].edge.left_link):
                        reliable = False
                    if not reliable:
                        current = [aln]
                        read_start = (aln.overlap.cur_end +
                                      aln.overlap.ext_len -
                                      aln.overlap.ext_end)
                        read_start = min(read_start,
                                         aln.overlap.cur_len - _MAGIC_100)
                        continue
                    read_end = aln.overlap.cur_begin - aln.overlap.ext_begin
                    read_end = max(read_start + _MAGIC_100 - 1, read_end)
                    if read_start < 0 or read_end >= aln.overlap.cur_len:
                        logger.debug("bad bridging read coordinates")
                        break
                    connections.append(Connection(
                        [a.edge for a in current],
                        aln.overlap.cur_id, read_start, read_end))
                    current = [aln]
                    read_start = (aln.overlap.cur_end +
                                  aln.overlap.ext_len - aln.overlap.ext_end)
                    read_start = min(read_start,
                                     aln.overlap.cur_len - _MAGIC_100)
        logger.debug("Extracted %d read connections", len(connections))
        return connections

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------

    def resolve_repeats(self) -> int:
        """(reference: repeat_resolver.cpp:596-614 resolveRepeats)."""
        connections = self.get_connections()
        resolved = self.resolve_connections(
            connections, self.cfg.min_repeat_res_support)
        self.clear_resolved_repeats()
        from flye_tpu_torch.repeat.processing import fix_chimeric_junctions
        fix_chimeric_junctions(self.graph)
        self.aligner.update_alignments()
        return resolved

    def resolve_connections(self, connections: List[Connection],
                            min_support: float) -> int:
        """(reference: repeat_resolver.cpp:22-170)."""
        if not connections:
            return 0
        left_cov: Dict[int, int] = {}
        right_cov: Dict[int, int] = {}
        weights: Dict[Tuple[int, int], int] = {}
        for conn in connections:
            left = conn.path[0].edge_id
            right_rc = SeqId(conn.path[-1].edge_id).rc
            if (conn.path[0].edge_id == conn.path[-1].edge_id or
                    conn.path[0].edge_id == right_rc):
                continue
            left_cov[left] = left_cov.get(left, 0) + 1
            right_cov[right_rc] = right_cov.get(right_rc, 0) + 1
            key = (left, int(right_rc))
            weights[key] = weights.get(key, 0) + 1

        G: Dict[int, Dict[int, int]] = {}
        for (a, b), wt in weights.items():
            add_weighted_edge(G, a, b, wt)
        matching = max_weight_matching(G)

        used = set()
        unique_conns: List[Connection] = []
        unresolved = 0
        for a, b in sorted((tuple(sorted(m)) for m in matching)):
            for left, right in ((a, b), (b, a)):
                if left in used:
                    continue
                support = G[left][right]
                conf = support / max(
                    1, left_cov.get(left, 0) + right_cov.get(right, 0))
                logger.debug("Connection %d %d support %d conf %.2f",
                             left, right, support, conf)
                if conf < min_support:
                    unresolved += 1
                    continue
                used.add(left)
                used.add(right)
                spanning = [
                    c for c in connections
                    if (c.path[0].edge_id == left and
                        SeqId(c.path[-1].edge_id).rc == right) or
                       (c.path[0].edge_id == right and
                        SeqId(c.path[-1].edge_id).rc == left)]
                if not spanning:
                    continue
                spanning.sort(key=lambda c: c.read_end - c.read_start)
                unique_conns.append(spanning[len(spanning) // 2])
                break

        for conn in unique_conns:
            self._separate_connection(conn)
        logger.debug("[SIMPL] Resolved repeats: %d", len(unique_conns))
        logger.debug("RR links: %d, unresolved: %d",
                     len(connections) // 2, unresolved)
        return len(unique_conns)

    def _separate_connection(self, conn: Connection) -> None:
        read_codes = self.reads.get(conn.read_id)
        bridge = read_codes[conn.read_start:conn.read_end]
        bid = self.graph.asm.add(
            f"bridge_{self.reads.name(conn.read_id)}_"
            f"{conn.read_start}_{conn.read_end}", np.ascontiguousarray(bridge))
        seg = EdgeSequence(int(bid), len(bridge), 0, len(bridge))

        comp_path = self.graph.complement_path(conn.path)
        new_id = self.graph._next_edge_id
        self._separate_path(conn.path, seg, new_id)
        if comp_path[0] is not conn.path[0]:  # not palindromic
            self._separate_path(comp_path, seg.complement(),
                                int(SeqId(new_id).rc))

    def _separate_path(self, path: List[GraphEdge], seg: EdgeSequence,
                       new_id: int) -> None:
        """Splice the bridging read sequence through a repeat path
        (reference: repeat_resolver.cpp:963-997 separatePath)."""
        left_node = self.graph.add_node()
        path[0].node_right.in_edges.remove(path[0])
        path[0].node_right = left_node
        left_node.in_edges.append(path[0])
        path_coverage = (path[0].mean_coverage +
                         path[-1].mean_coverage) // 2
        for mid in path[1:-1]:
            mid.resolved = True
            self._subtracted[mid.edge_id] = (
                self._subtracted.get(mid.edge_id, 0) + path_coverage)

        right_node = left_node
        if len(path) > 2:
            right_node = self.graph.add_node()
            bridge_edge = GraphEdge(left_node, right_node, new_id)
            bridge_edge.seq_segments.append(seg)
            bridge_edge.mean_coverage = path_coverage
            self.graph.add_edge(bridge_edge)

        path[-1].node_left.out_edges.remove(path[-1])
        path[-1].node_left = right_node
        right_node.out_edges.append(path[-1])

    def resolve_simple_repeats(self) -> int:
        """Split a multi-in/multi-out unbranching repeat path when reads
        pair up its entrances and exits one-to-one
        (reference: repeat_resolver.cpp:801-957 resolveSimpleRepeats)."""
        min_jct_support = 1
        aln_index = self._make_alignment_index()
        paths = get_unbranching_paths(self.graph)
        resolved = []
        done = set()
        for path in paths:
            if path.path[0].edge_id in done:
                continue
            for e in path.path:
                done.add(e.edge_id)
                done.add(self.graph.complement_edge(e).edge_id)
            if path.path[0].self_complement:
                continue
            nl, nr = path.node_left(), path.node_right()
            inputs = list(dict.fromkeys(nl.in_edges))
            outputs = list(dict.fromkeys(nr.out_edges))
            if (len(nl.out_edges) != 1 or len(nr.in_edges) != 1 or
                    len(inputs) != len(outputs) or len(inputs) <= 1):
                continue
            out_set = {id(e) for e in outputs}

            support: Dict[Tuple[int, int], int] = {}
            bridging: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
            for in_edge in inputs:
                for aln in aln_index.get(in_edge.edge_id, []):
                    for i, a in enumerate(aln):
                        if a.edge is not in_edge:
                            continue
                        for j in range(i + 1, len(aln)):
                            if id(aln[j].edge) in out_set:
                                key = (in_edge.edge_id,
                                       aln[j].edge.edge_id)
                                support[key] = support.get(key, 0) + 1
                                bridging[key] = (
                                    aln[i].overlap.cur_id,
                                    aln[i].overlap.cur_end,
                                    aln[j].overlap.cur_begin)
                                break

            ds = DisjointSet()
            for e in inputs:
                ds.add(("in", e.edge_id))
            for e in outputs:
                ds.add(("out", e.edge_id))
            for (iid, oid), cnt in support.items():
                if cnt >= min_jct_support:
                    ds.union(("in", iid), ("out", oid))
            by_edge_in = {e.edge_id: e for e in inputs}
            by_edge_out = {e.edge_id: e for e in outputs}
            for _root, members in sorted(ds.groups().items(),
                                         key=lambda kv: str(kv[0])):
                if len(members) != 2:
                    continue
                kinds = sorted(members)  # ("in", x) < ("out", y)
                if kinds[0][0] != "in" or kinds[1][0] != "out":
                    continue
                in_e = by_edge_in[kinds[0][1]]
                out_e = by_edge_out[kinds[1][1]]
                br = bridging.get((in_e.edge_id, out_e.edge_id))
                if br is None:
                    continue
                conn_path = [in_e] + list(path.path) + [out_e]
                resolved.append((conn_path, br))

        for conn_path, (read_id, start, end) in resolved:
            end = max(start + 1, end)
            conn = Connection(conn_path, read_id, start, end)
            self._separate_connection(conn)
        if resolved:
            logger.debug("[SIMPL] Resolved %d simple repeats",
                         len(resolved))
        self.aligner.update_alignments()
        return len(resolved)

    def clear_resolved_repeats(self) -> None:
        """Remove repeat subgraphs whose every edge got resolved
        (reference: repeat_resolver.cpp:719-796)."""
        def next_edge(node: GraphNode):
            for e in node.out_edges:
                if not e.is_looped:
                    return e
            return None

        to_remove = set()
        for node in list(self.graph.nodes):
            if node.node_id in to_remove:
                continue
            if not node.neighbors():
                if node.out_edges and all(e.resolved
                                          for e in node.out_edges):
                    to_remove.add(node.node_id)
                continue
            if not node.is_end:
                continue
            direction = next_edge(node)
            if direction is None:
                continue
            traversed = [direction]
            cur_node = direction.node_right
            while _is_resolved_node(cur_node):
                nxt = next_edge(cur_node)
                if nxt is None:
                    break
                traversed.append(nxt)
                cur_node = nxt.node_right
            remove_last = cur_node.is_end
            if not all(e.resolved for e in traversed):
                continue
            comp_path = self.graph.complement_path(traversed)
            to_remove.add(traversed[0].node_left.node_id)
            if remove_last:
                to_remove.add(comp_path[0].node_left.node_id)
            for i in range(len(traversed) - 1):
                to_remove.add(traversed[i].node_right.node_id)
                to_remove.add(comp_path[i].node_right.node_id)
            if remove_last:
                to_remove.add(traversed[-1].node_right.node_id)
            to_remove.add(comp_path[-1].node_right.node_id)

        by_id = {n.node_id: n for n in self.graph.nodes}
        for nid in sorted(to_remove):
            node = by_id.get(nid)
            if node is not None:
                self.graph.remove_node(node)
        if to_remove:
            logger.debug("[SIMPL] Cleared %d resolved-repeat nodes",
                         len(to_remove))
        self.aligner.update_alignments()

    def finalize_graph(self) -> None:
        """Un-mark long repetitive paths and apply deferred coverage
        subtractions (reference: repeat_resolver.cpp:533-571)."""
        paths = get_unbranching_paths(self.graph)
        for path in paths:
            high_cov = (path.mean_coverage >
                        self.inferer.unique_cov_threshold)
            if (not path.path[0].self_complement and
                    path.path[0].repetitive and
                    path.length > int(self.cfg.unique_edge_length) and
                    (self._uneven or not high_cov)):
                for edge in path.path:
                    edge.repetitive = False
                    self.graph.complement_edge(edge).repetitive = False
                logger.debug("Fixed: %s %d %d", path.edges_str(),
                             path.length, path.mean_coverage)
        for path in paths:
            if path.node_left() is path.node_right():
                continue
            for edge in path.path:
                edge.mean_coverage = max(
                    0, edge.mean_coverage -
                    self._subtracted.get(edge.edge_id, 0))
