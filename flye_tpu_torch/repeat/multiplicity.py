"""Edge coverage estimation and coverage-driven simplification.

Behavioral port of MultiplicityInferer essentials
(reference: src/repeat_graph/multiplicity_inferer.cpp): window-based
coverage from read-graph alignments (:14-90), the unique-coverage
threshold (repeat_edge_cov_mult x Q75), unsupported-edge removal (:188)
the tip-trimming loop (:524 trimTipsIteration), and weak-fork
detachment (:92 resolveForks, meta mode).

Also ports splitNodes (:313, read-connectivity node splitting for
chimeric junctions) and disconnectMinorPaths (:235, meta mode).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from flye_tpu_torch.repeat.graph import RepeatGraph
from flye_tpu_torch.repeat.processing import get_unbranching_paths

logger = logging.getLogger("flye_tpu_torch")


def _is_right_terminal(edge) -> bool:
    """True if nothing (but loops) continues right of this edge
    (reference: repeat_graph.cpp:51-58 isRightTerminal)."""
    return all(e.is_looped for e in edge.node_right.out_edges)


def _switch_node(edge, new_node, is_input: bool) -> None:
    """Re-home one endpoint of an edge onto new_node
    (reference: multiplicity_inferer.cpp:404-421 switchNode)."""
    if is_input:
        edge.node_right.in_edges.remove(edge)
        edge.node_right = new_node
        new_node.in_edges.append(edge)
    else:
        edge.node_left.out_edges.remove(edge)
        edge.node_left = new_node
        new_node.out_edges.append(edge)


class MultiplicityInferer:
    def __init__(self, graph: RepeatGraph, aligner, cfg):
        self.graph = graph
        self.aligner = aligner
        self.cfg = cfg
        self.mean_coverage = 1
        self.unique_cov_threshold = 2.0

    def estimate_coverage(self) -> None:
        """(reference: multiplicity_inferer.cpp:14-90)."""
        window = self.cfg.coverage_estimate_window
        wnd_cov: Dict[int, np.ndarray] = {}
        for edge in self.graph.iter_edges():
            n = edge.length() // window
            wnd_cov[edge.edge_id] = np.zeros(max(0, n), dtype=np.int64)

        for chain in self.aligner.alignments:
            for i, aln in enumerate(chain):
                cov = wnd_cov.get(aln.edge.edge_id)
                if cov is None or len(cov) == 0:
                    continue
                lo = max(0, aln.overlap.ext_begin // window + 1)
                hi = min(len(cov), aln.overlap.ext_end // window)
                if i > 0:
                    lo = 0
                if i < len(chain) - 1:
                    hi = len(cov)
                if hi > lo:
                    cov[lo:hi] += 1

        all_cov = np.concatenate(
            [c for c in wnd_cov.values() if len(c)]) if wnd_cov else \
            np.zeros(0)
        self.mean_coverage = (int(all_cov.sum() / len(all_cov))
                              if len(all_cov) else 1)
        logger.info("Mean edge coverage: %d", self.mean_coverage)

        unique_covs = []
        for edge in self.graph.iter_edges():
            cov = wnd_cov[edge.edge_id]
            if len(cov) == 0:
                continue
            comp = self.graph.complement_edge(edge)
            ccov = wnd_cov.get(comp.edge_id, np.zeros(0))
            med = int(np.median(cov))
            cmed = int(np.median(ccov)) if len(ccov) else med
            median_cov = (med + cmed) // 2
            edge.mean_coverage = median_cov
            est_mult = round(median_cov / max(1, self.mean_coverage))
            if est_mult == 1:
                unique_covs.append(median_cov)
            logger.debug("edge %r len:%d cov:%d mult:%.2f", edge,
                         edge.length(), median_cov,
                         median_cov / max(1, self.mean_coverage))

        if unique_covs:
            mult = self.cfg.repeat_edge_cov_mult
            self.unique_cov_threshold = mult * float(
                np.percentile(unique_covs, 75))
        logger.debug("Unique coverage threshold %.1f",
                     self.unique_cov_threshold)

    # ------------------------------------------------------------------

    def remove_unsupported_edges(self, only_tips: bool = True) -> int:
        """Drop unbranching paths with coverage below the read-support
        cutoff (mean / graph_cov_drop_rate, floored at
        min_read_cov_cutoff; just the floor in meta mode)
        (reference: multiplicity_inferer.cpp:188-233)."""
        min_cutoff = int(round(self.cfg.min_read_cov_cutoff))
        if "uneven_coverage" in self.cfg and self.cfg.uneven_coverage:
            threshold = min_cutoff
        else:
            threshold = max(min_cutoff, int(round(
                self.mean_coverage / self.cfg.graph_cov_drop_rate)))
        logger.debug("Read coverage cutoff: %d", threshold)

        to_remove = {}
        removed_paths = 0
        for p in get_unbranching_paths(self.graph):
            if p.id % 2:
                continue
            if only_tips and not _is_right_terminal(p.path[-1]):
                continue
            if p.mean_coverage < threshold:
                removed_paths += 1
                for e in p.path:
                    to_remove[e.edge_id] = e
                    comp = self.graph.complement_edge(e)
                    to_remove[comp.edge_id] = comp
        for edge in to_remove.values():
            if edge.edge_id in self.graph.edges:
                self.graph.remove_edge(edge)
        if removed_paths:
            logger.debug("[SIMPL] Removed %d paths with low coverage",
                         removed_paths)
        self.aligner.update_alignments()
        return len(to_remove) // 2

    def split_nodes(self) -> int:
        """Split nodes whose in/out edges form multiple read-connectivity
        clusters — separates chimeric junctions
        (reference: multiplicity_inferer.cpp:313-445 splitNodes)."""
        min_jct_support = 1
        support: Dict[int, Dict[int, int]] = {}
        for chain in self.aligner.alignments:
            for i in range(len(chain) - 1):
                a, b = chain[i].edge, chain[i + 1].edge
                if a.edge_id == b.edge_id ^ 1:
                    continue
                support.setdefault(a.edge_id, {})
                support[a.edge_id][b.edge_id] = \
                    support[a.edge_id].get(b.edge_id, 0) + 1

        num_split = 0
        used_nodes = set()
        for node in list(self.graph.nodes):
            if len(node.in_edges) < 2 or len(node.out_edges) < 2:
                continue
            if id(node) in used_nodes:
                continue
            comp_node = self.graph.complement_node(node)
            used_nodes.add(id(comp_node))
            self_compl = comp_node is node

            # union-find over (edge_id, is_input) elements
            elems = ([(e.edge_id, True) for e in node.in_edges] +
                     [(e.edge_id, False) for e in node.out_edges])
            parent = {x: x for x in elems}

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            out_ids = {e.edge_id for e in node.out_edges}
            for in_e in node.in_edges:
                for out_id, cnt in support.get(in_e.edge_id, {}).items():
                    if cnt >= min_jct_support and out_id in out_ids:
                        ra = find((in_e.edge_id, True))
                        rb = find((out_id, False))
                        if ra != rb:
                            parent[ra] = rb

            clusters: Dict[tuple, list] = {}
            for x in elems:
                clusters.setdefault(find(x), []).append(x)
            if len(clusters) < 2:
                continue
            num_split += 1
            logger.debug("Splitting node with %d edges into %d clusters",
                         len(elems), len(clusters))
            for cl in clusters.values():
                new_node = self.graph.add_node()
                new_comp = self.graph.add_node()
                for edge_id, is_input in cl:
                    edge = self.graph.edges[edge_id]
                    _switch_node(edge, new_node, is_input)
                    if not self_compl:
                        comp_e = self.graph.complement_edge(edge)
                        _switch_node(comp_e, new_comp, not is_input)
        if num_split:
            logger.debug("[SIMPL] Split %d nodes", num_split)
            self.aligner.update_alignments()
        return num_split

    def disconnect_minor_paths(self) -> int:
        """Detach short paths whose endpoint junctions are dominated by
        much deeper edges (meta mode; reference:
        multiplicity_inferer.cpp:235-306 disconnectMinorPaths)."""
        rate = self.cfg.weak_detach_rate
        max_len = 50000

        def node_degree(node) -> int:
            covs = [e.mean_coverage for e in node.in_edges
                    if not e.is_looped]
            covs += [e.mean_coverage for e in node.out_edges
                     if not e.is_looped]
            if len(covs) < 3:
                return 0
            return int(np.median(covs))

        paths = get_unbranching_paths(self.graph)
        to_remove = set()
        for p in paths:
            if (p.id % 2 or
                    p.node_left() is p.node_right() or
                    p.path[0].self_complement or
                    p.length > max_len):
                continue
            if (not p.node_left().in_edges or
                    not p.node_right().out_edges):
                continue  # already detached or tip
            weak_left = (node_degree(p.node_left()) >
                         p.mean_coverage * rate)
            weak_right = (node_degree(p.node_right()) >
                          p.mean_coverage * rate)
            if weak_left and weak_right:
                to_remove.add(p.id)

        n = 0
        for p in paths:
            if p.id not in to_remove:
                continue
            g = self.graph
            g.disconnect_left(p.path[0])
            g.disconnect_left(g.complement_edge(p.path[-1]))
            g.disconnect_right(p.path[-1])
            g.disconnect_right(g.complement_edge(p.path[0]))
            n += 1
            logger.debug("Fragile path: %s", p.edges_str())
        if n:
            logger.debug("[SIMPL] Disconnected %d minor paths", n)
            self.aligner.update_alignments()
        return n

    def resolve_forks(self) -> int:
        """Detach the weak branch of 1-in-2-out forks when the strong
        branch carries nearly all coverage (meta mode; reference:
        multiplicity_inferer.cpp:92-188 resolveForks)."""
        rate = self.cfg.weak_detach_rate
        detached = 0
        for node in list(self.graph.nodes):
            if len(node.in_edges) != 1 or len(node.out_edges) != 2:
                continue
            in_edge = node.in_edges[0]
            major, minor = sorted(node.out_edges,
                                  key=lambda e: -e.mean_coverage)
            if any(e.self_complement or e.is_looped
                   for e in (in_edge, major, minor)):
                continue
            if minor.mean_coverage * rate > major.mean_coverage:
                continue
            if in_edge.mean_coverage < major.mean_coverage // 2:
                continue
            comp = self.graph.complement_edge(minor)
            minor.node_left.out_edges.remove(minor)
            minor.node_left = self.graph.add_node()
            minor.node_left.out_edges.append(minor)
            if comp is not minor:
                comp.node_right.in_edges.remove(comp)
                comp.node_right = self.graph.add_node()
                comp.node_right.in_edges.append(comp)
            detached += 1
        if detached:
            logger.debug("[SIMPL] Detached %d weak fork branches",
                         detached)
        return detached

    def trim_tips(self) -> int:
        """Iterate tip clipping to a fixpoint
        (reference: multiplicity_inferer.h:34-51)."""
        total = 0
        while True:
            n_short, n_long = self._trim_tips_iteration()
            total += n_short + n_long
            logger.debug("Clipped %d short and %d long tips",
                         n_short, n_long)
            if n_short + n_long == 0:
                break
        return total

    def _trim_tips_iteration(self):
        """(reference: multiplicity_inferer.cpp:524-630)."""
        short_tip = self.cfg.short_tip_length
        long_tip = self.cfg.long_tip_length
        cov_rate = self.cfg.tip_coverage_rate
        len_rate = self.cfg.tip_length_rate

        paths = get_unbranching_paths(self.graph)
        ub_index: Dict[int, object] = {}
        for p in paths:
            for e in p.path:
                ub_index[e.edge_id] = p

        to_remove = set()
        n_short = n_long = 0
        for tip in paths:
            last = tip.path[-1]
            n_in, n_out = last.node_right.degree()
            is_right_terminal = (n_out == 0)
            if not is_right_terminal:
                continue
            if len(tip.node_left().out_edges) == 1:
                continue  # already detached
            if tip.path[0].self_complement:
                continue
            if tip.length < short_tip:
                to_remove.add(tip.id)
                n_short += 1
                continue
            if tip.length > long_tip:
                continue
            node = tip.node_left()
            entrances = []
            for e in node.in_edges:
                p = ub_index[e.edge_id]
                if p.path[-1] is e and (
                        p.length > len_rate * tip.length or
                        len(p.node_left().in_edges) > 0):
                    entrances.append(p)
            exits = []
            for e in node.out_edges:
                p = ub_index[e.edge_id]
                if p.path[0] is e and p is not tip and (
                        p.length > len_rate * tip.length or
                        len(p.node_right().out_edges) > 0):
                    exits.append(p)
            if len(entrances) != 1 or len(exits) != 1:
                continue
            true_cov = max(entrances[0].mean_coverage,
                           exits[0].mean_coverage)
            true_len = max(entrances[0].length, exits[0].length)
            if (true_cov > cov_rate * tip.mean_coverage or
                    true_len > len_rate * tip.length):
                to_remove.add(tip.id)
                n_long += 1

        for p in paths:
            if p.id not in to_remove:
                continue
            target = p.path[0]
            comp = self.graph.complement_edge(target)
            # detach the tip into its own fresh node (not deleted — it
            # may carry real sequence)
            target.node_left.out_edges.remove(target)
            target.node_left = self.graph.add_node()
            target.node_left.out_edges.append(target)
            if comp is not target:
                comp.node_right.in_edges.remove(comp)
                comp.node_right = self.graph.add_node()
                comp.node_right.in_edges.append(comp)
        return n_short, n_long
