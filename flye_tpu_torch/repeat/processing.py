"""Structure-only graph operations.

Behavioral port of GraphProcessor essentials
(reference: src/repeat_graph/graph_processing.cpp): unbranching path
extraction (graph_processing.cpp:305-396) used by simplification,
contigging, and output.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List

from flye_tpu_torch.repeat.graph import GraphEdge, GraphNode, RepeatGraph

logger = logging.getLogger("flye_tpu_torch")


@dataclass
class UnbranchingPath:
    """A maximal chain of edges whose interior nodes are 1-in-1-out
    (reference: graph_processing.h:15-72)."""
    id: int
    path: List[GraphEdge] = field(default_factory=list)
    circular: bool = False

    @property
    def length(self) -> int:
        return sum(e.length() for e in self.path)

    @property
    def mean_coverage(self) -> int:
        total = sum(e.length() * e.mean_coverage for e in self.path)
        return int(total / max(1, self.length))

    @property
    def repetitive(self) -> bool:
        return any(e.repetitive for e in self.path)

    def node_left(self) -> GraphNode:
        return self.path[0].node_left

    def node_right(self) -> GraphNode:
        return self.path[-1].node_right

    @property
    def name(self) -> str:
        sign = "-" if self.id % 2 else "+"
        return f"{sign}{self.id // 2 + 1}"

    def edges_str(self) -> str:
        return ",".join(repr(e) for e in self.path)


def fix_chimeric_junctions(graph: RepeatGraph) -> int:
    """Split junctions created by chimeric reads that contain two
    consecutive reversed copies of the real sequence
    (reference: graph_processing.cpp:32-88 fixChimericJunctions)."""
    # 1-in-1-out where out is the complement of in
    simple = []
    for node in list(graph.nodes):
        if (len(node.in_edges) == 1 and len(node.out_edges) == 1 and
                node.in_edges[0].edge_id ==
                (node.out_edges[0].edge_id ^ 1) and
                not node.in_edges[0].self_complement):
            simple.append(node)
    for node in simple:
        new_node = graph.add_node()
        cut = node.out_edges[0]
        new_node.out_edges.append(cut)
        cut.node_left = new_node
        node.out_edges.clear()

    # 2-in-2-out where each in pairs with its reverse complement out
    complex_cases = []
    for node in list(graph.nodes):
        if len(node.in_edges) != 2 or len(node.out_edges) != 2:
            continue
        ins, outs = node.in_edges, node.out_edges
        if (ins[0].edge_id ^ 1) != outs[0].edge_id:
            ins = [ins[1], ins[0]]
        if ((ins[0].edge_id ^ 1) == outs[0].edge_id and
                (ins[1].edge_id ^ 1) == outs[1].edge_id):
            node.in_edges[:] = ins
            complex_cases.append(node)
    for node in complex_cases:
        new_node = graph.add_node()
        moved_in = node.in_edges[1]
        moved_out = node.out_edges[0]
        moved_in.node_right = new_node
        moved_out.node_left = new_node
        new_node.in_edges.append(moved_in)
        new_node.out_edges.append(moved_out)
        node.in_edges.pop()
        node.out_edges.pop(0)

    if simple or complex_cases:
        logger.debug("Removed %d simple and %d double chimeric junctions",
                     len(simple), len(complex_cases))
    return len(simple) + len(complex_cases)


def get_unbranching_paths(graph: RepeatGraph) -> List[UnbranchingPath]:
    """(reference: graph_processing.cpp:305-396)."""
    visited = set()
    paths: List[UnbranchingPath] = []
    for edge in graph.iter_edges():
        if edge.edge_id in visited:
            continue
        chain = [edge]
        # extend right
        cur = edge
        while True:
            node = cur.node_right
            if (len(node.out_edges) != 1 or len(node.in_edges) != 1):
                break
            nxt = node.out_edges[0]
            if nxt is edge or nxt.edge_id in visited:
                break
            chain.append(nxt)
            cur = nxt
        # extend left
        cur = edge
        while True:
            node = cur.node_left
            if (len(node.out_edges) != 1 or len(node.in_edges) != 1):
                break
            prv = node.in_edges[0]
            if prv is chain[-1] or prv is chain[0] or prv.edge_id in visited:
                break
            chain.insert(0, prv)
            cur = prv
        circular = (chain[0].node_left is chain[-1].node_right and
                    len(chain[0].node_left.out_edges) == 1 and
                    len(chain[-1].node_right.in_edges) == 1)
        path = UnbranchingPath(chain[0].edge_id, chain, circular)
        for e in chain:
            visited.add(e.edge_id)
        # mark the complement path visited too, and emit it explicitly
        comp_chain = graph.complement_path(chain)
        comp_new = any(e.edge_id not in visited for e in comp_chain)
        paths.append(path)
        if comp_new:
            for e in comp_chain:
                visited.add(e.edge_id)
            paths.append(UnbranchingPath(comp_chain[0].edge_id, comp_chain,
                                         circular))
    return paths
