"""Graph output generation: edge sequences, FASTA, GFA, dot.

Behavioral port of OutputGenerator (reference:
src/repeat_graph/output_generator.cpp): path sequences pick, per edge,
the segment whose origin sequence is most frequent along the whole path
— minimizing switches between source disjointigs (:11-68
generatePathSequences); GFA1 with dp:i coverage and L-links (:82-134),
Graphviz dot with repeat coloring (:208).
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from flye_tpu_torch.io.fasta import codes_to_str, write_fasta
from flye_tpu_torch.repeat.graph import GraphEdge, RepeatGraph
from flye_tpu_torch.repeat.processing import UnbranchingPath

logger = logging.getLogger("flye_tpu_torch")


def edge_sequence(graph: RepeatGraph, edge: GraphEdge) -> np.ndarray:
    if not edge.seq_segments:
        return np.zeros(0, dtype=np.uint8)
    seg = edge.seq_segments[0]
    return graph.asm.get_sub(seg.orig_seq_id, seg.start, seg.end)


def path_sequence(graph: RepeatGraph, path: UnbranchingPath) -> np.ndarray:
    """Concatenate one segment per edge, choosing segments so the
    number of distinct source sequences along the path is minimized
    (reference: output_generator.cpp:11-68 generatePathSequences)."""
    seq_id_freq: dict = {}
    for edge in path.path:
        for sid in {seg.orig_seq_id for seg in edge.seq_segments}:
            seq_id_freq[sid] = seq_id_freq.get(sid, 0) + 1
    parts = []
    for edge in path.path:
        if not edge.seq_segments:
            continue
        best = max(edge.seq_segments,
                   key=lambda s: seq_id_freq.get(s.orig_seq_id, 0))
        if best.length <= 0:
            continue
        parts.append(graph.asm.get_sub(best.orig_seq_id, best.start,
                                       best.end))
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts)


def paths_fasta(graph: RepeatGraph, paths: List[UnbranchingPath],
                out_file: str, prefix: str = "edge_") -> None:
    records = []
    for p in paths:
        if p.id % 2 == 1:
            continue
        seq = path_sequence(graph, p)
        if len(seq):
            records.append((f"{prefix}{p.id // 2 + 1}", seq))
    write_fasta(records, out_file)


def output_gfa(graph: RepeatGraph, paths: List[UnbranchingPath],
               out_file: str, prefix: str = "edge_") -> None:
    """(reference: output_generator.cpp:82-134)."""
    by_id = {p.id: p for p in paths}
    with open(out_file, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for p in paths:
            if p.id % 2 == 1 and (p.id ^ 1) in by_id:
                continue
            seq = path_sequence(graph, p)
            f.write(f"S\t{prefix}{p.id // 2 + 1}\t{codes_to_str(seq)}"
                    f"\tdp:i:{p.mean_coverage}\n")
        # links: paths sharing a node connect
        for p1 in paths:
            for p2 in paths:
                if p1.node_right() is not p2.node_left():
                    continue
                n1 = f"{prefix}{p1.id // 2 + 1}"
                s1 = "+" if p1.id % 2 == 0 else "-"
                n2 = f"{prefix}{p2.id // 2 + 1}"
                s2 = "+" if p2.id % 2 == 0 else "-"
                f.write(f"L\t{n1}\t{s1}\t{n2}\t{s2}\t0M\n")


def output_dot(graph: RepeatGraph, paths: List[UnbranchingPath],
               out_file: str) -> None:
    """(reference: output_generator.cpp:208)."""
    with open(out_file, "w") as f:
        f.write("digraph {\nnode [shape = circle, label = \"\"];\n")
        for p in paths:
            color = "red" if p.repetitive else "black"
            label = f"id {p.name}\\l{p.length // 1000}k {p.mean_coverage}x"
            f.write(f'"{p.node_left().node_id}" -> '
                    f'"{p.node_right().node_id}" '
                    f'[label = "{label}", color = "{color}"];\n')
        f.write("}\n")
