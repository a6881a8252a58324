"""Polished graph-edge sequences for the final assembly GFA.

Behavioral port of generate_polished_edges
(reference: flye/polishing/polish.py:142-207, wired at
flye/main.py:353,368): after contig polishing, each repeat-graph edge
sequence is mapped onto the polished contigs with the in-memory mapper
(the reference shells out to minimap2 in reference mode); the edge's
best-matching polished interval — extended over every co-oriented
alignment to the same contig — replaces the edge sequence when it covers
>90% of the edge.  The final `assembly_graph.gfa` then carries polished
sequence instead of raw consensus.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from flye_tpu_torch.io.fasta import codes_to_str, read_seq_file
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.mapping.mapper import ReadMapper

logger = logging.getLogger("flye_tpu_torch")

_MIN_CONTAINMENT = 0.9  # reference: polish.py:167


def polish_edge_sequences(
        edges: Sequence[Tuple[str, np.ndarray]],
        polished: Sequence[Tuple[str, np.ndarray]],
        min_aln_length: int = 500) -> Dict[str, np.ndarray]:
    """Map each edge onto the polished contigs; return the edges whose
    sequence should be replaced ({edge_name: new_codes})."""
    targets = SequenceStore()
    for name, codes in polished:
        if len(codes):
            targets.add(name, codes)
    edge_store = SequenceStore()
    for name, codes in edges:
        if len(codes):
            edge_store.add(name, codes)
    if not len(targets) or not len(edge_store):
        return {}

    mapper = ReadMapper(targets, min_aln_length=min_aln_length)
    updated: Dict[str, np.ndarray] = {}
    ids = edge_store.ids()
    for lo in range(0, len(ids), 48):
        res = mapper.engine.get_overlaps_batch(
            edge_store, ids[lo:lo + 48], force_local=True)
        for sid, ovlps in res.items():
            if not ovlps:
                continue
            # best alignment anchors the interval; co-oriented secondary
            # alignments to the same contig extend it
            # (reference: polish.py:171-179)
            main = max(ovlps, key=lambda o: o.score)
            start, end = main.ext_begin, main.ext_end
            for o in ovlps:
                if o.ext_id == main.ext_id:
                    start = min(start, o.ext_begin)
                    end = max(end, o.ext_end)
            new_seq = targets.get_sub(main.ext_id, start, end)
            if len(new_seq) / edge_store.length(sid) > _MIN_CONTAINMENT:
                updated[edge_store.name(sid)] = new_seq
    logger.debug("Polished %d/%d graph edge sequences",
                 len(updated), len(edge_store))
    return updated


def generate_polished_gfa(edges_fasta: str, gfa_in: str,
                          polished: Sequence[Tuple[str, np.ndarray]],
                          gfa_out: str) -> int:
    """Rewrite a graph GFA with polished edge sequences
    (reference: polish.py:194-204).  Returns the number of edges whose
    sequence was updated."""
    if not os.path.exists(gfa_in):
        logger.warning("missing %s; skipping polished GFA", gfa_in)
        return 0
    edges = (read_seq_file(edges_fasta)
             if os.path.exists(edges_fasta) else [])
    updated = polish_edge_sequences(edges, polished)
    with open(gfa_in) as f_in, open(gfa_out, "w") as f_out:
        for line in f_in:
            if line.startswith("S"):
                parts = line.rstrip("\n").split("\t")
                seq_id = parts[1]
                if seq_id in updated:
                    parts[2] = codes_to_str(updated[seq_id])
                f_out.write("\t".join(parts) + "\n")
            else:
                f_out.write(line)
    return len(updated)
