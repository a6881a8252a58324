"""Short circular plasmid recovery.

Port of `flye_tpu/plasmids/plasmids.py`, itself a behavioral port of
the short-plasmids stage
(reference: flye/short_plasmids/plasmids.py:20-126,
circular_sequences.py:17-119, unmapped_reads.py): reads that do not map
to the assembly are self-overlapped; a read whose prefix aligns to its
own suffix is circular; circular sequences are trimmed to one circle,
deduplicated by cross-mapping, polished, and appended as plasmid
contigs.  The mapper/overlap engine replaces minimap2's PAF pipelines.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from flye_tpu_torch.index import build_minimizer_index
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.mapping.mapper import ReadMapper
from flye_tpu_torch.overlap.engine import OverlapEngine
from flye_tpu_torch.polishing.polisher import polish

logger = logging.getLogger("flye_tpu_torch")

_MIN_PLASMID = 1000
_MAX_OVERHANG = 300


def find_unmapped_reads(reads: SequenceStore, contigs: SequenceStore,
                        mapping_rate: float = 0.5) -> List[int]:
    """Reads with less than mapping_rate of their length aligned
    (reference: flye/short_plasmids/unmapped_reads.py)."""
    if not len(contigs):
        return list(reads.ids())
    mapper = ReadMapper(contigs, min_aln_length=500)
    unmapped = []
    for sid in reads.ids():
        alns = mapper.map_read(reads, sid)
        covered = sum(a.cur_range for a in alns)
        if covered < mapping_rate * reads.length(sid):
            unmapped.append(sid)
    return unmapped


def find_circular_reads(store: SequenceStore, ids: List[int],
                        k: int = 15, w: int = 5) -> List[Tuple[int, int]]:
    """Reads whose start aligns to their own end
    (reference: circular_sequences.py:17-60).

    Returns [(read_id, circle_length)] where codes[:circle_length] is
    one full circle.
    """
    sub = SequenceStore()
    id_map = {}
    for sid in ids:
        new = sub.add(store.name(sid), store.get(sid))
        id_map[int(new)] = sid
    if not len(sub):
        return []
    index = build_minimizer_index(sub, k, w)
    # circularity only needs a short start-to-end self-match
    # (reference: circular_sequences.py uses minimap self-ava hits)
    engine = OverlapEngine(sub, index, max_jump=1500,
                           min_overlap=200, max_overhang=0,
                           only_max_ext=False, max_divergence=0.5)
    circular = []
    for new_id in sub.ids():
        n = sub.length(new_id)
        for ov in engine.get_overlaps(sub, new_id, force_local=True):
            if ov.ext_id != new_id or ov.cur_begin >= ov.ext_begin:
                continue
            # prefix [cur_begin, cur_end] aligns to suffix
            # [ext_begin, ext_end]
            if (ov.cur_begin < _MAX_OVERHANG and
                    n - ov.ext_end < _MAX_OVERHANG and
                    ov.ext_begin - ov.cur_end > -100):
                circle_len = ov.ext_begin - ov.cur_begin
                if circle_len >= _MIN_PLASMID:
                    circular.append((id_map[int(new_id)], circle_len))
                    break
    return circular


def recover_short_plasmids(reads: SequenceStore, contigs: SequenceStore,
                           platform: str,
                           max_plasmids: int = 100
                           ) -> List[Tuple[str, np.ndarray]]:
    """Full plasmid stage: returns [(name, codes)] plasmid contigs."""
    unmapped = find_unmapped_reads(reads, contigs)
    logger.info("Unmapped reads: %d / %d", len(unmapped), len(reads))
    if not unmapped:
        return []
    circular = find_circular_reads(reads, unmapped)
    logger.info("Circular reads: %d", len(circular))
    if not circular:
        return []

    # trim each circular read to one circle; dedup by cross-mapping
    candidates = SequenceStore()
    for sid, circle_len in circular[:max_plasmids * 5]:
        candidates.add(f"plasmid_cand_{len(candidates)}",
                       reads.get(sid)[:circle_len])
    keep: List[int] = []
    if len(candidates) > 1:
        mapper = ReadMapper(candidates, min_aln_length=_MIN_PLASMID)
        redundant = set()
        for sid in candidates.ids():
            if sid in redundant:
                continue
            keep.append(sid)
            for ov in mapper.map_read(candidates, sid):
                tgt = ov.ext_id & ~1
                if tgt != sid and tgt not in set(keep):
                    redundant.add(tgt)
    else:
        keep = list(candidates.ids())

    # polish each plasmid with the unmapped reads
    sub_reads = SequenceStore()
    for sid in unmapped:
        sub_reads.add(reads.name(sid), reads.get(sid))
    drafts = [(f"plasmid_{i + 1}", candidates.get(sid))
              for i, sid in enumerate(keep[:max_plasmids])]
    polished = polish(drafts, sub_reads, platform, num_iters=1)
    out = [(n, s) for n, s in polished if len(s) >= _MIN_PLASMID]
    logger.info("Recovered %d plasmids", len(out))
    return out
