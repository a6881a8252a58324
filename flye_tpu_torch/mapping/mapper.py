"""Read-to-assembly mapper — the minimap2/samtools replacement.

The reference shells out to vendored minimap2 + samtools for every
read->draft mapping (reference: flye/polishing/alignment.py:201-253,
presets map-pb/map-ont) and parses BAM back in
(flye/utils/sam_parser.py).  Here the same overlap engine runs in
"reference mapping" mode — local alignments against an indexed target
set, secondary alignments kept within a score fraction of the best
(the -p 0.5 -N 10 analog, reference: alignment.py:225) — and emits
in-memory per-contig Overlap records directly, no SAM/BAM detour.
Alignments keep ALL chain anchors for downstream window partitioning.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from flye_tpu_torch.index import build_minimizer_index
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.overlap.engine import OverlapEngine
from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.utils import trace

logger = logging.getLogger("flye_tpu_torch")


class ReadMapper:
    """Maps reads onto target sequences (contigs / disjointigs / edges)."""

    def __init__(self, targets: SequenceStore, k: int = 15, w: int = 5,
                 min_aln_length: int = 500, max_jump: int = 1500,
                 secondary_ratio: float = 0.5, max_secondary: int = 10,
                 max_divergence: float = 0.5):
        self.targets = targets
        self.index = build_minimizer_index(targets, k, w)
        self.engine = OverlapEngine(
            targets, self.index,
            max_jump=max_jump,
            min_overlap=min_aln_length,
            max_overhang=0,              # local mapping: no overhang test
            only_max_ext=False,
            max_divergence=max_divergence,
            thin_anchors=False,
        )
        self.secondary_ratio = secondary_ratio
        self.max_secondary = max_secondary

    def map_read(self, reads: SequenceStore, sid: int) -> List[Overlap]:
        """Best + secondary local alignments of one read strand."""
        ovlps = self.engine.get_overlaps(reads, sid, force_local=True)
        if not ovlps:
            return []
        ovlps.sort(key=lambda o: -o.score)
        best = ovlps[0].score
        keep = [o for o in ovlps
                if o.score >= self.secondary_ratio * best]
        return keep[:self.max_secondary + 1]

    def map_all(self, reads: SequenceStore,
                progress_every: int = 0,
                ids=None) -> Dict[int, List[Overlap]]:
        """Map every read (both orientations resolved by the engine's
        strand-aware matches). Returns {target_id: [overlaps with
        cur=target, ext=read]} sorted by target coordinate.

        ids restricts mapping to a read subset (the multi-process
        partition path).  The per-target sort key is a full composite
        so the merged order is identical no matter how the read set was
        partitioned across processes."""
        by_target: Dict[int, List[Overlap]] = {}
        ids = sorted(reads.ids() if ids is None else ids,
                     key=reads.length)
        done = 0
        # 2-deep thread pipeline, same rationale as OverlapStore.prefetch:
        # one batch's device wait overlaps the other's native host work
        from concurrent.futures import ThreadPoolExecutor
        groups = [ids[lo:lo + 512] for lo in range(0, len(ids), 512)]
        ex = ThreadPoolExecutor(max_workers=2)
        futs = []
        gi = 0
        while gi < len(groups) or futs:
            while gi < len(groups) and len(futs) < 2:
                futs.append((groups[gi], ex.submit(
                    trace.carry(self.engine.get_overlaps_batch), reads,
                    groups[gi], True)))
                gi += 1
            group, fut = futs.pop(0)
            res = fut.result()
            for sid, ovlps in res.items():
                if not ovlps:
                    continue
                ovlps.sort(key=lambda o: -o.score)
                best = ovlps[0].score
                keep = [o for o in ovlps
                        if o.score >= self.secondary_ratio * best]
                for ov in keep[:self.max_secondary + 1]:
                    rev = ov.reverse()  # cur=target, ext=read
                    if rev.cur_id % 2 == 1:
                        rev = rev.complement()
                    by_target.setdefault(rev.cur_id, []).append(rev)
            done += len(group)
            if (progress_every and done // progress_every !=
                    (done - len(group)) // progress_every):
                logger.info("mapped %d/%d reads", done, len(ids))
        ex.shutdown()
        sort_by_target(by_target)
        return by_target


def sort_by_target(by_target: Dict[int, List[Overlap]]) -> None:
    """Deterministic per-target alignment order (composite key — the
    arrival order from threaded batches or multi-process merge must not
    leak into downstream bubble branch order)."""
    for tid in by_target:
        by_target[tid].sort(
            key=lambda o: (o.cur_begin, o.ext_id, o.cur_end,
                           o.ext_begin))


def uniform_alignments(alignments: List[Overlap], target_len: int,
                       max_coverage: int, window: int = 100
                       ) -> List[Overlap]:
    """Subsample alignments to cap window coverage, preferring longer
    alignments (behavioral analog of get_uniform_alignments,
    reference: flye/polishing/alignment.py:95-153)."""
    if not alignments:
        return []
    n_windows = max(1, target_len // window)
    cov = np.zeros(n_windows, dtype=np.int64)
    chosen = []
    for ov in sorted(alignments, key=lambda o: -(o.cur_range)):
        lo = min(ov.cur_begin // window, n_windows - 1)
        hi = min(max(lo + 1, ov.cur_end // window), n_windows)
        if (cov[lo:hi] < max_coverage).any():
            chosen.append(ov)
            cov[lo:hi] += 1
    chosen.sort(key=lambda o: o.cur_begin)
    return chosen
