"""Long-read simulator for tests and benchmarks.

The reference ships real PacBio read sets for its toy E2E test
(reference: flye/tests/test_toy.py:21-32); those blobs are not available
here, so tests synthesize reads from the bundled E. coli 500kb reference
sequence with a configurable error profile (insertion-dominated, matching
PacBio CLR / ONT characteristics).  `k1_row_kinds` makes synthetic match
lists for the chain DP (the kernel tests and `chip_smoke.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flye_tpu_torch.io.fasta import COMPLEMENT


def simulate_reads(
    genome: np.ndarray,
    coverage: float = 30.0,
    mean_length: int = 8000,
    min_length: int = 1000,
    error_rate: float = 0.08,
    error_mix: Tuple[float, float, float] = (0.2, 0.5, 0.3),  # sub, ins, del
    circular: bool = True,
    seed: int = 0,
    chimera_rate: float = 0.0,
    adapter_rate: float = 0.0,
    dropout: Optional[Tuple[int, int]] = None,
) -> List[Tuple[str, np.ndarray]]:
    """Sample error-laden reads from a genome (uint8 codes).

    Lengths ~ gamma with the given mean; start positions uniform; strand
    uniform. For circular genomes reads may wrap the origin.

    Adversarial artifacts (off by default; the failure modes the
    chimera detector and bad-mapping trimming exist for — reference:
    src/assemble/chimera.cpp:106-180):
      chimera_rate: fraction of reads fused from two DISTAL genome
        fragments (random strand each) — one artifactual junction per
        chimeric read.
      adapter_rate: fraction of reads with a ~45 bp random adapter
        sequence spliced at a random interior position.
      dropout: (start, end) genome interval that reads never start in
        and never cross beyond min_length into — a coverage hole.
    """
    rng = np.random.default_rng(seed)
    glen = len(genome)
    target = int(coverage * glen)
    reads = []
    total = 0
    i = 0
    sub_p, ins_p, del_p = error_mix
    genome2 = np.concatenate([genome] * 3) if circular else genome
    adapter = rng.integers(0, 4, size=45).astype(np.uint8)

    def sample_fragment(length):
        for _ in range(64):
            start = int(rng.integers(
                0, glen if circular else max(1, glen - length)))
            if dropout is not None:
                d0, d1 = dropout
                end = start + length
                ivals = [(start, min(end, glen))]
                if circular and end > glen:
                    ivals.append((0, end - glen))
                if any(s < d1 and e > d0 for s, e in ivals):
                    continue  # read would touch the coverage hole
            return start, genome2[start:start + length].copy()
        return 0, genome2[0:length].copy()

    while total < target:
        length = int(rng.gamma(4.0, mean_length / 4.0))
        # circular genomes may be read around the origin (up to ~2 circles)
        cap = 2 * glen if circular else glen
        length = max(min_length, min(length, cap))
        start, frag = sample_fragment(length)
        strand = "+"
        if rng.random() < 0.5:
            frag = COMPLEMENT[frag[::-1]]
            strand = "-"
        tag = ""
        if chimera_rate > 0 and rng.random() < chimera_rate:
            # fuse a second, distal fragment: an artifactual junction
            length2 = max(min_length,
                          min(int(rng.gamma(4.0, mean_length / 4.0)),
                              cap))
            _, frag2 = sample_fragment(length2)
            if rng.random() < 0.5:
                frag2 = COMPLEMENT[frag2[::-1]]
            frag = np.concatenate([frag, frag2])
            tag = "_chimera"
        if adapter_rate > 0 and rng.random() < adapter_rate:
            at = int(rng.integers(0, len(frag) + 1))
            frag = np.concatenate([frag[:at], adapter, frag[at:]])
            tag += "_adapter"
        read = _apply_errors(frag, error_rate, sub_p, ins_p, del_p, rng)
        # the name encodes the true placement for tests:
        # sim_<i>_pos<genome start>_len<fragment len><strand>
        reads.append((f"sim_{i}_pos{start}_len{length}{strand}{tag}",
                      read))
        total += len(read)
        i += 1
    return reads


def _apply_errors(seq, error_rate, sub_p, ins_p, del_p, rng):
    n = len(seq)
    if error_rate <= 0 or n == 0:
        return seq
    n_err = rng.poisson(error_rate * n)
    if n_err == 0:
        return seq
    pos = np.sort(rng.integers(0, n, size=n_err))
    kinds = rng.choice(3, size=n_err, p=[sub_p, ins_p, del_p])
    out = []
    prev = 0
    for p, kind in zip(pos, kinds):
        out.append(seq[prev:p])
        if kind == 0:  # substitution
            out.append(np.array([(seq[p] + rng.integers(1, 4)) % 4],
                                dtype=np.uint8))
            prev = p + 1
        elif kind == 1:  # insertion (homopolymer-biased: dup current base)
            base = seq[p] if rng.random() < 0.5 else rng.integers(0, 4)
            out.append(np.array([base], dtype=np.uint8))
            prev = p
        else:  # deletion
            prev = p + 1
    out.append(seq[prev:])
    return np.concatenate(out)


def random_genome(length: int, seed: int = 1,
                  repeat_spec: Optional[List[Tuple[int, int]]] = None
                  ) -> np.ndarray:
    """Uniform random genome; optionally paste (repeat_len, n_copies)
    repeats at random positions to exercise the repeat graph."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)
    if repeat_spec:
        for rep_len, copies in repeat_spec:
            unit = rng.integers(0, 4, size=rep_len).astype(np.uint8)
            for _ in range(copies):
                at = int(rng.integers(0, length - rep_len))
                g[at:at + rep_len] = unit
    return g


K1_ROW_KINDS = ("ext_sorted", "equal_runs", "unsorted", "dense",
                "jump_edges")


def k1_row_kinds(kind: str, T: int, M: int, max_jump: int,
                 rng: np.random.Generator
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """T match lists of one kind the chain DP kernel's window cut must
    handle, as int32 (cur, ext, nvalid):
      ext_sorted  ext non-decreasing, cur not (the engine's order when
                  the other read is longer);
      equal_runs  cur non-decreasing with runs of equal keys (dcur = 0),
                  ext equal within a run on every other row;
      unsorted    neither axis sorted (the full lookback is scanned);
      dense       ~2 matches per base: the admissible window is capped
                  by the lookback, not by max_jump;
      jump_edges  key steps of 1, 2, max_jump // 2, max_jump - 1 and
                  max_jump, the other axis on the same diagonal or one
                  off; the steps on cur in even rows, on ext in odd
                  rows (cur not sorted there).
    Rows past the first have nvalid drawn in [M // 2, M]."""
    noise = rng.integers(-60, 60, size=(T, M))
    if kind == "ext_sorted":
        ext = np.sort(rng.integers(0, 40 * M, size=(T, M)), axis=1)
        cur = ext - 300 + noise
        cur[:, 0] = cur[:, 1] + 1
    elif kind == "equal_runs":
        step = rng.integers(1, 120, size=(T, M))
        cur = np.cumsum(np.where(rng.random((T, M)) < 0.6, 0, step), axis=1)
        ext = cur + 300 + noise * (np.arange(T) % 2)[:, None]
    elif kind == "unsorted":
        cur = np.sort(rng.integers(0, 40 * M, size=(T, M)), axis=1)
        ext = cur + 300 + noise
        perm = np.argsort(rng.random((T, M)), axis=1)
        cur = np.take_along_axis(cur, perm, 1)
        ext = np.take_along_axis(ext, perm, 1)
    elif kind == "dense":
        cur = np.sort(rng.integers(0, max(1, M // 2), size=(T, M)), axis=1)
        ext = cur + 300 + rng.integers(-3, 4, size=(T, M))
    elif kind == "jump_edges":
        steps = np.array([1, 2, max_jump // 2, max_jump - 1, max_jump])
        a = np.cumsum(rng.choice(steps, size=(T, M)), axis=1)
        b = a + 300 + rng.integers(0, 2, size=(T, M))
        # odd rows: the steps on ext, cur not sorted
        odd = (np.arange(T) % 2 == 1)[:, None]
        cur = np.where(odd, b - 600, a)
        ext = np.where(odd, a, b)
        cur[1::2, 0] = cur[1::2, 1] + 1
    else:
        raise ValueError(f"unknown row kind {kind!r}")
    nvalid = np.full(T, M)
    nvalid[1:] = rng.integers(M // 2, M + 1, size=T - 1)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))
