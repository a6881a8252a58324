"""Homopolymer and dinucleotide-repeat re-estimation.

Behavioral port of HomoPolisher and DinucleotideFixer
(reference: src/polishing/homo_polisher.cpp, dinucleotide_fixer.cpp):
after general polishing, each homopolymer run in the candidate is
re-estimated by maximum likelihood over the platform's run-length
observation model (reference: subs_matrix.h:36-95 HopoMatrix; data
converted from the published *_homopolymers.mat tables into
data/hopo_*.npz).

Observations here are branch run lengths located by bounded local
search around the candidate position (the candidate and branches are
near-identical after general polishing), replacing the reference's full
pairwise alignment + run splitting (homo_polisher.cpp:14-130) — same
likelihood decision, no NW traceback needed.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("flye_tpu_torch")

# the run-length tables: the port's own copies of the JAX package's
# data files
_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_MAX_STATE = 20
_MAX_OBS = 32
_PLATFORM_FILES = {"pacbio": "hopo_pacbio.npz", "nano": "hopo_nano_r94.npz",
                   "nano_r7": "hopo_nano_r7.npz"}
_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}


def get_hopo_model(platform: str):
    """(obs_logp [4, 21, 33], genome_logp [4, 21])."""
    if platform not in _cache:
        blob = np.load(os.path.join(_DATA_DIR, _PLATFORM_FILES[platform]))
        _cache[platform] = (blob["obs_logp"], blob["genome_logp"])
    return _cache[platform]


def _runs(seq: np.ndarray) -> List[Tuple[int, int, int]]:
    """[(start, length, nucl)] homopolymer runs."""
    out = []
    if len(seq) == 0:
        return out
    start = 0
    for i in range(1, len(seq) + 1):
        if i == len(seq) or seq[i] != seq[start]:
            out.append((start, i - start, int(seq[start])))
            start = i
    return out


def _branch_run_at(branch: np.ndarray, nucl: int, center: int,
                   window: int) -> Optional[int]:
    """Length of the run of `nucl` NEAREST to `center` (full run length
    even when it extends past the window).

    The earlier 'longest run in window' rule inflated observations
    whenever a separate, longer run of the same nucleotide sat nearby
    (e.g. ...AAAAG AAAA...), which systematically mis-called run
    lengths by +-1 — the dominant residual error class measured on the
    parity set.  The reference reads the ALIGNED run
    (homo_polisher.cpp:14-130); nearest-run is its bounded-search
    equivalent at the fine bubbles, where each bubble holds at most a
    couple of runs."""
    lo = max(0, center - window)
    hi = min(len(branch), center + window)
    if hi <= lo:
        return None
    best = None
    best_d = None
    i = lo
    n = len(branch)
    while i < hi:
        if branch[i] == nucl:
            s = i
            while s > 0 and branch[s - 1] == nucl:
                s -= 1
            j = i
            while j < n and branch[j] == nucl:
                j += 1
            d = abs((s + j) // 2 - center)
            if best_d is None or d < best_d:
                best, best_d = j - s, d
            i = j
        else:
            i += 1
    return best if best is not None else 0


def polish_homopolymers(candidate: np.ndarray,
                        branches: List[np.ndarray],
                        platform: str,
                        min_run: int = 4,
                        min_obs: int = 2,
                        margin: float = 0.0) -> np.ndarray:
    """Re-estimate each homopolymer run's length by ML
    (reference: homo_polisher.cpp:220-280 mostLikelyLen/likelihood).

    min_obs / margin gate the correction: a run length only changes
    when at least min_obs branches observe the run AND the alternative
    beats the current length's likelihood by more than `margin` (the
    reference guards the same decision with its compareTopTwo
    common-observation re-scoring, homo_polisher.cpp:271-310; the
    margin is this port's equivalent evidence bar — measured on the
    420 kb parity set, an ungated pass INTRODUCES errors at <=6-branch
    coverage where the instrument-bias prior overrides thin data)."""
    if not branches or len(candidate) == 0:
        return candidate
    obs_logp, genome_logp = get_hopo_model(platform)
    out_parts = []
    runs = _runs(candidate)
    scale = [len(b) / max(1, len(candidate)) for b in branches]
    for start, length, nucl in runs:
        if length < min_run or length > _MAX_STATE - 1:
            out_parts.append(candidate[start:start + length])
            continue
        center = start + length // 2
        obs = []
        for b, sc in zip(branches, scale):
            r = _branch_run_at(b, nucl, int(center * sc), length + 4)
            if r is not None:
                obs.append(min(r, _MAX_OBS))
        if len(obs) < min_obs:
            out_parts.append(candidate[start:start + length])
            continue
        # likelihood over adjacent state lengths (window-located
        # observations are only trustworthy for +-1 decisions)
        cand_lens = range(max(1, length - 1), min(_MAX_STATE, length + 2))
        best_len, best_ll = length, -np.inf
        cur_ll = -np.inf
        for L in cand_lens:
            ll = float(genome_logp[nucl, L]) + sum(
                float(obs_logp[nucl, L, o]) for o in obs)
            if L == length:
                cur_ll = ll
            if ll > best_ll:
                best_ll, best_len = ll, L
        if best_len != length and best_ll - cur_ll <= margin:
            best_len = length
        out_parts.append(np.full(best_len, nucl, dtype=np.uint8))
    return np.concatenate(out_parts) if out_parts else candidate


def fix_dinucleotide_repeats(candidate: np.ndarray,
                             branches: List[np.ndarray],
                             min_units: int = 3) -> np.ndarray:
    """Re-estimate dinucleotide repeat counts by branch majority vote
    (behavioral analog of DinucleotideFixer,
    reference: src/polishing/dinucleotide_fixer.cpp)."""
    if not branches or len(candidate) < 2 * min_units:
        return candidate
    out = candidate
    i = 0
    parts = []
    n = len(out)
    scale = [len(b) / max(1, n) for b in branches]
    while i < n - 1:
        a, b = int(out[i]), int(out[i + 1])
        if a == b:
            parts.append(out[i:i + 1])
            i += 1
            continue
        # count repeat units (ab)(ab)...
        units = 0
        j = i
        while j + 1 < n and out[j] == a and out[j + 1] == b:
            units += 1
            j += 2
        if units < min_units:
            parts.append(out[i:i + 1])
            i += 1
            continue
        # vote on unit count among branches
        votes = []
        for br, sc in zip(branches, scale):
            c = int(i * sc)
            lo = max(0, c - 2 * units - 6)
            hi = min(len(br), c + 4 * units + 6)
            best = cur = 0
            p = lo
            while p + 1 < hi:
                if br[p] == a and br[p + 1] == b:
                    cur += 1
                    best = max(best, cur)
                    p += 2
                else:
                    cur = 0
                    p += 1
            votes.append(best)
        if len(votes) >= 2:
            vals, cnt = np.unique(votes, return_counts=True)
            winner = int(vals[np.argmax(cnt)])
            if winner > 0 and winner != units and \
                    cnt.max() > len(votes) // 2:
                units = winner
        parts.append(np.tile(np.array([a, b], dtype=np.uint8), units))
        i = j
    if i < n:
        parts.append(out[i:])
    return np.concatenate(parts) if parts else out
