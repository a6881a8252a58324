"""K1 (chain DP) work, frozen from `chip_smoke.py`: per (match,
predecessor) pair, two coordinate differences, four range compares and
three ands, a min and a clamp (match), |dcur-dext|, a compare, a
double, a halve and a select (gap), match - gap, the score add and the
running max.  The pairs are the admissible ones (`k1_admissible_pairs`),
the work the inputs need.  Bytes: cur, ext and nvalid read once, score
and parent written once.  Noted at the recorder's "chain_dp" hook: each
launch's cur, ext and nvalid, copied to the host."""

import numpy as np

from peaks import INT32_OPS_PER_S, bound

K1_OPS_PER_PAIR = 20
HOOK = "chain_dp"


def k1_admissible_pairs(cur, ext, nvalid, max_jump, L):
    """The (match, predecessor) pairs K1's inputs need: for each live
    match i of a row, the j in [max(0, i-L), i) with key[i] - key[j] <
    max_jump on the row's sorted axis (cur if it is non-decreasing over
    the live matches, else ext if that is), all min(i, L) of them where
    neither axis is sorted.  numpy on host arrays, in blocks of rows:
    each block's sorted rows are laid end to end, each shifted past the
    one before by more than max_jump, so that one np.searchsorted finds
    every row's first admissible j."""
    T, M = cur.shape
    mj = max(int(max_jump), 0)
    i = np.arange(M)
    window = i - np.maximum(i - L, 0)
    big = np.iinfo(np.int32).max
    total = 0
    rows = max(1, (1 << 22) // max(1, M))
    for r0 in range(0, T, rows):
        live = i < np.clip(nvalid[r0:r0 + rows], 0, M)[:, None]
        c = np.where(live, cur[r0:r0 + rows], big)
        e = np.where(live, ext[r0:r0 + rows], big)
        c_sorted = (c[:, 1:] >= c[:, :-1]).all(axis=1)
        srt = c_sorted | (e[:, 1:] >= e[:, :-1]).all(axis=1)
        total += int((live[~srt] * window).sum())
        if not srt.any():
            continue
        key = np.where(c_sorted[:, None], c, e)[srt].astype(np.int64)
        key -= key[:, :1]
        span = key[:, -1] + mj + 1
        key += (np.cumsum(span) - span)[:, None]
        flat = key.reshape(-1)
        lo = np.searchsorted(flat, flat - mj, side="right").reshape(
            key.shape) - (np.arange(len(key)) * M)[:, None]
        total += int((live[srt] * np.minimum(window, i - lo).clip(0)).sum())
    return total


def k1_bound(T, M, pairs):
    """K1's bound: cur, ext and nvalid read once, score and parent
    written once; K1_OPS_PER_PAIR per admissible pair."""
    return bound(16 * T * M + 4 * T, K1_OPS_PER_PAIR * pairs,
                 INT32_OPS_PER_S)


def work(cur, ext, nvalid, max_jump, L):
    """(bytes, operations, peak rate) of one K1 launch from its host
    inputs."""
    T, M = cur.shape
    pairs = k1_admissible_pairs(cur, ext, nvalid, max_jump, L)
    return 16 * T * M + 4 * T, K1_OPS_PER_PAIR * pairs, INT32_OPS_PER_S


def note(rec, call):
    """What `counted` needs of one K1 launch: its inputs on the host."""
    cur, ext, nvalid, _, max_jump, lookback = call.args
    L = min(int(lookback), int(cur.shape[1]))
    return (*rec.to_host([cur, ext, nvalid]), int(max_jump), L)


def counted(noted):
    """(launches, bytes, operations, peak rate) of a noted launch."""
    return (1, *work(*noted))
