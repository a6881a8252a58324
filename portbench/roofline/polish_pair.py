"""K2+K3 (polish scoring pair) work, frozen from `chip_smoke.py`.

K2, per suffix-row cell: match add, gap add, max, minus sg, the running
max, plus sg, the row select (7).  K3, per prefix-row cell: the same 7
for the forward row, then the deletion score (2 adds, max, weighted
add: 4) and for each of the 4 chars the edited row (2 adds, 1 max, 1
gap add) reduced for insertion and substitution (2 x 4): 4 + 4 x 12.
The pair's bound (`polish_work`'s third entry) counts the inputs read
once and the outputs written once, K2's rows kept on chip.  Noted at the
recorder's "climb" hook: per climb batch, its lengths as it enters the
climb and the launch pairs it ran, eager and replayed (a candidate's
length moves by a few bases over its climb, which the count leaves
out)."""

import numpy as np

from peaks import FP32_OPS_PER_S, bound

K2_OPS_PER_CELL = 7
K3_OPS_PER_CELL = 7 + 4 + 4 * 12
HOOK = "climb"


def polish_work(B, Cb, R, S, clen, blen, bmask):
    """(bytes, operations) of K2, K3 and the pair's function (K2+K3 or
    K4) at one bucket: bytes are inputs read once and outputs written
    once, operations the live cells (candidate rows up to clen, branch
    columns up to blen; K3 only on the branches bmask keeps).  K2's
    output is the live region of its suffix rows, rows below clen and
    columns up to blen (bt: read by K3; K4 keeps its rows on chip and the
    pair's bound counts none), the whole of bt where clen is unknown.
    clen [B], blen [B, R] and bmask [B, R] are numpy arrays; where clen
    or bmask is None, the operations that need it count 0."""
    rows = B * Cb * R * (S + 1) * 4                # bt, f32
    side = B * R * (S + 1) * 4                     # sg or gp
    small = B * Cb + B * R * S + 4 * B * R + 4 * B * Cb + 100
    outs = 4 * B * (1 + Cb + 4 * (Cb + 1) + 4 * Cb)
    ops2 = ops3 = 0
    if clen is not None:
        c = clen.astype(np.int64)[:, None]
        cols = np.minimum(blen.astype(np.int64), S) + 1
        rows = 4 * int((np.minimum(c, Cb) * cols).sum())
        ops2 = K2_OPS_PER_CELL * int((c * cols).sum())
        if bmask is not None:
            ops3 = K3_OPS_PER_CELL * int(((c + 1) * cols * bmask).sum())
    return ((small + side + 4 * B + rows, ops2),
            (small + 2 * side + 4 * B + 4 * B * R + rows + outs, ops3),
            (small + 2 * side + 4 * B * (Cb + 1) + 4 * B + 4 * B * R
             + outs, ops2 + ops3))


def work(B, Cb, R, S, clen, blen, bmask):
    """(bytes, operations, peak rate) of one K2+K3 launch pair."""
    n_bytes, ops = polish_work(B, Cb, R, S, clen, blen, bmask)[2]
    return n_bytes, ops, FP32_OPS_PER_S


def note(rec, call):
    """One climb batch's shape, lengths and K2+K3 pairs; None without a
    pair."""
    climb, arrays, _ = call.args
    pairs = call.launches.get("polish_forward_score", 0)
    if not pairs:
        return None
    cand, cand_len, branches, blen, bmask, _ = arrays
    Bg, R, S = branches.shape
    return (Bg, cand.shape[1], R, S,
            np.repeat(np.asarray(cand_len, np.int64), climb.groups),
            np.array(blen), np.array(bmask, bool), pairs)


def counted(noted):
    """(launches, bytes, operations, peak rate) of a noted batch."""
    return (noted[-1], *work(*noted[:-1]))
