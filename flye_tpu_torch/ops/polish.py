"""Batched bubble polishing: single-edit hill climbing in lockstep.

Port of `flye_tpu/ops/polish.py` (behavioral port of GeneralPolisher,
reference: src/polishing/general_polisher.cpp:8-125,
src/polishing/alignment.cpp:17-190).  Thousands of bubbles climb at
once: per iteration, the prefix (F) and suffix (B) NW rows of every
candidate against every branch score EVERY deletion / insertion /
substitution at every position,

    del(p)    = max_j F[p]    + B[p+1]
    ins(p, x) = max_j SUBx[p] + B[p]
    sub(p, x) = max_j SUBx[p] + B[p+1]
    SUBx[p][j] = max(F[p][j-1] + M[x, w_j], F[p][j] + M[x, '-'])

and the best edit of every parity-active block applies.

Scoring (`score_edits_raw`) runs the plain version `_score_edits_raw`
on a CPU tensor and one of two hand-written CUDA routes on a CUDA
tensor, chosen by shape alone (`cuda_route`):
  - K2+K3, `csrc/polish_score.cu`: K2 writes the live region of the
    suffix rows (rows below cand_len, columns up to blen) to device
    memory, K3 reads it back beside the forward rows and scores; each
    branch's row sits in its warp's registers;
  - K4, `csrc/polish_fused.cu`: both sweeps in one kernel, the suffix
    rows kept in shared memory (every U-th, and the rows between
    recomputed, where the whole stack does not fit).
    Taken when the caller asks for it (`fused`; `polish_bubbles` reads
    FLYE_TPU_FUSED, as the JAX package does, off by default) at the
    buckets the JAX package routes to its fused kernel (`fits_fused`,
    its `_pick_tile_fused` rule: up to (Cb, S) = (160, 240) at 8
    branches, (48, 63) at 56).  K4's outputs equal K2+K3's bit for
    bit.
On the CPU, `polish_bubbles` hands the whole climb to the threaded
native climber by default, as the JAX package does.  On a CUDA device
the climb is device-resident (`_Climb`, the port of `_converge_loop`):
each batch's inputs go up in one copy, its branch tables are built once
(`_prepare_branches`), and the steps (`_climb_step`: scoring, then
`_select_apply`) run as replays of a CUDA graph of _CLIMB_STEPS steps,
with one read of the stop flag per replay.  FLYE_TPU_HOST_POLL selects
the host-stepped loop `_converge` instead, as in the JAX package.

Float order: the gap-cost prefix sums use `_cumsum`, the 16-wide blocked
scan XLA's CPU backend applies to `jnp.cumsum`, and branch sums run in
branch order, so the plain version reproduces the JAX package's CPU
scores bit for bit and the kernels reproduce the plain version's.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import numpy as np
import torch
import torch.nn.functional as tnf

from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.utils import trace

NEG = -1e30
_EPS = 1e-3   # minimum score gain for an edit (f32, as the JAX package)
_GSZ = 8      # branches per group-lane


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """f32 prefix sum over a short last axis, added strictly left to
    right (torch.cumsum accumulates in another order and precision)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over the last axis, associated as XLA's
    CPU backend does for `jnp.cumsum`: sequential within 16-wide
    blocks, block totals scanned recursively and added afterwards."""
    n = x.shape[-1]
    if n <= 16:
        return _seq_cumsum(x)
    nb = -(-n // 16)
    xp = tnf.pad(x, (0, nb * 16 - n)).reshape(*x.shape[:-1], nb, 16)
    loc = _seq_cumsum(xp)
    car = _cumsum(loc[..., 15])
    excl = tnf.pad(car[..., :-1], (1, 0))
    return (loc + excl[..., None]).reshape(*x.shape[:-1], nb * 16)[..., :n]


def _wsum(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_r s[..., r] * w[:, r] in branch order: s [..., B, R]."""
    acc = s[..., 0] * w[:, 0]
    for r in range(1, s.shape[-1]):
        acc = acc + s[..., r] * w[:, r]
    return acc


def _branch_gaps(branches, blen, subs):
    """gp/sg [B,R,S+1]: each branch's gap prefix / suffix costs."""
    Bb, R, S = branches.shape
    dev = branches.device
    gap_b = subs[4, :4][branches.long()]                      # [B,R,S]
    jpos = torch.arange(S, device=dev)
    gap_bm = torch.where(jpos < blen[:, :, None], gap_b,
                         torch.zeros((), device=dev))
    gp = torch.cat([torch.zeros((Bb, R, 1), device=dev),
                    _cumsum(gap_bm)], dim=2)
    return gp, gp[:, :, -1:] - gp


def _prepare_branches(branches, blen, bmask, subs):
    """The per-batch tables of a climb, built once before its loop (the
    JAX package's `polish_pallas._prepare_branches`): gp, sg [B,R,S+1]
    and the branch weights w [B,R] (bmask as float32)."""
    return (*_branch_gaps(branches, blen, subs), bmask.to(torch.float32))


def _tables(cand, cand_len, branches, blen, subs, prep=None):
    """Per-lane constant tables shared by the plain version and the
    kernels' wrappers: gp/sg [B,R,S+1] (branch gap prefix / suffix
    costs, taken from `prep` when given) and, per step, vgap [B,Cb]
    (candidate gap costs, 0 past cand_len)."""
    Cb = cand.shape[1]
    dev = cand.device
    gp, sg = (prep[:2] if prep is not None
              else _branch_gaps(branches, blen, subs))
    vgap_all = subs[:4, 4][cand.long()]                       # [B,Cb]
    live_c = torch.arange(Cb, device=dev)[None, :] < cand_len[:, None]
    vgap = torch.where(live_c, vgap_all, torch.zeros((), device=dev))
    return gp, sg, vgap


def _ds(vgap):
    """ds [B,Cb+1]: the cost of deleting cand[i:clen] (vgap's suffix
    sums), the value of the suffix rows past blen."""
    csum = _cumsum(vgap)
    return csum[:, -1:] - torch.cat(
        [torch.zeros((vgap.shape[0], 1), device=vgap.device), csum], dim=1)


def _match_rows(cand, branches, subs):
    """sw [4,B,R,S] = subs[x, branch] and a row getter
    i -> subs[cand[:, i], branch] [B,R,S]."""
    sw = subs[:4, :4][:, branches.long()]
    lanes = torch.arange(cand.shape[0], device=cand.device)
    return sw, lambda i: sw[cand[:, i].long(), lanes]


def _backward_rows(cand, cand_len, branches, blen, subs, tables):
    """Plain version of K2: suffix rows B[0..Cb] [Cb+1,B,R,S+1]
    (B[Cb] = sg) by a reverse loop over candidate rows, the in-row
    dependence resolved by a flipped cummax."""
    Cb = cand.shape[1]
    S = branches.shape[2]
    dev = cand.device
    _, sg, vgap = tables
    ds = _ds(vgap)
    neg = torch.full((), NEG, device=dev)
    _, match_row = _match_rows(cand, branches, subs)
    in_b = torch.arange(S + 1, device=dev) <= blen[:, :, None]
    diag_ok = torch.arange(S, device=dev) < blen[:, :, None]
    rows = [sg]
    for i in range(Cb - 1, -1, -1):
        nxt = rows[-1]
        vg = vgap[:, i, None, None]
        diag = torch.where(diag_ok, nxt[:, :, 1:] + match_row(i), neg)
        tmp = torch.cat([torch.maximum(diag, nxt[:, :, :-1] + vg),
                         nxt[:, :, -1:] + vg], dim=2)
        tmp = torch.where(in_b, tmp, neg)
        row = torch.flip(torch.cummax(torch.flip(tmp - sg, [2]), dim=2)
                         .values, [2]) + sg
        row = torch.where((i < cand_len)[:, None, None], row, sg)
        rows.append(torch.where(in_b, row, ds[:, i, None, None]))
    return torch.stack(rows[::-1])


def _forward_scores(cand, branches, blen, bmask, subs, tables, Bm):
    """Plain version of K3: prefix rows F[0..Cb] by a forward loop with
    cummax, then the raw per-char scores against the suffix rows Bm."""
    Cb = cand.shape[1]
    S = branches.shape[2]
    dev = cand.device
    gp, _, vgap = tables
    w = bmask.to(torch.float32)
    sw, match_row = _match_rows(cand, branches, subs)
    jmask = torch.where(torch.arange(S + 1, device=dev) <= blen[:, :, None],
                        torch.zeros((), device=dev),
                        torch.full((), NEG, device=dev))
    F = [gp]
    for i in range(Cb):
        prev = F[-1]
        vg = vgap[:, i, None, None]
        tmp = torch.cat([prev[:, :, :1] + vg,
                         torch.maximum(prev[:, :, :-1] + match_row(i),
                                       prev[:, :, 1:] + vg)], dim=2)
        F.append(torch.cummax(tmp - gp, dim=2).values + gp)
    F = torch.stack(F)                                        # [Cb+1,...]

    def masked_reduce(x, b):
        return _wsum((x + b + jmask).max(dim=3).values, w)

    total = _wsum(Bm[0, :, :, 0], w)
    del_raw = masked_reduce(F[:-1], Bm[1:])
    ins4, sub4 = [], []
    for x in range(4):
        xgap = subs[x, 4]
        subx = torch.cat([F[..., :1] + xgap,
                          torch.maximum(F[..., :-1] + sw[x][None],
                                        F[..., 1:] + xgap)], dim=3)
        ins4.append(masked_reduce(subx, Bm))
        sub4.append(masked_reduce(subx[:-1], Bm[1:]))
    return total, del_raw, torch.stack(ins4), torch.stack(sub4)


def _score_edits_raw(cand, cand_len, branches, blen, bmask, subs,
                     prep=None):
    """Plain version of the scoring kernels (K2 then K3).

    cand [B,Cb] uint8, cand_len [B] int32, branches [B,R,S] uint8,
    blen [B,R] int32, bmask [B,R] bool, subs [5,5] float32; prep: the
    batch's `_prepare_branches` tables, built here when None.
    Returns (total [B], del_raw [Cb,B], ins4 [4,Cb+1,B], sub4 [4,Cb,B])
    WITHOUT the position-validity or cand!=x masks (_finish_scores
    applies those after the branch-group reduction)."""
    tables = _tables(cand, cand_len, branches, blen, subs, prep)
    Bm = _backward_rows(cand, cand_len, branches, blen, subs, tables)
    return _forward_scores(cand, branches, blen, bmask, subs, tables, Bm)


def _check_cuda_inputs(cand, cand_len, branches, blen, bmask, subs,
                       max_r=32):
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    dev = cand.device
    for t, name, dt, shape in (
            (cand, "cand", torch.uint8, (Bb, Cb)),
            (cand_len, "cand_len", torch.int32, (Bb,)),
            (branches, "branches", torch.uint8, (Bb, R, S)),
            (blen, "blen", torch.int32, (Bb, R)),
            (bmask, "bmask", torch.bool, (Bb, R)),
            (subs, "subs", torch.float32, (5, 5))):
        _cuda.require(t, name, dt, shape, dev)
    if not 1 <= R <= max_r:
        raise ValueError(f"{R} branches per lane; the kernels take "
                         f"1..{max_r}")


def _bt_pad(n):
    """n rounded up to whole 32-byte sectors of f32 (K2's row strides)."""
    return -(-n // 8) * 8


def _backward_rows_cuda(cand, cand_len, branches, blen, subs, tables):
    """Launch K2: the live region of the suffix rows, packed into bt
    [B, R, Cb, S1p] f32 (S1p = S+1 rounded up to 8 columns).  For lane
    b and branch r only the rows i < cand_len[b] and columns
    j <= blen[b, r] are written, equal there to the plain version's
    rows: row i at offset i * ldb of the branch's Cb * S1p floats, ldb =
    blen + 1 rounded up to 8 (`_bt_rows` unpacks them).  Every other
    entry is undefined (the rows i >= cand_len are sg, which K3 takes
    from the tables itself)."""
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    _, sg, vgap = tables
    bt = torch.empty((Bb, R, Cb, _bt_pad(S + 1)), dtype=torch.float32,
                     device=cand.device)
    fn = _cuda.lib("polish_score").polish_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _cuda.ptr
    _cuda.launch("polish_backward", fn, cand.device, p(cand), p(branches),
                 p(blen), p(sg), p(vgap), p(cand_len), p(subs), p(bt),
                 Bb, Cb, R, S)
    return bt


def _bt_live(cand_len, blen, Cb, S):
    """[B, R, Cb, S+1] bool: the live region of K2's rows (rows below
    cand_len, columns up to blen), the only entries it writes."""
    dev = blen.device
    rows = torch.arange(Cb, device=dev)[:, None]
    cols = torch.arange(S + 1, device=dev)
    bl = blen.to(torch.int64).clamp(0, S)
    return ((rows < cand_len[:, None, None, None].to(dev))
            & (cols <= bl[:, :, None, None]))


def _bt_rows(bt, cand_len, blen, S):
    """K2's packed rows (`_backward_rows_cuda`) as [B, R, Cb, S+1], the
    plain version's layout on the batch axis second: the live region
    (`_bt_live`) from bt, NaN elsewhere.  For checks of the kernel."""
    Bb, R, Cb, S1p = bt.shape
    dev = bt.device
    ldb = _bt_pad(blen.to(torch.int64).clamp(0, S) + 1)       # [B, R]
    rows = torch.arange(Cb, device=dev)[:, None]
    cols = torch.arange(S + 1, device=dev)
    idx = (rows * ldb[:, :, None, None] + cols).reshape(Bb, R, -1)
    got = torch.gather(bt.reshape(Bb, R, -1), 2,
                       idx.clamp(max=Cb * S1p - 1)).reshape(Bb, R, Cb,
                                                            S + 1)
    return torch.where(_bt_live(cand_len, blen, Cb, S), got,
                       torch.full((), float("nan"), device=dev))


def bitwise_equal(a, b):
    """True when two float tensors hold the same bits (NaN included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _forward_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                         tables, bt, w=None):
    """Launch K3 on K2's suffix rows bt (their live region only); same
    outputs as _forward_scores.  w: bmask as float32 (`_prepare_
    branches`), made here when None."""
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    dev = cand.device
    gp, sg, vgap = tables
    w = bmask.to(torch.float32) if w is None else w
    total = torch.empty(Bb, dtype=torch.float32, device=dev)
    del_raw = torch.empty((Cb, Bb), dtype=torch.float32, device=dev)
    ins4 = torch.empty((4, Cb + 1, Bb), dtype=torch.float32, device=dev)
    sub4 = torch.empty((4, Cb, Bb), dtype=torch.float32, device=dev)
    fn = _cuda.lib("polish_score").polish_forward_score_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _cuda.ptr
    _cuda.launch("polish_forward_score", fn, dev, p(cand), p(branches),
                 p(blen), p(cand_len), p(gp), p(sg), p(bt), p(vgap), p(w),
                 p(subs), p(total), p(del_raw), p(ins4), p(sub4), Bb, Cb, R,
                 S)
    return total, del_raw, ins4, sub4


def _score_edits_raw_cuda(cand, cand_len, branches, blen, bmask, subs,
                          prep=None):
    """K2 then K3 (csrc/polish_score.cu) on the tensors' CUDA device;
    same contract as _score_edits_raw (blen >= 0)."""
    _check_cuda_inputs(cand, cand_len, branches, blen, bmask, subs)
    tables = _tables(cand, cand_len, branches, blen, subs, prep)
    bt = _backward_rows_cuda(cand, cand_len, branches, blen, subs, tables)
    return _forward_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                                tables, bt, None if prep is None else prep[2])


def _tpu_fuses(Cb: int, R: int, S: int) -> bool:
    """The JAX package's routing rule for its fused kernel: whether
    `flye_tpu/ops/polish_pallas.py` `_pick_tile_fused(Rp, W, Cb+1)`
    finds a batch tile, i.e. whether its working-set model
    (`_fused_vmem_bytes`) fits 13 MiB of VMEM at the smallest tile, 8.
    Rp and W are its `_kernel_dims(R, S)`: 4 (S+1 <= 32) or 2 (S+1 <=
    64) branches packed per 128-lane row, else one branch per row of
    S+1 rounded up to 128 lanes, and the branch rows rounded up to 8."""
    pack = 4 if S + 1 <= 32 else (2 if S + 1 <= 64 else 1)
    rows = -(-R // pack)
    Rp = -(-rows // 8) * 8
    W = 128 if pack > 1 else -(-(S + 1) // 128) * 128
    tile, C1 = 8, Cb + 1
    need = ((C1 + 1 + 22 + 8) * tile * Rp * W * 4 + 30 * tile * C1 * 4
            + 2048 * tile)
    return need <= 13 * 1024 * 1024


def _fused_plan(Cb: int, R: int, S: int):
    """(P, least shared-memory bytes) of a K4 block (csrc/polish_fused.cu's
    layout): P positions per buffer of branch maxima (two buffers); the
    pool of suffix rows, S+1 rounded up to 8 floats a branch, holding at
    least the fewest rows any checkpoint stride U needs in the worst
    case, min over U of ceil(Cb/U) checkpoints and a ring of U-1.  The
    launch gives a block more where the SM has it to spare, and each
    block takes the least U its own lengths allow."""
    P = min(32, max(4, 64 // max(R, 1)))
    slots = min(-(-Cb // u) + u - 1 for u in range(1, max(Cb, 1) + 1))
    head = (34 + Cb + 3 * R + 18 * P * R + 3) // 4 * 4
    return P, 4 * (head + slots * R * _bt_pad(S + 1)) + Cb


def _fused_smem_bytes(Cb: int, R: int, S: int) -> int:
    """The least dynamic shared memory a K4 block needs (`_fused_plan`)."""
    return _fused_plan(Cb, R, S)[1]


def fits_fused(Cb: int, R: int, S: int) -> bool:
    """Whether K4 takes a bucket: exactly where the JAX package routes it
    to its fused kernel (`_tpu_fuses`).  The kernel launches at every
    such bucket; where it could not, its launch fails and raises."""
    return _tpu_fuses(Cb, R, S)


def cuda_route(fused: bool, Cb: int, R: int, S: int) -> str:
    """The kernel route `score_edits_raw` takes for CUDA tensors:
    "polish_fused" (K4) when asked for and the JAX package would fuse
    the bucket (`fits_fused`), else "polish_score" (K2+K3)."""
    return ("polish_fused" if fused and fits_fused(Cb, R, S)
            else "polish_score")


def _fused_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                       tables, w=None):
    """Launch K4 on the lanes' tables; same outputs as _forward_scores
    on _backward_rows.  w: as for _forward_scores_cuda."""
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    if not fits_fused(Cb, R, S):
        raise ValueError(f"(Cb, R, S) = {(Cb, R, S)} is outside K4's "
                         f"domain (fits_fused)")
    dev = cand.device
    gp, sg, vgap = tables
    w = bmask.to(torch.float32) if w is None else w
    total = torch.empty(Bb, dtype=torch.float32, device=dev)
    del_raw = torch.empty((Cb, Bb), dtype=torch.float32, device=dev)
    ins4 = torch.empty((4, Cb + 1, Bb), dtype=torch.float32, device=dev)
    sub4 = torch.empty((4, Cb, Bb), dtype=torch.float32, device=dev)
    fn = _cuda.lib("polish_fused").polish_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = _cuda.ptr
    _cuda.launch("polish_fused", fn, dev, p(cand), p(branches), p(blen),
                 p(sg), p(gp), p(vgap), p(cand_len), p(w), p(subs),
                 p(total), p(del_raw), p(ins4), p(sub4), Bb, Cb, R, S,
                 _fused_plan(Cb, R, S)[0])
    return total, del_raw, ins4, sub4


def _score_edits_raw_fused_cuda(cand, cand_len, branches, blen, bmask,
                                subs, prep=None):
    """K4 (csrc/polish_fused.cu) on the tensors' CUDA device; same
    contract as _score_edits_raw."""
    _check_cuda_inputs(cand, cand_len, branches, blen, bmask, subs,
                       max_r=56)
    tables = _tables(cand, cand_len, branches, blen, subs, prep)
    return _fused_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                              tables, None if prep is None else prep[2])


def score_edits_raw(cand, cand_len, branches, blen, bmask, subs,
                    fused: bool = False, prep=None):
    """Raw per-char edit scores of every bubble lane: the plain version
    for CPU tensors (K4's as well as K2+K3's); for CUDA tensors K4 or
    K2+K3 as `cuda_route` picks.  prep: the batch's `_prepare_branches`
    tables, built per call when None."""
    if cand.device.type == "cpu":
        return _score_edits_raw(cand, cand_len, branches, blen, bmask,
                                subs, prep)
    Cb = cand.shape[1]
    _, R, S = branches.shape
    if cuda_route(fused, Cb, R, S) == "polish_fused":
        return _score_edits_raw_fused_cuda(cand, cand_len, branches, blen,
                                           bmask, subs, prep)
    return _score_edits_raw_cuda(cand, cand_len, branches, blen, bmask,
                                 subs, prep)


def _first_argmax(x: torch.Tensor, dim: int):
    """(max, index of its FIRST occurrence) along dim."""
    best = x.max(dim=dim, keepdim=True).values
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    pos = torch.where(x == best, idx, n).min(dim=dim).values
    return best.squeeze(dim), pos


def _finish_scores(cand, cand_len, total, del_raw, ins4, sub4,
                   groups: int):
    """Reduce raw per-char planes over branch groups, then apply the
    per-lane masks and the 4-char argmax (earliest char wins ties,
    matching the reference's scan order).

    Raw inputs have Bg = B*groups lanes (lane b*groups+j holds group j
    of bubble b); outputs have B lanes."""
    if groups > 1:
        def red(a):  # [..., Bg] -> [..., B], groups summed in order
            a = a.reshape(*a.shape[:-1], -1, groups)
            acc = a[..., 0]
            for g in range(1, groups):
                acc = acc + a[..., g]
            return acc

        total, del_raw = red(total), red(del_raw)
        ins4, sub4 = red(ins4), red(sub4)
    Cb = del_raw.shape[0]
    dev = del_raw.device
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG, device=dev)
    pvalid_del = torch.where(torch.arange(Cb, device=dev)[:, None]
                             < cand_len[None, :], zero, neg)
    pvalid_ins = torch.where(torch.arange(Cb + 1, device=dev)[:, None]
                             <= cand_len[None, :], zero, neg)
    del_sc = del_raw + pvalid_del
    ins_all = ins4 + pvalid_ins[None]                        # [4,Cb+1,B]
    cand_t = cand.to(torch.int64).T                          # [Cb, B]
    xs = torch.arange(4, device=dev)[:, None, None]
    sub_all = (sub4 + pvalid_del[None]
               + torch.where(cand_t[None] == xs, neg, zero))
    ins_sc, ins_chr = _first_argmax(ins_all, 0)
    sub_sc, sub_chr = _first_argmax(sub_all, 0)
    return total, del_sc, ins_sc, ins_chr, sub_sc, sub_chr


def _score_edits(cand, cand_len, branches, blen, bmask, subs):
    """All single-edit scores: (total [B], del_sc [Cb,B], ins_sc
    [Cb+1,B], ins_chr, sub_sc [Cb,B], sub_chr)."""
    raw = score_edits_raw(cand, cand_len, branches, blen, bmask, subs)
    return _finish_scores(cand, cand_len, *raw, groups=1)


def _select_apply(cand, cand_len, done, streak, it_count, total, del_raw,
                  ins4, sub4, groups: int = 1, block_size: int = 64,
                  steepest: bool = True):
    """Pick the best edit of every parity-active block and apply all
    picked edits at once (block precedence follows the reference:
    del > ins > sub, earliest position on ties; steepest=True takes the
    best-scoring edit type per block instead).  it_count: the step, an
    int or a 0-d device tensor (the block parity is computed where it
    lies).  Returns (cand, cand_len, done, streak, total)."""
    (total, del_sc, ins_sc, ins_chr, sub_sc,
     sub_chr) = _finish_scores(cand, cand_len, total, del_raw, ins4,
                               sub4, groups)
    Bb, Cb = cand.shape
    dev = cand.device
    G = block_size if block_size > 0 else Cb + 1
    nb = -(-(Cb + 1) // G)
    blk_ids = torch.arange(nb, device=dev)
    streak_needed = 1 if nb == 1 else 2
    live_c = torch.arange(Cb, device=dev)[None, :] < cand_len[:, None]

    def blk_pick(arr, rows):
        a = torch.cat([arr, torch.full((nb * G - rows, Bb), NEG,
                                       device=dev)]).reshape(nb, G, Bb)
        best, pos = _first_argmax(a, 1)                      # [nb, B]
        return best, pos + blk_ids[:, None] * G

    delb_best, delb_pos = blk_pick(del_sc, Cb)
    insb_best, insb_pos = blk_pick(ins_sc, Cb + 1)
    subb_best, subb_pos = blk_pick(sub_sc, Cb)

    thr = total[None, :] + torch.full((), _EPS, device=dev)
    active = ((blk_ids % 2) == (it_count % 2)) | (nb == 1)
    live = active[:, None] & ~done[None, :]
    if steepest:
        best3 = torch.maximum(torch.maximum(delb_best, insb_best),
                              subb_best)
        improving = live & (best3 > thr)
        choose_del = improving & (delb_best >= best3)
        choose_ins = improving & ~choose_del & (insb_best >= best3)
        choose_sub = improving & ~choose_del & ~choose_ins
    else:
        choose_del = live & (delb_best > thr)
        choose_ins = live & ~choose_del & (insb_best > thr)
        choose_sub = live & ~choose_del & ~choose_ins & (subb_best > thr)

    n_del = choose_del.sum(dim=0).to(torch.int32)
    n_ins = choose_ins.sum(dim=0).to(torch.int32)
    overflow = cand_len + n_ins - n_del > Cb
    choose_ins = choose_ins & ~overflow[None, :]
    n_ins = choose_ins.sum(dim=0).to(torch.int32)

    any_edit = (choose_del | choose_ins | choose_sub).any(dim=0)
    new_streak = torch.where(any_edit, torch.zeros_like(streak),
                             streak + 1)
    new_done = done | (new_streak >= streak_needed)

    # ---- chosen edits -> per-position masks (unique positions: blocks
    # are disjoint; unchosen entries go to a dropped extra column) ----
    lane = torch.arange(Bb, device=dev)[None, :].expand(nb, Bb)

    def flag(choose, pos, width, vals=None):
        out = torch.zeros((Bb, width + 1), dtype=torch.int64, device=dev)
        idx = torch.where(choose, pos, width)
        src = (torch.ones_like(pos) if vals is None else vals)
        out[lane.reshape(-1), idx.reshape(-1)] = src.reshape(-1)
        return out[:, :width]

    is_del = flag(choose_del, delb_pos, Cb).bool()
    is_ins = flag(choose_ins, insb_pos, Cb + 1).bool()
    is_sub = flag(choose_sub, subb_pos, Cb).bool()
    ins_char_at = flag(choose_ins, insb_pos, Cb + 1, torch.gather(
        ins_chr, 0, insb_pos.clamp(0, Cb)))
    sub_char_at = flag(choose_sub, subb_pos, Cb, torch.gather(
        sub_chr, 0, subb_pos.clamp(0, Cb - 1)))

    # ---- apply every edit at once: each kept old char and each
    # inserted char moves to its new index (a scatter; the JAX
    # package's rolled-copy select is the same map without scatters) ----
    cand_subbed = torch.where(is_sub, sub_char_at.to(torch.uint8), cand)
    is_del_i = is_del.to(torch.int64)
    dels_cum = torch.cumsum(is_del_i, dim=1)
    ins_cum = torch.cumsum(is_ins.to(torch.int64), dim=1)
    W = Cb + 1
    keep = ~is_del & live_c
    dest_old = torch.arange(Cb, device=dev) + ins_cum[:, :Cb] - (
        dels_cum - is_del_i)
    dels_before = torch.cat(
        [torch.zeros((Bb, 1), dtype=torch.int64, device=dev), dels_cum],
        dim=1)[:, :W]
    dest_ins = torch.arange(W, device=dev) + ins_cum - dels_before - 1
    out = torch.zeros((Bb, W + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(keep, dest_old, W), cand_subbed)
    out.scatter_(1, torch.where(is_ins, dest_ins, W),
                 ins_char_at.to(torch.uint8))
    new_len = cand_len + n_ins - n_del
    return out[:, :Cb].contiguous(), new_len, new_done, new_streak, total


def _converge(cand, cand_len, branches, blen, bmask, subs, groups: int,
              block_size: int, steepest: bool, max_iters: int,
              score_fn=score_edits_raw, poll_every: int = 1):
    """Host loop of (scoring -> edit selection) steps until every lane
    is done or max_iters; converged lanes are frozen by their done
    flag.  The done flags are read back every `poll_every` iterations
    (and after the last); `iters` counts iterations up to the last
    poll at which a lane was still running.  Returns (cand, cand_len,
    score, iters) tensors."""
    Bb = cand.shape[0]
    dev = cand.device
    done = torch.zeros(Bb, dtype=torch.bool, device=dev)
    streak = torch.zeros(Bb, dtype=torch.int32, device=dev)
    score = torch.zeros(Bb, dtype=torch.float32, device=dev)
    iters = torch.zeros(Bb, dtype=torch.int32, device=dev)
    steps = 0
    for it in range(max_iters):
        steps += 1
        if groups > 1:
            cand_s = cand.repeat_interleave(groups, dim=0)
            clen_s = cand_len.repeat_interleave(groups, dim=0)
        else:
            cand_s, clen_s = cand, cand_len
        raw = score_fn(cand_s, clen_s, branches, blen, bmask, subs)
        cand, cand_len, done, streak, score = _select_apply(
            cand, cand_len, done, streak, it, *raw, groups=groups,
            block_size=block_size, steepest=steepest)
        if (it + 1) % poll_every == 0 or it == max_iters - 1:
            iters = torch.where(done, iters, it + 1)
            if bool(trace.readback(done.all())):
                break
    trace.count("climb.lane_steps", Bb * steps)
    return cand, cand_len, score, iters


# climb steps per CUDA graph, and per chunk between two reads of the
# stop flag on the CPU
_CLIMB_STEPS = 4
# device bytes the cached climbs' own buffers (inputs, tables and loop
# state) may hold together; the least recently used climb goes first
_CLIMB_CACHE_BYTES = 2 << 30
_CLIMBS: "collections.OrderedDict[tuple, _Climb]" = collections.OrderedDict()
_POOLS: dict = {}   # device -> the climbs' shared graph memory pool
_SIDE: dict = {}    # device -> the stream the climbs warm up and capture on
_NP = {torch.uint8: np.uint8, torch.int32: np.int32, torch.bool: np.bool_,
       torch.float32: np.float32}


def _expand(x, groups: int):
    """x [B, ...] -> [B*groups, ...], each lane repeated groups times in
    a row (`repeat_interleave` without a repeats tensor)."""
    return x.unsqueeze(1).expand(x.shape[0], groups, *x.shape[1:]).reshape(
        x.shape[0] * groups, *x.shape[1:])


def _climb_step(state, branches, blen, bmask, subs, prep, max_iters,
                groups: int, block_size: int, steepest: bool, score_fn):
    """One step of `_converge_loop` (flye_tpu/ops/polish.py) as a pure
    function of device tensors.  state = (it, cand, cand_len, done,
    streak, score, iters), it and max_iters 0-d int32.  The loop's
    condition it < max_iters is a guard here: past it no lane edits and
    nothing moves, so extra steps are no-ops, as are steps once every
    lane is done.  Done lanes keep their candidate, length, score and
    iters; iters counts every step against the old done flag, as
    `_converge_loop` does.  Nothing here reads the device from the
    host, so the step can be captured in a CUDA graph."""
    it, cand, cand_len, done, streak, score, iters = state
    run = it < max_iters
    held = done | ~run
    if groups > 1:
        cand_s, clen_s = _expand(cand, groups), _expand(cand_len, groups)
    else:
        cand_s, clen_s = cand, cand_len
    raw = score_fn(cand_s, clen_s, branches, blen, bmask, subs, prep=prep)
    ncand, nlen, ndone, nstreak, total = _select_apply(
        cand, cand_len, held, streak, it, *raw, groups=groups,
        block_size=block_size, steepest=steepest)
    return (it + run.to(it.dtype), torch.where(run, ncand, cand),
            torch.where(run, nlen, cand_len), torch.where(run, ndone, done),
            torch.where(run, nstreak, streak),
            torch.where(held, score, total),
            torch.where(held, iters, it + 1))


class _Climb:
    """The climb of one batch shape on one device, the port of
    `_converge_pallas_packed` + `_converge_loop`.

    Its buffers: the batch's inputs laid end to end in one device
    buffer, filled by one copy from one host buffer (pinned on a CUDA
    device); the per-batch tables (`_prepare_branches`); the loop state.
    `run` climbs one batch `steps` steps at a time until one read of the
    stop flag (every lane done, or it >= max_iters) says so.  On a CUDA
    device the steps are one CUDA graph, captured at the first batch
    after one eager step of it on a side stream (which builds the
    kernels and sets their attributes outside the capture), and
    replayed: one read per replay, no Python per step.  On the CPU the
    same steps run eagerly."""

    def __init__(self, shape, device, route: str, groups: int,
                 block_size: int, steepest: bool, steps: int):
        B, Cb, Bg, R, S = shape
        self.shape, self.device, self.route = shape, device, route
        self.groups, self.block_size = groups, block_size
        self.steepest, self.steps = steepest, steps
        self.score_fn = (_score_edits_raw if route == "plain" else
                         functools.partial(score_edits_raw,
                                           fused=route == "polish_fused"))
        fields = (("cand", torch.uint8, (B, Cb)),
                  ("cand_len", torch.int32, (B,)),
                  ("branches", torch.uint8, (Bg, R, S)),
                  ("blen", torch.int32, (Bg, R)),
                  ("bmask", torch.bool, (Bg, R)),
                  ("subs", torch.float32, (5, 5)),
                  ("max_iters", torch.int32, ()))
        self.fields, self.offs, n = fields, [], 0
        for _, dt, shp in fields:      # 16-byte aligned, end to end
            self.offs.append(n)
            n += -(-int(np.prod(shp)) * dt.itemsize // 16) * 16
        on_card = device.type == "cuda"
        self.host = torch.empty(n, dtype=torch.uint8, pin_memory=on_card)
        self.buf = (torch.empty(n, dtype=torch.uint8, device=device)
                    if on_card else self.host)
        self.inp = {name: self.buf[o:o + int(np.prod(shp)) * dt.itemsize]
                    .view(dt).reshape(shp)
                    for (name, dt, shp), o in zip(fields, self.offs)}

        def z(shp, dt=torch.float32):
            return torch.zeros(shp, dtype=dt, device=device)
        self.state = (z((), torch.int32), z((B, Cb), torch.uint8),
                      z(B, torch.int32), z(B, torch.bool), z(B, torch.int32),
                      z(B), z(B, torch.int32))
        self.prep = (z((Bg, R, S + 1)), z((Bg, R, S + 1)), z((Bg, R)))
        self.stop = z((), torch.bool)
        self.graph = None

    @staticmethod
    def nbytes(shape) -> int:
        """Device bytes of a climb's own buffers at this shape."""
        B, Cb, Bg, R, S = shape
        return (2 * B * Cb + Bg * R * S + 13 * Bg * R + 8 * Bg * R * (S + 1)
                + 26 * B + 1000)

    def _steps(self, n: int):
        """n climb steps on the state, in place, then the stop flag."""
        inp = self.inp
        for _ in range(n):
            new = _climb_step(self.state, inp["branches"], inp["blen"],
                              inp["bmask"], inp["subs"], self.prep,
                              inp["max_iters"], self.groups,
                              self.block_size, self.steepest, self.score_fn)
            for dst, src in zip(self.state, new):
                dst.copy_(src)
        self.stop.copy_(self.state[3].all()
                        | (self.state[0] >= inp["max_iters"]))

    def _load(self, arrays, max_iters: int):
        """The batch's inputs up in one copy; its tables; the state."""
        host = self.host.numpy()
        for (name, dt, shp), o, a in zip(self.fields, self.offs,
                                         (*arrays, np.int32(max_iters))):
            raw = np.ascontiguousarray(a, dtype=_NP[dt]).reshape(-1)
            host[o:o + raw.nbytes] = raw.view(np.uint8)
        if self.buf is not self.host:
            self.buf.copy_(self.host, non_blocking=True)
        inp = self.inp
        for dst, src in zip(self.prep, _prepare_branches(
                inp["branches"], inp["blen"], inp["bmask"], inp["subs"])):
            dst.copy_(src)
        it, cand, cand_len, done, streak, score, iters = self.state
        for t in (it, done, streak, score, iters):
            t.zero_()
        cand.copy_(inp["cand"])
        cand_len.copy_(inp["cand_len"])

    def _capture(self):
        """One eager step of the loaded batch on the side stream, then
        `steps` steps captured as a CUDA graph in the climbs' pool.  One
        side stream for every climb: the caching allocator keeps freed
        blocks per stream, so the warm-ups and the captures of all
        shapes reuse the same blocks.  The pool lives while a graph of
        it does; with none left it is taken anew."""
        dev = self.device
        if dev not in _SIDE:
            _SIDE[dev] = torch.cuda.Stream(dev)
        side = _SIDE[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(1)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(trace.readback(dev))
        if not any(c.graph is not None and c.device == dev
                   for c in _CLIMBS.values()):
            _POOLS[dev] = torch.cuda.graph_pool_handle()
        B, Cb, Bg, R, S = self.shape
        graph = _cuda.Graph(f"(Cb,S,R)=({Cb},{S},{R}) x{Bg} {self.route}")
        with graph.capture(side, _POOLS[dev]):
            self._steps(self.steps)
        self.graph = graph

    def run(self, arrays, max_iters: int):
        """Climb one batch: arrays = (cand, cand_len, branches, blen,
        bmask, subs), numpy.  Returns numpy (cand, cand_len, score,
        iters), read back in one copy."""
        B, Cb, Bg, R, S = self.shape
        steps = 0
        with trace.span(
                f"climb (Cb,S,R)=({Cb},{S},{R}) x{Bg} {self.route}"):
            self._load(arrays, max_iters)
            if self.device.type == "cuda" and self.graph is None:
                with trace.span("climb: capture"):
                    self._capture()
                trace.count("climb.captures")
                steps += 1
            while True:
                if self.graph is not None:
                    self.graph.replay()
                    trace.count("climb.replays")
                else:
                    self._steps(self.steps)
                steps += self.steps
                with trace.span("climb: wait"):
                    if bool(trace.readback(self.stop)):
                        break
            _, cand, cand_len, _, _, score, iters = self.state
            out = torch.cat([cand.reshape(-1), cand_len.view(torch.uint8),
                             score.view(torch.uint8),
                             iters.view(torch.uint8)])
            with trace.span("climb: wait"):
                out = trace.readback(out).cpu().numpy()
        trace.count("climb.batches")
        trace.count("climb.lane_steps", B * steps)
        # the part of them K4 scored (0 on the other routes)
        trace.count("climb.fused_lane_steps",
                    B * steps if self.route == "polish_fused" else 0)
        n = B * Cb
        return (out[:n].reshape(B, Cb),
                np.frombuffer(out[n:n + 4 * B].tobytes(), np.int32),
                np.frombuffer(out[n + 4 * B:n + 8 * B].tobytes(), np.float32),
                np.frombuffer(out[n + 8 * B:].tobytes(), np.int32))


def _climb_for(shape, device, route: str, groups: int, block_size: int,
               steepest: bool, steps: int) -> _Climb:
    """A climb for this batch shape: on a CUDA device the cached one
    (its graph captured once), else a new one."""
    if device.type != "cuda":
        return _Climb(shape, device, route, groups, block_size, steepest,
                      steps)
    key = (shape, device, route, groups, block_size, steepest, steps)
    climb = _CLIMBS.pop(key, None)
    if climb is None:
        need = _Climb.nbytes(shape)
        while _CLIMBS and need + sum(_Climb.nbytes(c.shape) for c in
                                     _CLIMBS.values()) > _CLIMB_CACHE_BYTES:
            _CLIMBS.popitem(last=False)
        climb = _Climb(shape, device, route, groups, block_size, steepest,
                       steps)
    _CLIMBS[key] = climb
    return climb


def _polish_bubbles_native(cand, cand_len, branches, blen, bmask, subs,
                           max_iters: int, eps: float = _EPS):
    """The whole climb in the threaded native CPU climber
    (flye_native.polish_bubbles_host)."""
    from flye_tpu_torch import native
    mod = native.get()
    cand = np.ascontiguousarray(cand, dtype=np.uint8)
    Bn, Cb = cand.shape
    _, R, S = branches.shape
    with trace.span("climb: native"):
        out = mod.polish_bubbles_host(
            cand.tobytes(),
            np.ascontiguousarray(cand_len, np.int32).tobytes(),
            np.ascontiguousarray(branches, np.uint8).tobytes(),
            np.ascontiguousarray(blen, np.int32).tobytes(),
            np.ascontiguousarray(bmask, np.uint8).tobytes(),
            np.ascontiguousarray(subs, np.float32).tobytes(),
            Bn, Cb, R, S, int(max_iters), float(eps))
    cand_b, len_b, score_b, iters_b = out
    iters = np.frombuffer(iters_b, np.int32)
    # each lane climbs on its own: its steps are its iterations
    trace.count("climb.batches")
    trace.count("climb.lane_steps", int(iters.sum()))
    return (np.frombuffer(cand_b, np.uint8).reshape(Bn, Cb),
            np.frombuffer(len_b, np.int32),
            np.frombuffer(score_b, np.float32), iters)


def polish_bubbles(cand, cand_len, branches, blen, bmask, subs,
                   max_iters: int, block_size: int = 64,
                   steepest: bool = True, use_kernel=None, device=None,
                   fused=None, resident=None):
    """Hill-climb every bubble to convergence.

    Args:
      cand: [B, Cb] uint8 candidate codes (Cb leaves growth headroom).
      cand_len: [B] int32.
      branches: [B, R, S] uint8; blen [B, R] int32; bmask [B, R] bool.
      subs: [5, 5] float32 log-prob matrix.  All numpy arrays.
      max_iters: outer-iteration cap.
      block_size: parallel-edit block width (0 = serial reference mode).
      use_kernel: None = the device's default (CPU: the native climber;
        CUDA: the block-parallel schedule on the kernels); True = the
        block-parallel schedule through `score_edits_raw`; False = the
        block-parallel schedule on the plain scoring version.
      device: where the block-parallel schedule runs (default: the
        runtime's device).
      fused: take K4 on a CUDA device where it fits (`cuda_route`);
        None = whether FLYE_TPU_FUSED is set, as in the JAX package.
      resident: run the block-parallel schedule as the device-resident
        climb (`_Climb`: CUDA-graph replays on a CUDA device, the same
        steps eagerly on the CPU) instead of the host-stepped loop
        `_converge`.  None = on a CUDA device when the kernels score
        and FLYE_TPU_HOST_POLL is not set, as the JAX package chooses
        its `_converge_loop`.

    Returns numpy (cand [B, Cb], cand_len [B], score [B], iters [B]).
    """
    from flye_tpu_torch.parallel.runtime import device_scope, get_runtime
    rt = get_runtime()
    blocks = rt.row_blocks(len(cand)) if device is None else []
    if len(blocks) > 1:
        # the bubble batch over the mesh, the JAX package's sharded
        # route (the polish phase is embarrassingly parallel over
        # windows, bubble_processor.h:29): each device climbs its block
        # of lanes on the route the device takes (resident on a card,
        # with its own graph captures); lanes are independent, so the
        # blocks give the whole batch's results.  Each block runs with
        # its device current: graph replays and the C launchers act on
        # the current device
        outs = []
        for dev, lo, hi in blocks:
            with device_scope(dev):
                outs.append(polish_bubbles(
                    cand[lo:hi], cand_len[lo:hi], branches[lo:hi],
                    blen[lo:hi], bmask[lo:hi], subs, max_iters,
                    block_size=block_size, steepest=steepest,
                    use_kernel=use_kernel, device=dev, fused=fused,
                    resident=resident))
        return tuple(np.concatenate([o[i] for o in outs])
                     for i in range(4))
    device = torch.device(device if device is not None else rt.device)
    if resident is None:
        resident = (device.type == "cuda" and use_kernel is not False
                    and not os.environ.get("FLYE_TPU_HOST_POLL"))
    if use_kernel is None and device.type == "cpu" and not resident:
        return _polish_bubbles_native(cand, cand_len, branches, blen,
                                      bmask, subs, max_iters)
    if fused is None:
        fused = bool(os.environ.get("FLYE_TPU_FUSED"))

    # branch-group tiling: lanes of <= 8 branch rows (score sums over
    # branches decompose exactly; the char argmax follows the group
    # reduction in _select_apply)
    R, S = branches.shape[1], branches.shape[2]
    groups = max(1, -(-R // _GSZ)) if R > _GSZ else 1
    if groups > 1:
        B0 = branches.shape[0]
        pad_r = groups * _GSZ - R
        branches = np.pad(np.asarray(branches),
                          ((0, 0), (0, pad_r), (0, 0)))
        blen = np.pad(np.asarray(blen), ((0, 0), (0, pad_r)))
        bmask = np.pad(np.asarray(bmask), ((0, 0), (0, pad_r)))
        branches = branches.reshape(B0 * groups, _GSZ, S)
        blen = blen.reshape(B0 * groups, _GSZ)
        bmask = bmask.reshape(B0 * groups, _GSZ)

    if resident:
        Cb = cand.shape[1]
        route = ("plain" if use_kernel is False or device.type == "cpu"
                 else cuda_route(fused, Cb, branches.shape[1], S))
        climb = _climb_for((cand.shape[0], Cb, *branches.shape), device,
                           route, groups, block_size, steepest,
                           _CLIMB_STEPS)
        return climb.run((cand, cand_len, branches, blen, bmask, subs),
                         max_iters)

    score_fn = (_score_edits_raw if use_kernel is False
                else functools.partial(score_edits_raw, fused=fused))

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dt),
                               device=device)
    # the done flags are read back every 4 iterations on a GPU (each
    # read is a device sync); every iteration on the CPU
    poll_every = 1 if device.type == "cpu" else 4
    Bg, R, S = branches.shape
    with trace.span(
            f"climb (Cb,S,R)=({cand.shape[1]},{S},{R}) x{Bg} host-stepped"):
        out = _converge(put(cand, np.uint8), put(cand_len, np.int32),
                        put(branches, np.uint8), put(blen, np.int32),
                        put(bmask, np.bool_), put(subs, np.float32),
                        groups, block_size, steepest, max_iters,
                        score_fn=score_fn, poll_every=poll_every)
        trace.count("climb.batches")
        return tuple(trace.readback(t).cpu().numpy() for t in out)
