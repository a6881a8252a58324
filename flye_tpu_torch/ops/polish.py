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
native climber by default, as the JAX package does.

Float order: the gap-cost prefix sums use `_cumsum`, the 16-wide blocked
scan XLA's CPU backend applies to `jnp.cumsum`, and branch sums run in
branch order, so the plain version reproduces the JAX package's CPU
scores bit for bit and the kernels reproduce the plain version's.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch
import torch.nn.functional as tnf

from flye_tpu_torch.ops import _cuda

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


def _tables(cand, cand_len, branches, blen, subs):
    """Per-lane constant tables shared by the plain version and the
    kernels' wrappers: gp/sg [B,R,S+1] (branch gap prefix / suffix
    costs), vgap [B,Cb] (candidate gap costs, 0 past cand_len)."""
    Bb, Cb = cand.shape
    S = branches.shape[2]
    dev = cand.device
    gap_b = subs[4, :4][branches.long()]                      # [B,R,S]
    jpos = torch.arange(S, device=dev)
    gap_bm = torch.where(jpos < blen[:, :, None], gap_b,
                         torch.zeros((), device=dev))
    gp = torch.cat([torch.zeros((Bb, gap_bm.shape[1], 1), device=dev),
                    _cumsum(gap_bm)], dim=2)
    sg = gp[:, :, -1:] - gp
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
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
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
                        torch.tensor(NEG, dtype=torch.float32, device=dev))
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


def _score_edits_raw(cand, cand_len, branches, blen, bmask, subs):
    """Plain version of the scoring kernels (K2 then K3).

    cand [B,Cb] uint8, cand_len [B] int32, branches [B,R,S] uint8,
    blen [B,R] int32, bmask [B,R] bool, subs [5,5] float32.
    Returns (total [B], del_raw [Cb,B], ins4 [4,Cb+1,B], sub4 [4,Cb,B])
    WITHOUT the position-validity or cand!=x masks (_finish_scores
    applies those after the branch-group reduction)."""
    tables = _tables(cand, cand_len, branches, blen, subs)
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
                         tables, bt):
    """Launch K3 on K2's suffix rows bt (their live region only); same
    outputs as _forward_scores."""
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    dev = cand.device
    gp, sg, vgap = tables
    w = bmask.to(torch.float32)
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


def _score_edits_raw_cuda(cand, cand_len, branches, blen, bmask, subs):
    """K2 then K3 (csrc/polish_score.cu) on the tensors' CUDA device;
    same contract as _score_edits_raw (blen >= 0)."""
    _check_cuda_inputs(cand, cand_len, branches, blen, bmask, subs)
    tables = _tables(cand, cand_len, branches, blen, subs)
    bt = _backward_rows_cuda(cand, cand_len, branches, blen, subs, tables)
    return _forward_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                                tables, bt)


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
                       tables):
    """Launch K4 on the lanes' tables; same outputs as _forward_scores
    on _backward_rows."""
    Bb, Cb = cand.shape
    _, R, S = branches.shape
    if not fits_fused(Cb, R, S):
        raise ValueError(f"(Cb, R, S) = {(Cb, R, S)} is outside K4's "
                         f"domain (fits_fused)")
    dev = cand.device
    gp, sg, vgap = tables
    w = bmask.to(torch.float32)
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
                                subs):
    """K4 (csrc/polish_fused.cu) on the tensors' CUDA device; same
    contract as _score_edits_raw."""
    _check_cuda_inputs(cand, cand_len, branches, blen, bmask, subs,
                       max_r=56)
    tables = _tables(cand, cand_len, branches, blen, subs)
    return _fused_scores_cuda(cand, cand_len, branches, blen, bmask, subs,
                              tables)


def score_edits_raw(cand, cand_len, branches, blen, bmask, subs,
                    fused: bool = False):
    """Raw per-char edit scores of every bubble lane: the plain version
    for CPU tensors (K4's as well as K2+K3's); for CUDA tensors K4 or
    K2+K3 as `cuda_route` picks."""
    if cand.device.type == "cpu":
        return _score_edits_raw(cand, cand_len, branches, blen, bmask,
                                subs)
    Cb = cand.shape[1]
    _, R, S = branches.shape
    if cuda_route(fused, Cb, R, S) == "polish_fused":
        return _score_edits_raw_fused_cuda(cand, cand_len, branches, blen,
                                           bmask, subs)
    return _score_edits_raw_cuda(cand, cand_len, branches, blen, bmask,
                                 subs)


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
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
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
    best-scoring edit type per block instead).  Returns (cand, cand_len,
    done, streak, total)."""
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

    thr = total[None, :] + torch.tensor(_EPS, dtype=torch.float32,
                                        device=dev)
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
    for it in range(max_iters):
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
            if bool(done.all()):
                break
    return cand, cand_len, score, iters


def _polish_bubbles_native(cand, cand_len, branches, blen, bmask, subs,
                           max_iters: int, eps: float = _EPS):
    """The whole climb in the threaded native CPU climber
    (flye_native.polish_bubbles_host)."""
    from flye_tpu_torch import native
    mod = native.get()
    cand = np.ascontiguousarray(cand, dtype=np.uint8)
    Bn, Cb = cand.shape
    _, R, S = branches.shape
    out = mod.polish_bubbles_host(
        cand.tobytes(),
        np.ascontiguousarray(cand_len, np.int32).tobytes(),
        np.ascontiguousarray(branches, np.uint8).tobytes(),
        np.ascontiguousarray(blen, np.int32).tobytes(),
        np.ascontiguousarray(bmask, np.uint8).tobytes(),
        np.ascontiguousarray(subs, np.float32).tobytes(),
        Bn, Cb, R, S, int(max_iters), float(eps))
    cand_b, len_b, score_b, iters_b = out
    return (np.frombuffer(cand_b, np.uint8).reshape(Bn, Cb),
            np.frombuffer(len_b, np.int32),
            np.frombuffer(score_b, np.float32),
            np.frombuffer(iters_b, np.int32))


def polish_bubbles(cand, cand_len, branches, blen, bmask, subs,
                   max_iters: int, block_size: int = 64,
                   steepest: bool = True, use_kernel=None, device=None,
                   fused=None):
    """Hill-climb every bubble to convergence.

    Args:
      cand: [B, Cb] uint8 candidate codes (Cb leaves growth headroom).
      cand_len: [B] int32.
      branches: [B, R, S] uint8; blen [B, R] int32; bmask [B, R] bool.
      subs: [5, 5] float32 log-prob matrix.  All numpy arrays.
      max_iters: outer-iteration cap.
      block_size: parallel-edit block width (0 = serial reference mode).
      use_kernel: None = the device's default (CPU: the native climber;
        CUDA: the block-parallel schedule on the K2+K3 kernels); True =
        the block-parallel schedule through `score_edits_raw`; False =
        the block-parallel schedule on the plain scoring version.
      device: where the block-parallel schedule runs (default: the
        runtime's device).
      fused: take K4 on a CUDA device where it fits (`cuda_route`);
        None = whether FLYE_TPU_FUSED is set, as in the JAX package.

    Returns numpy (cand [B, Cb], cand_len [B], score [B], iters [B]).
    """
    from flye_tpu_torch.parallel.runtime import get_runtime
    device = torch.device(device if device is not None
                          else get_runtime().device)
    if use_kernel is None and device.type == "cpu":
        return _polish_bubbles_native(cand, cand_len, branches, blen,
                                      bmask, subs, max_iters)
    if fused is None:
        fused = bool(os.environ.get("FLYE_TPU_FUSED"))
    score_fn = (_score_edits_raw if use_kernel is False
                else functools.partial(score_edits_raw, fused=fused))

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

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dt),
                               device=device)
    # the done flags are read back every 4 iterations on a GPU (each
    # read is a device sync); every iteration on the CPU
    poll_every = 1 if device.type == "cpu" else 4
    out = _converge(put(cand, np.uint8), put(cand_len, np.int32),
                    put(branches, np.uint8), put(blen, np.int32),
                    put(bmask, np.bool_), put(subs, np.float32),
                    groups, block_size, steepest, max_iters,
                    score_fn=score_fn, poll_every=poll_every)
    return tuple(t.cpu().numpy() for t in out)
