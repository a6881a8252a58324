"""Frozen plain copy of the bubble climb of the port's polisher: the
plain scoring (K2+K3's reference, `flye_tpu_torch/ops/polish.py`
`_score_edits_raw`), the edit selection `_select_apply` and the step
`_climb_step` of the device-resident climb `_Climb`, for checking the
timed path's climbs: plain torch, no import of the program.

Every float follows the type of `subs`: float32 is the reference, and
bfloat16 is the control (the same climb one precision lower), which the
check must tell from the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

NEG = -1e30
_EPS = 1e-3   # minimum score gain for an edit (f32, as the JAX package)


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
                         torch.zeros((), dtype=subs.dtype, device=dev))
    gp = torch.cat([torch.zeros((Bb, R, 1), dtype=subs.dtype, device=dev),
                    _cumsum(gap_bm)], dim=2)
    return gp, gp[:, :, -1:] - gp


def _prepare_branches(branches, blen, bmask, subs):
    """The per-batch tables of a climb, built once before its loop (the
    JAX package's `polish_pallas._prepare_branches`): gp, sg [B,R,S+1]
    and the branch weights w [B,R] (bmask in the scores' type)."""
    return (*_branch_gaps(branches, blen, subs), bmask.to(subs.dtype))


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
    vgap = torch.where(live_c, vgap_all,
                       torch.zeros((), dtype=subs.dtype, device=dev))
    return gp, sg, vgap


def _ds(vgap):
    """ds [B,Cb+1]: the cost of deleting cand[i:clen] (vgap's suffix
    sums), the value of the suffix rows past blen."""
    csum = _cumsum(vgap)
    return csum[:, -1:] - torch.cat(
        [torch.zeros((vgap.shape[0], 1), dtype=vgap.dtype,
                     device=vgap.device), csum], dim=1)


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
    neg = torch.full((), NEG, dtype=subs.dtype, device=dev)
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
    w = bmask.to(subs.dtype)
    sw, match_row = _match_rows(cand, branches, subs)
    jmask = torch.where(torch.arange(S + 1, device=dev) <= blen[:, :, None],
                        torch.zeros((), dtype=subs.dtype, device=dev),
                        torch.full((), NEG, dtype=subs.dtype, device=dev))
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
    zero = torch.zeros((), dtype=total.dtype, device=dev)
    neg = torch.full((), NEG, dtype=total.dtype, device=dev)
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
                                       dtype=arr.dtype, device=dev)]
                      ).reshape(nb, G, Bb)
        best, pos = _first_argmax(a, 1)                      # [nb, B]
        return best, pos + blk_ids[:, None] * G

    delb_best, delb_pos = blk_pick(del_sc, Cb)
    insb_best, insb_pos = blk_pick(ins_sc, Cb + 1)
    subb_best, subb_pos = blk_pick(sub_sc, Cb)

    thr = total[None, :] + torch.full((), _EPS, dtype=total.dtype,
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


def climb(arrays, max_iters: int, groups: int, block_size: int,
          steepest: bool, device, dtype=torch.float32, steps: int = 4):
    """One batch climbed as `_Climb.run` climbs it: arrays = (cand,
    cand_len, branches, blen, bmask, subs), numpy, the lanes already
    tiled into branch groups.  Steps run until every lane is done or
    max_iters (further steps are no-ops in the program).  On a CUDA
    device, after one eager step, `steps` steps are captured as a CUDA
    graph of these plain ops and replayed until the stop flag says so
    (the steps read nothing back to the host, so the graph replays the
    same ops and launches them faster).  Returns numpy (cand, cand_len,
    score)."""
    device = torch.device(device)
    cand, cand_len, branches, blen, bmask, subs = (
        torch.as_tensor(np.ascontiguousarray(a)).to(device) for a in arrays)
    cand_len = cand_len.to(torch.int32)
    blen = blen.to(torch.int32)
    bmask = bmask.to(torch.bool)
    subs = subs.to(dtype)
    prep = _prepare_branches(branches, blen, bmask, subs)
    B = cand.shape[0]

    def z(dt, shape=(B,)):
        return torch.zeros(shape, dtype=dt, device=device)
    state = (z(torch.int32, ()), cand.clone(), cand_len.clone(),
             z(torch.bool), z(torch.int32), z(dtype), z(torch.int32))
    mi = torch.tensor(int(max_iters), dtype=torch.int32, device=device)
    stop = torch.zeros((), dtype=torch.bool, device=device)

    def run(n):
        for _ in range(n):
            new = _climb_step(state, branches, blen, bmask, subs, prep, mi,
                              groups, block_size, steepest,
                              _score_edits_raw)
            for dst, src in zip(state, new):
                dst.copy_(src)
        stop.copy_(state[3].all() | (state[0] >= mi))

    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run(1)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        if not bool(stop):
            with torch.cuda.graph(graph, stream=side):
                run(steps)
            while not bool(stop):
                graph.replay()
    else:
        while not bool(stop):
            run(1)
    _, cand, cand_len, _, _, score, _ = state
    return (cand.cpu().numpy(), cand_len.cpu().numpy(),
            score.float().cpu().numpy())
