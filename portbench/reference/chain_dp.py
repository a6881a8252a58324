"""Frozen plain copy of K1's reference, the chain DP
(`flye_tpu_torch/ops/chain.py` `_chain_dp_scan`), for checking the
timed path's K1 launches: plain torch, no import of the program."""

from __future__ import annotations

import torch

_NEG = -(2 ** 30)


def chain_dp(cur: torch.Tensor, ext: torch.Tensor, nvalid: torch.Tensor,
             k: int, max_jump: int, lookback: int):
    """Plain version: a loop over the match axis on [T, L] windows.

    The transition terms (match - gap, or "not allowed") do not depend
    on the scores, so they are computed for a chunk of steps at once
    ([T, C, L]); the serial loop then only adds the score window and
    takes its maximum.  Windows are stored latest-predecessor-first, so
    the first maximum `max` reports is the latest j, the tie rule of
    the recurrence.  Rows are visited longest first and each chunk
    covers only the rows still live in it, with its windows cut after
    the last predecessor any of its transitions may use."""
    T, M = cur.shape
    L = min(int(lookback), M)
    dev = cur.device
    nv = torch.clamp(nvalid.to(dev).to(torch.int64), 0, M)
    order = torch.argsort(-nv, stable=True)
    nv_s = nv[order]
    live = torch.arange(M, device=dev)[None, :] < nv_s[:, None]
    neg = torch.tensor(_NEG, dtype=torch.int32, device=dev)
    curm = torch.where(live, cur.to(torch.int32)[order], neg)
    extm = torch.where(live, ext.to(torch.int32)[order], neg)
    # reversed layout: column M-1-j holds match j; columns >= M pad j < 0
    pad = torch.full((T, L), _NEG, dtype=torch.int32, device=dev)
    cur_r = torch.cat([curm.flip(1), pad], dim=1)
    ext_r = torch.cat([extm.flip(1), pad], dim=1)
    score_r = torch.cat([torch.full((T, M), k, dtype=torch.int32,
                                    device=dev), pad], dim=1)
    # window of step i: columns M-i .. M-i+L-1 <-> j = i-1 .. i-L
    cur_w = cur_r.unfold(1, L, 1)                      # [T, M+1, L]
    ext_w = ext_r.unfold(1, L, 1)
    parent = torch.full((T, M), -1, dtype=torch.int32, device=dev)
    nv_h = nv_s.tolist()
    chunk = max(1, (1 << 22) // max(1, T * L))
    for i0 in range(1, nv_h[0] if T else 0, chunk):
        i1 = min(nv_h[0], i0 + chunk)
        n = sum(1 for x in nv_h if x > i0)             # live rows
        cols = torch.arange(M - i0, M - i1, -1, device=dev)
        dcur = curm[:n, i0:i1, None] - cur_w[:n, cols]   # [n, C, L]
        dext = extm[:n, i0:i1, None] - ext_w[:n, cols]
        ok = (dcur > 0) & (dcur < max_jump) & (dext > 0) & (dext < max_jump)
        match = torch.clamp(torch.minimum(dcur, dext), max=k)
        jd = torch.abs(dcur - dext)
        gap = torch.where(jd > 100, 2 * jd, jd // 2)
        # disallowed transitions stay below any allowed one (allowed
        # terms exceed -2*max_jump, scores are >= 0)
        base = torch.where(ok, match - gap, neg)
        # window tail with no allowed transition in the whole chunk:
        # dropping it changes no maximum and no parent
        reach = torch.nonzero(ok.any(dim=1).any(dim=0))
        Lq = int(reach[-1]) + 1 if len(reach) else 1
        base = base[:, :, :Lq]
        for c, i in enumerate(range(i0, i1)):
            cand = score_r[:n, M - i:M - i + Lq] + base[:, c]
            best, q = cand.max(dim=1)
            score_r[:n, M - 1 - i] = torch.clamp(best, min=k)
            parent[:n, i] = torch.where(best > k, i - 1 - q.to(torch.int32),
                                        -1)
    score = torch.empty((T, M), dtype=torch.int32, device=dev)
    score[order] = torch.where(live, score_r[:, :M].flip(1), 0)
    out_parent = torch.empty_like(parent)
    out_parent[order] = torch.where(live, parent, -1)
    return score, out_parent
