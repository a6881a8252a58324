"""Seed-match chaining DP over padded batches of match lists.

Port of `flye_tpu/ops/chain.py`.  Many (query, target) match lists are
padded into one [T, M] batch; each row's DP runs over the match axis
with a bounded lookback window.  On a CUDA tensor the wrapper launches
the hand-written kernel `csrc/chain_dp.cu` (K1); on a CPU tensor it runs
the plain version `_chain_dp_scan`, which is also the kernel's oracle.

Scoring matches the reference exactly:
    transition j -> i allowed iff 0 < dcur < max_jump and 0 < dext < max_jump
    match score   = min(dcur, dext, k)
    gap cost      = 2*jumpDiv if jumpDiv > 100 else jumpDiv // 2
    score[i]      = max(k, max_j(score[j] + match - gap))
    parent[i]     = argmax j (latest j wins ties), only if score > k
(reference: src/sequence/overlap.cpp:277-323; the known deviation of
the JAX package — the best predecessor in the window, not the first
perfect diagonal — is kept.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.utils import trace

_NEG = -(2 ** 30)
_MAX_RING = 16384   # the kernel's shared-memory ring holds <= this many


def chain_dp(cur: torch.Tensor, ext: torch.Tensor, nvalid: torch.Tensor,
             k: int, max_jump: int, lookback: int):
    """Chain scores and parent pointers for a batch of match lists.

    Args:
      cur, ext: [T, M] int32 match coordinates, each row sorted along the
        chaining axis (the caller decides the order,
        reference: overlap.cpp:272-276).  Any order gives the same
        result; K1 scans less of the lookback on rows non-decreasing in
        cur or ext.
      nvalid: [T] int32 true match counts per row.
      k: k-mer size.
      max_jump: maximum allowed coordinate jump.
      lookback: how many predecessors each match may link to.

    Returns (score [T, M] int32, parent [T, M] int32, -1 for none).
    CPU tensors take the plain version, CUDA tensors the K1 kernel.
    """
    L = min(int(lookback), int(cur.shape[1]))
    if cur.device.type == "cpu":
        return _chain_dp_scan(cur, ext, nvalid, k, max_jump, L)
    return _chain_dp_cuda(cur, ext, nvalid, k, max_jump, L)


def chain_dp_multi(buckets, k: int, max_jump: int, lookback: int):
    """Chain DP over several padded bucket batches.

    buckets: sequence of (cur [T,M] int32, ext, nvalid [T]) tensors.
    Returns one flat int32 tensor laid out as, per bucket,
    [score rows..., parent rows...]; callers slice by the known shapes
    (the JAX package's single-fetch layout).  On an active mesh each
    bucket's rows split over its devices (`ParallelContext.map_rows`):
    K1 launches once per device block."""
    from flye_tpu_torch.parallel.runtime import get_runtime
    rt = get_runtime()
    outs = []
    for cur, ext, nv in buckets:
        s, p = rt.map_rows(
            lambda _, c, e, n: chain_dp(c, e, n, k, max_jump, lookback),
            cur, ext, nv)
        outs.append(s.reshape(-1))
        outs.append(p.reshape(-1))
    return torch.cat(outs)


def _chain_dp_scan(cur: torch.Tensor, ext: torch.Tensor,
                   nvalid: torch.Tensor, k: int, max_jump: int,
                   lookback: int):
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
    nv_h = trace.readback(nv_s).tolist()
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


def _chain_dp_cuda(cur: torch.Tensor, ext: torch.Tensor,
                   nvalid: torch.Tensor, k: int, max_jump: int, L: int):
    """Launch K1 (csrc/chain_dp.cu) on the tensors' CUDA device."""
    T, M = cur.shape
    dev = cur.device
    _cuda.require(cur, "cur", torch.int32, (T, M), dev)
    _cuda.require(ext, "ext", torch.int32, (T, M), dev)
    _cuda.require(nvalid, "nvalid", torch.int32, (T,), dev)
    if not 1 <= L <= _MAX_RING:
        raise ValueError(f"lookback {L} outside 1..{_MAX_RING}")
    score = torch.empty((T, M), dtype=torch.int32, device=dev)
    parent = torch.empty((T, M), dtype=torch.int32, device=dev)
    fn = _cuda.lib("chain_dp").chain_dp_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.launch("chain_dp", fn, dev, _cuda.ptr(cur), _cuda.ptr(ext),
                 _cuda.ptr(nvalid), _cuda.ptr(score), _cuda.ptr(parent), T,
                 M, int(k), int(max_jump), int(L))
    return score, parent


def backtrack_chains(score, parent, nvalid, k, max_chains=0):
    """Host-side chain extraction mirroring the reference's score-ordered
    backtracking with visited marking (reference: overlap.cpp:330-385),
    in the native helpers.

    Args:
      score, parent: [M] numpy arrays for ONE match list.
      nvalid: number of valid matches.
      k: k-mer size.
      max_chains: stop after this many chains (0 = no limit).

    Returns list of (first, last, chain_score, chain_indices) with
    chain_indices ascending.
    """
    from flye_tpu_torch import native

    nvalid = min(int(nvalid), len(score), len(parent))
    score = np.ascontiguousarray(score[:nvalid], dtype=np.int32)
    parent = np.ascontiguousarray(parent[:nvalid], dtype=np.int32)
    out = native.get().backtrack_chains(
        score.tobytes(), parent.tobytes(), int(nvalid), int(k),
        int(max_chains))
    return [(first, last, cscore,
             list(np.frombuffer(path, dtype=np.int32)))
            for first, last, cscore, path in out]
