"""Frozen plain copy of K5's reference, the Levenshtein distance
(`flye_tpu_torch/ops/align.py` `_edit_distance_plain`), for checking
the timed path's K5 launches: plain torch, no import of the program."""

from __future__ import annotations

import torch


def edit_distance(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                  blen: torch.Tensor) -> torch.Tensor:
    """Plain version: one tensor row update per row of a."""
    B, S = a.shape
    dev = a.device
    big = 2 ** 30
    js = torch.arange(S + 1, dtype=torch.int32, device=dev)
    prev = js.expand(B, S + 1)
    alen = alen.to(torch.int32)
    result = torch.where(alen[:, None] == 0, prev,
                         torch.full_like(prev, big))
    bb = b.to(torch.int32)
    a32 = a.to(torch.int32)
    # rows past the longest a never reach `result`
    n = min(S, int(alen.max())) if B else 0
    for i in range(n):
        sub = (a32[:, i:i + 1] != bb).to(torch.int32)          # [B, S]
        # tmp[j] for j>=1: min(prev[j-1] + sub_{j-1}, prev[j] + 1)
        tmp = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
        tmp = torch.cat([torch.full((B, 1), i + 1, dtype=torch.int32,
                                    device=dev), tmp], dim=1)
        # row[j] = min_{k<=j} tmp[k] + (j - k)
        row = torch.cummin(tmp - js, dim=1).values + js
        result = torch.where((alen == i + 1)[:, None], row, result)
        prev = row
    return torch.gather(result, 1,
                        blen.to(torch.int64)[:, None])[:, 0]
