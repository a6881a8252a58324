"""The control of the climb check: the plain climb one precision lower
(bfloat16) must read above the cells' `climb_gap` limits, where the
program's own climb (its device-resident climb on the CPU, the plain
scoring) reads 0 against the float32 reference.  At a size a test run
holds: a batch of synthetic bubbles (noisy branches of a true sequence,
candidates with planted errors, 12 branches, so two branch groups)."""

import numpy as np
import pytest
import torch

import checks
import run
from reference import climb as ref_climb

CELLS = ["pbraw50-asm", "hifi30-asm"]


def bubbles(seed, B=48, C=60, Cb=80, S=90, R=12, err=0.08):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 3)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    branches = np.zeros((B, R, S), np.uint8)
    blen = np.zeros((B, R), np.int32)
    import gen
    for b in range(B):
        for r in range(R):
            s = gen.apply_errors(true[b], err, (0.2, 0.5, 0.3), rng)[:S]
            branches[b, r, :len(s)] = s
            blen[b, r] = len(s)
    bmask = np.ones((B, R), bool)
    p = np.full((5, 5), 0.02, np.float32)
    np.fill_diagonal(p, 0.9)
    subs = np.log(p / p.sum(1, keepdims=True)).astype(np.float32)
    return cand, np.full(B, C, np.int32), branches, blen, bmask, subs


def tiled(arrays, groups=2, gsz=8):
    cand, clen, branches, blen, bmask, subs = arrays
    B, R, S = branches.shape
    pad = groups * gsz - R
    br = np.pad(branches, ((0, 0), (0, pad), (0, 0))).reshape(-1, gsz, S)
    bl = np.pad(blen, ((0, 0), (0, pad))).reshape(-1, gsz)
    bm = np.pad(bmask, ((0, 0), (0, pad))).reshape(-1, gsz)
    return cand, clen, br, bl, bm, subs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(seed):
    from flye_tpu_torch.ops.polish import polish_bubbles
    from flye_tpu_torch.parallel.runtime import init_runtime
    init_runtime(None, "cpu")
    arrays = bubbles(seed)
    cand, clen, branches, blen, bmask, subs = arrays
    prog = polish_bubbles(cand, clen, branches, blen, bmask, subs,
                          max_iters=2 * cand.shape[1], use_kernel=False,
                          device="cpu", resident=True)
    t = tiled(arrays)
    ref = ref_climb.climb(t, 2 * cand.shape[1], 2, 64, True, "cpu")
    low = ref_climb.climb(t, 2 * cand.shape[1], 2, 64, True, "cpu",
                          dtype=torch.bfloat16)
    assert checks.lanes_off(prog, ref) == 0
    assert checks.score_gap(prog, ref) == 0.0
    limits = [run.read_json(run.HERE, "workloads", f"{c}.json")["limits"][
        "climb_gap"] for c in CELLS]
    assert checks.score_gap(low, ref) > 3 * max(limits)
