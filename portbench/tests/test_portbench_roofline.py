"""The frozen work formulas and peaks reproduce the bounds of PERF.md's
kernel table on the inputs that `chip_smoke.py` generates for those
rows, with its generators (copied here) and seeds."""

import numpy as np
import pytest
import torch

import peaks
import run


def roof(name):
    return run.load("roofline", name)


# chip_smoke.py make_matches, polish_inputs and lev_inputs, as they are
def make_matches(T, M, rng, noise=60, spacing=40):
    span = int(spacing * M)
    cur = np.sort(rng.integers(0, span, size=(T, M)), axis=1)
    ext = cur + 300 + rng.integers(-noise, noise, size=(T, M))
    nvalid = rng.integers(1, M + 1, size=T)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))


def polish_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(Cb // 2, Cb - Cb // 8, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(S // 2, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)
    return cand, clen, branches, blen, bmask, subs


def test_k1_synthetic_row_of_the_table():
    # PERF.md: K1 synthetic (2048, 4096), a match every 40 bases: bound
    # 0.0924 ms (ops); phase 2's first shape, rng seed 1
    rng = np.random.default_rng(1)
    cur, ext, nv = make_matches(2048, 4096, rng, spacing=40)
    nv[0], nv[1], nv[2] = 0, 1, 4096
    k1 = roof("chain_dp")
    ms, by = k1.bound(*k1.work(cur, ext, nv, 1500, 1024)[:2],
                      peaks.INT32_OPS_PER_S)
    assert (round(ms, 4), by) == (0.0924, "operations")


@pytest.mark.parametrize("shape,k2", [
    ((64, 96, 8, 1024), (0.0323, "bytes")),
    ((160, 240, 8, 256), (0.0495, "bytes"))])
def test_k2_rows_of_the_table(shape, k2):
    Cb, S, R, B = shape
    cand, clen, _, blen, bmask, _ = polish_inputs(Cb + S, (B, Cb, R, S))
    works = roof("polish_pair").polish_work(B, Cb, R, S, clen, blen, bmask)
    ms, by = peaks.bound(*works[0], peaks.FP32_OPS_PER_S)
    assert (round(ms, 4), by) == k2


def test_pair_row_of_the_table():
    # the K4 row (64,96,8) x1024: the pair's bound 0.0222 ms (ops), on
    # phase 6's inputs (seed Cb + S + R)
    Cb, S, R, B = 64, 96, 8, 1024
    cand, clen, _, blen, bmask, _ = polish_inputs(Cb + S + R, (B, Cb, R, S))
    ms, by = peaks.bound(*roof("polish_pair").work(B, Cb, R, S, clen, blen,
                                                   bmask))
    assert (round(ms, 4), by) == (0.0222, "operations")


def test_k3_row_of_the_table():
    cand, clen, _, blen, bmask, _ = polish_inputs(160, (1024, 64, 8, 96))
    works = roof("polish_pair").polish_work(1024, 64, 8, 96, clen, blen,
                                            bmask)
    ms, by = peaks.bound(*works[1], peaks.FP32_OPS_PER_S)
    assert (round(ms, 4), by) == (0.0340, "bytes")


def test_each_roofline_names_a_hook_and_counts_what_it_noted():
    # a formula is found by its file's name; what it notes at its hook
    # counts as the formula on the launch's inputs, times its launches
    from hooks import Call, Recorder
    roofs = run.rooflines()
    assert set(roofs) == {"chain_dp", "polish_pair"}
    rec = Recorder(1, {}, roofs)
    assert {m.HOOK for m in roofs.values()} <= set(rec.calls)
    rng = np.random.default_rng(1)
    cur, ext, nv = (torch.from_numpy(x) for x in make_matches(64, 256, rng))
    noted = roofs["chain_dp"].note(
        rec, Call((cur, ext, nv, 15, 1500, 1024), None, {}))
    noted = tuple(x.numpy() if isinstance(x, torch.Tensor) else x
                  for x in noted)
    assert roofs["chain_dp"].counted(noted) == (
        1, *roofs["chain_dp"].work(cur.numpy(), ext.numpy(), nv.numpy(),
                                   1500, 256))

    class Climb:
        groups = 1
    cand, clen, br, bl, bm, subs = polish_inputs(7, (16, 64, 8, 96))
    call = Call((Climb(), (cand, clen, br, bl, bm, subs), 10), None,
                {"polish_forward_score": 3, "polish_backward": 3})
    noted = roofs["polish_pair"].note(rec, call)
    assert roofs["polish_pair"].counted(noted) == (
        3, *roofs["polish_pair"].work(16, 64, 8, 96, clen, bl, bm))
    assert roofs["polish_pair"].note(rec, call._replace(launches={})) \
        is None


def test_peaks_are_the_h100_sxm_data_sheet_numbers():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.FP32_OPS_PER_S == 67e12
    assert peaks.INT32_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)
