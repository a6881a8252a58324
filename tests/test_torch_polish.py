"""flye_tpu_torch polish scoring (the K2+K3 kernels' plain version) and
the block-parallel hill climb vs the JAX package's jnp formulation.

Tolerances: raw/edit scores within 1e-3 where finite with the same
finiteness, chosen chars exact (the polisher's acceptance threshold is
1e-3); climb outputs byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flye_tpu.ops.polish as P
import flye_tpu_torch.ops.polish as TP
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(10, Cb + 1, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(8, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)
    return cand, clen, branches, blen, bmask, subs


def _assert_scores_close(ref, out):
    names = ["total", "del", "ins", "ins_chr", "sub", "sub_chr"]
    for name, r, o in zip(names, ref, out):
        r, o = np.asarray(r), np.asarray(o)
        assert r.shape == o.shape, name
        if name.endswith("chr"):
            np.testing.assert_array_equal(r, o, err_msg=name)
        else:
            finite = r > -1e29
            assert np.array_equal(finite, o > -1e29), name
            diff = np.abs(np.where(finite, r - o, 0)).max()
            assert diff < 1e-3, (name, diff)


@pytest.mark.parametrize("seed,shape", [
    (0, (5, 24, 3, 40)),
    (3, (5, 24, 3, 40)),
    (1, (4, 20, 12, 28)),
    (2, (4, 20, 18, 60)),
    (5, (3, 16, 5, 130)),
])
def test_score_edits_matches_jnp(seed, shape):
    args = _inputs(seed, shape)
    ref = P._score_edits_jnp(*(jnp.asarray(a) for a in args))
    out = TP._score_edits(*(torch.from_numpy(a) for a in args))
    _assert_scores_close(ref, [o.numpy() for o in out])


def test_cumsum_matches_jnp():
    rng = np.random.default_rng(4)
    for n in (1, 16, 17, 97, 300, 2305):
        x = np.log(rng.random((3, 4, n)) * 0.5 + 0.01).astype(np.float32)
        np.testing.assert_array_equal(
            TP._cumsum(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=2)))


def _climb_inputs(R, noisy):
    rng = np.random.default_rng(7)
    B, C, Cb, S = 4, 30, 40, 60
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 2)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    if noisy:
        flip = rng.random((B, R, S)) < 0.08
        branches = np.where(flip, rng.integers(0, 4, (B, R, S)),
                            branches).astype(np.uint8)
        blen = rng.integers(C - 3, C + 4, (B, R)).astype(np.int32)
        bmask = rng.random((B, R)) < 0.9
        bmask[:, 0] = True
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    return true, (cand, clen, branches, blen, bmask, subs)


@pytest.mark.parametrize("R", [3, 24])
@pytest.mark.parametrize("noisy", [False, True])
def test_polish_bubbles_schedule_matches_jax(R, noisy):
    """The block-parallel schedule (groups of 8 branch rows for R=24)
    converges to the JAX package's candidates, byte for byte."""
    true, args = _climb_inputs(R, noisy)
    ref = P.polish_bubbles(*args, max_iters=24, use_pallas=False)
    out = TP.polish_bubbles(*args, max_iters=24, use_kernel=False,
                            device="cpu")
    for r, o in zip(ref, out):
        r = np.asarray(r)
        assert r.dtype == o.dtype and r.shape == o.shape
        np.testing.assert_array_equal(o, r)
    if not noisy:   # and it actually fixed the planted errors
        for i in range(len(true)):
            np.testing.assert_array_equal(out[0][i, :out[1][i]], true[i])


def test_polish_bubbles_cpu_default_is_native():
    """On the CPU both packages hand the climb to the native climber."""
    _, args = _climb_inputs(24, True)
    ref = P.polish_bubbles(*args, max_iters=24)
    out = TP.polish_bubbles(*args, max_iters=24, device="cpu")
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o, np.asarray(r))


def test_cpu_scoring_launches_no_kernel():
    args = _inputs(0, (2, 16, 3, 20))
    before = dict(_cuda.LAUNCHES)
    TP.score_edits_raw(*(torch.from_numpy(a) for a in args))
    assert _cuda.LAUNCHES == before


def test_plain_scores_ignore_suffix_columns_past_blen():
    """What K2 and K3 rely on to leave those entries unwritten: the plain
    scores do not depend on the suffix rows' columns past blen, which
    are replaced here by other finite values in [-1e3, 0], and the rows
    from cand_len on are the gap row sg on the columns up to blen."""
    args = [torch.from_numpy(a) for a in _inputs(6, (6, 20, 5, 40))]
    cand, clen, branches, blen, bmask, subs = args
    clen[0], blen[0, :3] = 0, torch.tensor([0, 1, 40], dtype=torch.int32)
    tables = TP._tables(cand, clen, branches, blen, subs)
    Bm = TP._backward_rows(cand, clen, branches, blen, subs, tables)
    rng = np.random.default_rng(6)
    dead = torch.arange(41) > blen[:, :, None]             # [B, R, S+1]
    noise = torch.from_numpy(
        rng.uniform(-1e3, 0, Bm.shape).astype(np.float32))
    Bm2 = torch.where(dead[None], noise, Bm)
    assert not torch.equal(Bm2, Bm)
    ref = TP._forward_scores(cand, branches, blen, bmask, subs, tables, Bm)
    out = TP._forward_scores(cand, branches, blen, bmask, subs, tables, Bm2)
    for r, o in zip(ref, out):
        assert TP.bitwise_equal(r, o)
    sg = tables[1]
    for b in range(cand.shape[0]):
        tail = Bm[int(clen[b]):, b]                         # [n, R, S+1]
        assert torch.equal(torch.where(dead[b], 0.0, tail),
                           torch.where(dead[b], 0.0, sg[b]).expand_as(tail))
