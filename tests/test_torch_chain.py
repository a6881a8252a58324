"""flye_tpu_torch chain DP (the K1 kernel's plain version) vs the JAX
package's lax.scan oracle.  Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

from flye_tpu.ops.chain import _chain_dp_scan as jax_scan
from flye_tpu.ops.chain import backtrack_chains as jax_backtrack
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.ops.chain import (backtrack_chains, chain_dp,
                                      chain_dp_multi)
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import K1_ROW_KINDS, k1_row_kinds


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def make_matches(T, M, rng, span=6000, noise=60):
    cur = np.sort(rng.integers(0, span, size=(T, M)), axis=1)
    ext = cur + 300 + rng.integers(-noise, noise, size=(T, M))
    nvalid = rng.integers(1, M + 1, size=T)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))


def _both(cur, ext, nvalid, k, max_jump, lookback):
    s_ref, p_ref = jax_scan(cur, ext, nvalid, k, max_jump, lookback)
    s, p = chain_dp(torch.from_numpy(cur), torch.from_numpy(ext),
                    torch.from_numpy(nvalid), k, max_jump, lookback)
    return (np.asarray(s_ref), np.asarray(p_ref)), (s.numpy(), p.numpy())


@pytest.mark.parametrize("T,M,lookback", [
    (4, 96, 32), (3, 128, 16), (2, 100, 48), (9, 64, 64)])
def test_chain_dp_matches_jax(T, M, lookback):
    rng = np.random.default_rng(T * 1000 + M)
    (s_ref, p_ref), (s, p) = _both(*make_matches(T, M, rng), 15, 1500,
                                   lookback)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(p, p_ref)


@pytest.mark.parametrize("M,lookback,max_jump", [(512, 64, 1500),
                                                  (384, 16, 50)])
@pytest.mark.parametrize("kind", K1_ROW_KINDS)
def test_chain_dp_row_kinds(kind, M, lookback, max_jump):
    """The rows K1's window cut must handle (sorted by ext only, runs of
    equal keys, sorted on neither axis, dense rows capped by the
    lookback, key steps of exactly max_jump - 1 and max_jump)."""
    rng = np.random.default_rng(M + lookback)
    cur, ext, nvalid = k1_row_kinds(kind, 6, M, max_jump, rng)
    (s_ref, p_ref), (s, p) = _both(cur, ext, nvalid, 17, max_jump,
                                   lookback)
    assert (p_ref >= 0).any()
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(p, p_ref)


def test_chain_dp_empty_rows():
    rng = np.random.default_rng(5)
    cur, ext, _ = make_matches(3, 32, rng)
    nvalid = np.array([0, 32, 1], np.int32)
    (s_ref, p_ref), (s, p) = _both(cur, ext, nvalid, 15, 1500, 16)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(p, p_ref)
    assert (s[0] == 0).all() and (p[0] == -1).all()


def test_chain_dp_production_width():
    """The engine's shape: M = 4096 matches, L = 1024 lookback, k=17."""
    rng = np.random.default_rng(6)
    cur, ext, nvalid = make_matches(4, 4096, rng, span=150000)
    (s_ref, p_ref), (s, p) = _both(cur, ext, nvalid, 17, 1500, 1024)
    assert (p_ref >= 0).sum() > 1000
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(p, p_ref)


def test_chain_dp_multi_layout():
    rng = np.random.default_rng(7)
    specs = [make_matches(3, 64, rng), make_matches(2, 256, rng)]
    flat = chain_dp_multi([tuple(torch.from_numpy(a) for a in b)
                           for b in specs], 15, 1500, 1024).numpy()
    off = 0
    for cur, ext, nv in specs:
        s_ref, p_ref = jax_scan(cur, ext, nv, 15, 1500,
                                min(1024, cur.shape[1]))
        n = cur.size
        np.testing.assert_array_equal(flat[off:off + n].reshape(cur.shape),
                                      np.asarray(s_ref))
        np.testing.assert_array_equal(
            flat[off + n:off + 2 * n].reshape(cur.shape), np.asarray(p_ref))
        off += 2 * n
    assert off == len(flat)


def test_backtrack_matches_jax():
    rng = np.random.default_rng(8)
    cur, ext, nvalid = make_matches(3, 200, rng)
    s, p = jax_scan(cur, ext, nvalid, 15, 1500, 64)
    s, p = np.asarray(s), np.asarray(p)
    for t in range(3):
        ref = jax_backtrack(s[t], p[t], nvalid[t], 15)
        out = backtrack_chains(s[t], p[t], nvalid[t], 15)
        assert len(ref) > 0
        assert [(a, b, c, list(map(int, d))) for a, b, c, d in out] == \
            [(a, b, c, list(map(int, d))) for a, b, c, d in ref]


def test_cpu_tensors_take_plain_version():
    """A CPU tensor never reaches the kernel (no launch is counted)."""
    rng = np.random.default_rng(9)
    before = _cuda.LAUNCHES["chain_dp"]
    chain_dp(*(torch.from_numpy(a) for a in make_matches(2, 64, rng)),
             15, 1500, 32)
    assert _cuda.LAUNCHES["chain_dp"] == before
