"""flye_tpu_torch's device mesh and its collectives against the JAX
package's, on the CPU.

The JAX side runs on meshes of the suite's 8 virtual CPU devices; the
port's meshes name the one CPU device as many times (`make_mesh(n,
devices=["cpu"] * n)`).  The pipeline step (`sharded_pipeline_step`:
minimizer histogram psum + chain DP) and the posting exchange
(`posting_exchange_step`: all_to_all + per-shard sort) must give the
JAX package's arrays exactly, at 3 shards too: shard ownership is a
uint64 modulo, which a signed modulo of the int64 bit patterns gets
wrong unless the shard count is a power of two."""

import jax
import numpy as np
import pytest
import torch

from flye_tpu.ops.kmers import kmer_hashes as jax_kmer_hashes
from flye_tpu.ops.kmers import minimizer_mask as jax_minimizer_mask
from flye_tpu.parallel import make_mesh as jax_make_mesh
from flye_tpu.parallel import posting_exchange_step as jax_exchange
from flye_tpu.parallel import sharded_pipeline_step as jax_step
from flye_tpu.parallel.mesh import SENTINEL as JAX_SENTINEL
from flye_tpu_torch.ops.kmers import kmer_hashes, minimizer_mask
from flye_tpu_torch.parallel import (ParallelContext, make_mesh,
                                     posting_exchange_step, set_runtime,
                                     sharded_pipeline_step)
from flye_tpu_torch.parallel.mesh import SENTINEL
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def step_inputs():
    """tests/test_mesh.py's input (its generator and shapes), 24 rows so
    that 1, 2, 3, 4 and 8 shards all divide them."""
    rng = np.random.default_rng(42)
    B, L, M = 24, 256, 64
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[::5] = L - 37          # a few short reads: invalid tails
    cur = np.sort(rng.integers(0, 4000, size=(B, M)), axis=1).astype(
        np.int32)
    ext = (cur + 100).astype(np.int32)
    nmatch = np.full(B, M, np.int32)
    nmatch[1::3] = M // 2
    return codes, lengths, cur, ext, nmatch


@pytest.fixture(scope="module")
def jax_step_ref(step_inputs):
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = {}
    for n in (1, 2, 3, 4, 8):
        mesh = jax_make_mesh(n, axes=("data",))
        fn, _ = jax_step(mesh, k=15, w=5)
        sh = NamedSharding(mesh, P("data"))
        hist, score, parent, n_sel = fn(
            *(jax.device_put(x, sh) for x in step_inputs))
        out[n] = (np.asarray(hist), np.asarray(score), np.asarray(parent),
                  int(n_sel))
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_pipeline_step_matches_jax(step_inputs, jax_step_ref, n):
    fn, _ = sharded_pipeline_step(_cpu_mesh(n), k=15, w=5)
    hist, score, parent, n_sel = fn(*step_inputs)
    ref = jax_step_ref[n]
    np.testing.assert_array_equal(hist.numpy(), ref[0])
    np.testing.assert_array_equal(score.numpy(), ref[1])
    np.testing.assert_array_equal(parent.numpy(), ref[2])
    assert int(n_sel) == ref[3]
    # and the same at every shard count
    np.testing.assert_array_equal(ref[0], jax_step_ref[1][0])
    assert ref[3] == jax_step_ref[1][3]


def test_example_args_split_over_the_mesh():
    mesh = _cpu_mesh(3)
    fn, make_args = sharded_pipeline_step(mesh)
    args = make_args(batch_per_shard=2, seed=5)
    assert args[0].shape == (6, 256)
    _, score, _, n_sel = fn(*args)
    assert score.shape == (6, 64) and int(n_sel) > 0
    with pytest.raises(ValueError, match="do not split"):
        fn(*(a[:5] for a in args))


def _postings(n, seed):
    """k-mers up to 2^62 (k = 31) with repeats, and packed payloads."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 62, n // 3, dtype=np.int64)
    kmers = np.concatenate([base, base[rng.integers(0, len(base),
                                                    n - len(base))]])
    payload = ((rng.integers(0, 1 << 20, n).astype(np.int64) << 33)
               | (rng.integers(0, 1 << 31, n).astype(np.int64) << 1)
               | rng.integers(0, 2, n).astype(np.int64))
    return kmers, payload


@pytest.mark.parametrize("n_dev,slack", [(3, 2.0), (8, 2.0), (3, 0.5),
                                         (8, 0.5)])
def test_posting_exchange_matches_jax(n_dev, slack):
    kmers, payload = _postings(5000, seed=n_dev)
    n_per_dev = -(-len(kmers) // n_dev)
    cap = int(n_per_dev / n_dev * slack) + 16
    jfn, jprep = jax_exchange(jax_make_mesh(n_dev, axes=("data",)),
                              n_per_dev, cap)
    jk, jp, jdrop, jrecv = jfn(*jprep(kmers.astype(np.uint64), payload))
    fn, prep = posting_exchange_step(_cpu_mesh(n_dev), n_per_dev, cap)
    sk, sp, drop, recv = fn(*prep(kmers, payload))
    np.testing.assert_array_equal(sk.numpy(),
                                  np.asarray(jk).view(np.int64))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    np.testing.assert_array_equal(recv.numpy(), np.asarray(jrecv))
    assert JAX_SENTINEL.view(np.int64) == SENTINEL
    if slack < 1:
        assert drop.sum() > 0    # the cap drops postings here
    else:
        assert drop.sum() == 0
        assert recv.sum() == len(kmers)


@pytest.mark.parametrize("k,w", [(15, 5), (31, 5)])
def test_kmer_hashes_and_minimizers_match_jax(k, w):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (6, 200)).astype(np.uint8)
    lens = np.asarray([200, 0, k - 1, k, 120, 199], np.int32)
    jc, jh, jv = jax_kmer_hashes(codes, lens, k)
    c, h, v = kmer_hashes(torch.from_numpy(codes), torch.from_numpy(lens),
                          k)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh).view(np.int64))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for ww in (1, w):
        np.testing.assert_array_equal(
            minimizer_mask(h, v, ww).numpy(),
            np.asarray(jax_minimizer_mask(jh, jv, ww)))
