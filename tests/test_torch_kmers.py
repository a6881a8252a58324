"""flye_tpu_torch k-mer selection and index builds vs the JAX package.

Exact equality throughout: the port keeps uint64 hashes as int64 bit
patterns, so the JAX uint64 outputs are compared viewed as int64."""

import numpy as np
import pytest
import torch

from flye_tpu.index import KmerIndex as JaxIndex
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.ops.kmers import splitmix64 as jax_splitmix64
from flye_tpu.ops.kmers import stream_select_packed as jax_select
from flye_tpu_torch.index import KmerIndex
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.ops.kmers import splitmix64, stream_select_packed
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _stream_chunks(lens, k, w, W, seed):
    """A random flat read stream cut into the index build's overlapping
    row layout (see KmerIndex._extract_selected)."""
    rng = np.random.default_rng(seed)
    starts = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    n_total = int(starts[-1])
    stream = rng.integers(0, 4, n_total).astype(np.uint8)
    step = W - (k - 1) - 2 * (w - 1)
    n_rows = max(1, -(-max(0, n_total - k + 1) // step))
    pad = np.zeros((w - 1) + n_rows * step + (W - step), np.uint8)
    pad[w - 1:w - 1 + n_total] = stream
    chunks = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        pad, shape=(n_rows, W), strides=(step, 1)))
    Sp = 1 << max(6, (len(starts) - 1).bit_length())
    starts_p = np.full(Sp, n_total, np.int64)
    starts_p[:len(starts)] = starts
    return chunks, starts_p, n_total, step


def test_splitmix64_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 62, 4096, dtype=np.int64)
    ref = np.asarray(jax_splitmix64(x)).view(np.int64)
    out = splitmix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("w", [1, 5, 10])
@pytest.mark.parametrize("sample", [1, 3])
def test_stream_select_packed_matches_jax(w, sample):
    k, W = 15, 256
    lens = np.array([700, 20, 0, 13, 1100, 15, 431], np.int64)
    chunks, starts, n_total, step = _stream_chunks(lens, k, w, W,
                                                   seed=w * 10 + sample)
    for r0 in (0, 2):
        rows = chunks[r0:r0 + 4]
        ref = np.asarray(jax_select(
            rows, starts, np.int64(r0), np.int64(n_total), k=k, w=w,
            sample=sample, step=step)).view(np.int64)
        out = stream_select_packed(
            torch.from_numpy(rows), torch.from_numpy(starts), r0,
            n_total, k=k, w=w, sample=sample, step=step).numpy()
        assert (ref != 0).any()
        np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def read_sets():
    genome = random_genome(20000, seed=31)
    reads = simulate_reads(genome, coverage=12, mean_length=3000,
                           min_length=1000, error_rate=0.08, seed=32)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    return js, ts


def _assert_same_index(ref, out):
    for name in KmerIndex.FIELDS:
        a, b = getattr(ref, name), getattr(out, name)
        if isinstance(a, float):
            assert a == b, name
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


def test_minimizer_index_matches_jax(read_sets):
    js, ts = read_sets
    ref = JaxIndex.build_minimizers(js, 15, 5)
    out = KmerIndex.build_minimizers(ts, 15, 5)
    assert ref.num_kmers > 0
    _assert_same_index(ref, out)


def test_solid_index_matches_jax(read_sets):
    js, ts = read_sets
    kw = dict(select_rate=0.1, tandem_freq=10, global_min_freq=2)
    ref = JaxIndex.build_solid(js, 17, **kw)
    out = KmerIndex.build_solid(ts, 17, **kw)
    assert ref.num_kmers > 0
    _assert_same_index(ref, out)


def test_from_numpy_round_trip(read_sets):
    js, ts = read_sets
    ref = JaxIndex.build_minimizers(js, 15, 5)
    out = KmerIndex.from_numpy(
        ts, 15, {n: getattr(ref, n) for n in KmerIndex.FIELDS})
    _assert_same_index(ref, out)
