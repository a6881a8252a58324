"""flye_tpu_torch's hash-sharded k-mer index against the JAX package's.

`ShardedKmerIndex.shard_of` takes the uint64 hash modulo the shard
count; the port's hash is the int64 bit pattern, and a signed modulo of
it picks another shard for about half the k-mers at 3 or 5 shards (at 2,
4 or 8 the low bits agree), so the odd counts are the ones that tell.
The host-shard, minimizer-mesh and solid-mesh builds must give the JAX
package's arrays field for field; the JAX mesh builds run on the suite's
virtual CPU devices, the port's on a mesh naming the one CPU n times."""

import numpy as np
import pytest

from flye_tpu.index import KmerIndex as JaxIndex
from flye_tpu.index.sharded import ShardedKmerIndex as JaxSharded
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.overlap import OverlapEngine as JaxEngine
from flye_tpu.parallel import make_mesh as jax_make_mesh
from flye_tpu_torch.index import KmerIndex
from flye_tpu_torch.index.sharded import ShardedKmerIndex
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.overlap import OverlapEngine
from flye_tpu_torch.parallel import ParallelContext, make_mesh, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from test_torch_kmers import _assert_same_index
from torch_threads import one_torch_thread  # noqa: F401

SOLID = dict(select_rate=0.1, tandem_freq=10, global_min_freq=2)


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture(scope="module")
def stores():
    """tests/test_sharded_index.py's reads, in both packages' stores."""
    genome = random_genome(15000, seed=801)
    reads = simulate_reads(genome, coverage=10, mean_length=4000,
                           min_length=1500, error_rate=0.03,
                           circular=False, seed=802)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    return js, ts


def _assert_same_sharded(ref, out):
    _assert_same_index(ref, out)
    assert out.n_shards == ref.n_shards
    if ref.shard_row_base is None:
        assert out.shard_row_base is None
    else:
        np.testing.assert_array_equal(out.shard_row_base,
                                      ref.shard_row_base)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_shard_of_matches_jax(n):
    rng = np.random.default_rng(n)
    kmers = np.concatenate([rng.integers(0, 1 << 62, 20000,
                                         dtype=np.int64),
                            np.asarray([0, 1, (1 << 62) - 1])])
    ref = JaxSharded.shard_of(kmers, n)
    out = ShardedKmerIndex.shard_of(kmers, n)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    assert set(np.unique(out)) == set(range(n))


def _build(pkg, kind, store, n):
    """One build of `kind` at n shards in the JAX package or the port."""
    if pkg == "jax":
        cls, mesh = JaxSharded, (jax_make_mesh(n, axes=("data",))
                                 if kind != "host" else None)
    else:
        cls, mesh = ShardedKmerIndex, (make_mesh(n, devices=["cpu"] * n)
                                       if kind != "host" else None)
    if kind == "host":
        return cls.build_minimizers(store, 15, 5, n_shards=n)
    if kind == "minimizer-mesh":
        return cls.build_minimizers_mesh(store, 15, 5, mesh)
    return cls.build_solid_mesh(store, 17, mesh, **SOLID)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("kind", ["host", "minimizer-mesh", "solid-mesh"])
def test_builds_match_jax(stores, kind, n):
    js, ts = stores
    ref = _build("jax", kind, js, n)
    out = _build("torch", kind, ts, n)
    assert ref.num_kmers > 0
    _assert_same_sharded(ref, out)


def test_queries_match_jax(stores):
    """lookup, kmer_freq and probe_batch (the device probe through the
    globally sorted view and its row map) give JAX's answers."""
    js, ts = stores
    ref = _build("jax", "minimizer-mesh", js, 3)
    out = _build("torch", "minimizer-mesh", ts, 3)
    rng = np.random.default_rng(0)
    q = np.concatenate([
        np.asarray(ref.uniq_kmers)[rng.integers(0, ref.num_kmers, 300)],
        rng.integers(0, 1 << 30, 100).astype(np.int64)])
    for a, b in zip(ref.lookup(q), out.lookup(q)):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(out.kmer_freq(q), ref.kmer_freq(q))
    np.testing.assert_array_equal(out.is_repetitive(q),
                                  ref.is_repetitive(q))
    lens = np.asarray([ts.length(s) for s in ts.ids()[:6]], np.int32)
    batch = np.zeros((6, int(lens.max())), np.uint8)
    for i, s in enumerate(ts.ids()[:6]):
        batch[i, :lens[i]] = ts.get(s)
    for a, b in zip(ref.probe_batch(batch, lens),
                    out.probe_batch(batch, lens)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_sharded_matches_plain(stores):
    """tests/test_sharded_index.py's first case, and its JAX twin."""
    js, ts = stores
    plain = KmerIndex.build_minimizers(ts, 15, 5)
    sharded = ShardedKmerIndex.build_minimizers(ts, 15, 5, n_shards=4)
    assert sharded.num_kmers == plain.num_kmers
    assert sharded.index_size == plain.index_size
    rng = np.random.default_rng(0)
    queries = np.concatenate([
        np.asarray(plain.uniq_kmers)[rng.integers(0, plain.num_kmers, 50)],
        rng.integers(0, 2 ** 30, 20).astype(np.int64)])
    np.testing.assert_array_equal(sharded.kmer_freq(queries),
                                  plain.kmer_freq(queries))
    _assert_same_sharded(JaxSharded.build_minimizers(js, 15, 5,
                                                     n_shards=4), sharded)


def test_mesh_build_matches_host_shard_build(stores):
    """tests/test_sharded_index.py's second case: the mesh build equals
    the host shard build (same shards, same posting order), at 8 shards
    as the JAX case's 8 devices, and both equal JAX's."""
    js, ts = stores
    host = ShardedKmerIndex.build_minimizers(ts, 15, 5, n_shards=8)
    dev = ShardedKmerIndex.build_minimizers_mesh(
        ts, 15, 5, make_mesh(8, devices=["cpu"] * 8))
    _assert_same_sharded(host, dev)
    _assert_same_sharded(
        JaxSharded.build_minimizers_mesh(js, 15, 5, jax_make_mesh(
            8, axes=("data",))), dev)


def _overlaps(engine_cls, store, index):
    eng = engine_cls(store, index, max_jump=1500, min_overlap=1500,
                     max_overhang=1500)
    return {sid: sorted((o.ext_id, o.cur_begin, o.cur_end, o.ext_begin,
                         o.ext_end) for o in eng.get_overlaps(store, sid))
            for sid in store.ids()[:10]}


def test_sharded_engine_equivalence(stores):
    """tests/test_sharded_index.py's third case: the engine's overlaps
    with an 8-shard index (probed on the device path) equal those with
    the plain index, and JAX's."""
    js, ts = stores
    sharded = ShardedKmerIndex.build_minimizers(ts, 15, 5, n_shards=8)
    assert sharded.probe_stream_host(ts, ts.ids()[:2]) is None
    out = _overlaps(OverlapEngine, ts, sharded)
    assert out == _overlaps(OverlapEngine, ts,
                            KmerIndex.build_minimizers(ts, 15, 5))
    assert out == _overlaps(JaxEngine, js, JaxSharded.build_minimizers(
        js, 15, 5, n_shards=8))
    assert sum(len(v) for v in out.values()) > 0


def test_plain_jax_index_agrees(stores):
    """The plain builds agree across packages on these reads (the
    sharded ones above hold the same postings in shard-major order)."""
    js, ts = stores
    _assert_same_index(JaxIndex.build_minimizers(js, 15, 5),
                       KmerIndex.build_minimizers(ts, 15, 5))
