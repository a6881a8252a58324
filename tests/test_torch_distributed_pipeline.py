"""flye_tpu_torch's production pipeline on a device mesh, against the
JAX package's on its 8 virtual CPU devices.

The counterpart of tests/test_distributed_pipeline.py: with the
runtime's mesh active (8 shards of the one CPU device,
`make_mesh(8, devices=["cpu"] * 8)`) the index builds route to the
posting exchange (`ShardedKmerIndex`), and the flat-stream extraction,
chain DP and bubble climb split their rows over the mesh.  The results
must equal the port's one-device run and the JAX package's mesh run:
disjointigs byte for byte, polish candidates exact and scores to
1e-6."""

import numpy as np
import pytest

from flye_tpu.config import Config as JaxConfig
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.parallel import ParallelContext as JaxContext
from flye_tpu.parallel import make_mesh as jax_make_mesh
from flye_tpu.parallel import set_runtime as jax_set_runtime
from flye_tpu_torch.config import Config
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.parallel import (ParallelContext, get_runtime,
                                     make_mesh, set_runtime)
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

N_DEV = 8


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)
    jax_set_runtime(None)


def _with_mesh(n):
    """The port's runtime on n shards of the CPU (n = 1: no mesh)."""
    set_runtime(ParallelContext("cpu", mesh=make_mesh(
        n, devices=["cpu"] * n)) if n > 1 else ParallelContext("cpu"))


@pytest.fixture(scope="module")
def read_stores():
    """tests/test_distributed_pipeline.py's reads."""
    genome = random_genome(20000, seed=901)
    reads = simulate_reads(genome, coverage=12, mean_length=5000,
                           min_length=2000, error_rate=0.05,
                           circular=True, seed=902)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    return js, ts


def test_assemble_stage_mesh_identical(read_stores):
    """assemble_disjointigs through an 8-shard mesh == the port's one
    device == the JAX package's 8-device mesh, byte for byte."""
    from flye_tpu.assemble import assemble_disjointigs as jax_assemble
    from flye_tpu_torch.assemble import assemble_disjointigs

    js, ts = read_stores
    jax_set_runtime(JaxContext(jax_make_mesh(N_DEV, axes=("data",))))
    ref = jax_assemble(js, JaxConfig("raw", min_overlap=2000))
    jax_set_runtime(None)
    results = {}
    for n in (1, N_DEV):
        _with_mesh(n)
        results[n] = assemble_disjointigs(ts, Config("raw",
                                                     min_overlap=2000))
    assert len(ref) >= 1
    for out in results.values():
        assert len(out) == len(ref)
        for (n1, s1), (n2, s2) in zip(ref, out):
            assert n1 == n2
            np.testing.assert_array_equal(np.asarray(s1), s2)


def _canon_postings(ix):
    """The posting multiset of each k-mer (the shard-major key order
    aside)."""
    out = {}
    u = np.asarray(ix.uniq_kmers)
    for r in range(ix.num_kmers):
        s, e = ix.offsets[r], ix.offsets[r + 1]
        out[int(u[r])] = sorted(zip(ix.post_seq[s:e].tolist(),
                                    ix.post_pos[s:e].tolist(),
                                    ix.post_flip[s:e].tolist()))
    return out


def test_index_build_routes_to_mesh(read_stores):
    """build_minimizer_index returns the mesh-built hash-sharded index
    on an active mesh, answering as the plain one and as JAX's."""
    from flye_tpu.index import build_minimizer_index as jax_build
    from flye_tpu_torch.index import KmerIndex, build_minimizer_index
    from flye_tpu_torch.index.sharded import ShardedKmerIndex

    js, ts = read_stores
    _with_mesh(N_DEV)
    assert get_runtime().active and get_runtime().n_devices == N_DEV
    idx = build_minimizer_index(ts, 15, 5)
    assert isinstance(idx, ShardedKmerIndex)
    jax_set_runtime(JaxContext(jax_make_mesh(N_DEV, axes=("data",))))
    ref = jax_build(js, 15, 5)
    jax_set_runtime(None)
    np.testing.assert_array_equal(idx.uniq_kmers, np.asarray(ref.uniq_kmers))
    np.testing.assert_array_equal(idx.post_pos, ref.post_pos)
    _with_mesh(1)
    plain = KmerIndex.build_minimizers(ts, 15, 5)
    assert (idx.num_kmers, idx.index_size) == (plain.num_kmers,
                                               plain.index_size)
    q = np.asarray(plain.uniq_kmers)[
        np.random.default_rng(0).integers(0, plain.num_kmers, 64)]
    np.testing.assert_array_equal(idx.kmer_freq(q), plain.kmer_freq(q))
    assert _canon_postings(idx) == _canon_postings(plain)


def test_solid_index_build_routes_to_mesh(read_stores):
    """The raw-read (solid-k-mer) build routes to the mesh build too,
    with the plain build's postings per k-mer and JAX's arrays."""
    from flye_tpu.index import build_solid_index as jax_build
    from flye_tpu_torch.index import build_solid_index
    from flye_tpu_torch.index.sharded import ShardedKmerIndex

    js, ts = read_stores
    kw = dict(select_rate=0.4, tandem_freq=10)
    _with_mesh(N_DEV)
    idx = build_solid_index(ts, 15, **kw)
    assert isinstance(idx, ShardedKmerIndex)
    jax_set_runtime(JaxContext(jax_make_mesh(N_DEV, axes=("data",))))
    ref = jax_build(js, 15, **kw)
    jax_set_runtime(None)
    for name in ("uniq_kmers", "offsets", "post_seq", "post_pos",
                 "post_flip", "repetitive", "shard_row_base"):
        np.testing.assert_array_equal(getattr(idx, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _with_mesh(1)
    assert _canon_postings(idx) == _canon_postings(
        build_solid_index(ts, 15, **kw))


def _bubbles():
    """tests/test_distributed_pipeline.py's polish batch."""
    from flye_tpu_torch.polishing.matrices import get_subs_matrix
    rng = np.random.default_rng(7)
    B, Cb, R, S = 32, 96, 8, 96
    true = rng.integers(0, 4, size=(B, 64)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :64] = true
    idx = rng.integers(0, 64, size=(B, 3))
    for i in range(B):
        cand[i, idx[i]] = (cand[i, idx[i]] + 1) % 4
    clen = np.full(B, 64, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :64] = true[:, None, :]
    blen = np.full((B, R), 64, np.int32)
    bmask = np.ones((B, R), bool)
    return cand, clen, branches, blen, bmask, get_subs_matrix("pacbio")


@pytest.mark.parametrize("route", ["native", "plain", "resident"])
def test_polish_kernel_mesh_identical(route):
    """The bubble climb with its lanes split over the mesh == one
    device == the JAX package's mesh-sharded climb: the CPU default
    (the native climber in both packages), and the block-parallel
    schedule on the plain scoring, host-stepped and device-resident
    (eager on the CPU), against JAX's jnp program."""
    from flye_tpu.ops.polish import polish_bubbles as jax_polish
    from flye_tpu_torch.ops.polish import polish_bubbles

    cand, clen, branches, blen, bmask, subs = _bubbles()
    jax_set_runtime(JaxContext(jax_make_mesh(N_DEV, axes=("data",))))
    jc, jl, js, _ = jax_polish(
        cand.copy(), clen, branches, blen, bmask, subs, max_iters=32,
        **({} if route == "native" else {"use_pallas": False}))
    jax_set_runtime(None)
    kw = {"native": {}, "plain": {"use_kernel": False},
          "resident": {"resident": True}}[route]
    out = {}
    for n in (1, N_DEV):
        _with_mesh(n)
        out[n] = polish_bubbles(cand.copy(), clen, branches, blen, bmask,
                                subs, max_iters=32, **kw)
    for c, ln, sc, _ in out.values():
        np.testing.assert_array_equal(c, np.asarray(jc))
        np.testing.assert_array_equal(ln, np.asarray(jl))
        np.testing.assert_allclose(sc, np.asarray(js), rtol=1e-6)
    for a, b in zip(out[1], out[N_DEV]):
        np.testing.assert_array_equal(a, b)
