"""flye_tpu_torch overlap engine vs the JAX package's, on one index.

Both engines get the same k-mer index (the port's via
KmerIndex.from_numpy) so the comparison isolates the engine and the
chain DP; host_dp_max = 0 sends every chain group through
chain_dp_multi (the K1 path) on both sides.  Overlaps must be
identical: ids, coordinates, score, divergence and anchors."""

import numpy as np
import pytest

from flye_tpu.index import KmerIndex as JaxIndex
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.overlap import OverlapEngine as JaxEngine
from flye_tpu_torch.index import KmerIndex
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.overlap import OverlapEngine
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture(scope="module")
def stores():
    genome = random_genome(30000, seed=41)
    reads = simulate_reads(genome, coverage=12, mean_length=6000,
                           min_length=2000, error_rate=0.08,
                           error_mix=(0.2, 0.5, 0.3), seed=42)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    return js, ts


def _as_tuples(res):
    return {sid: [(o.cur_id, o.ext_id, o.cur_begin, o.cur_end, o.cur_len,
                   o.ext_begin, o.ext_end, o.ext_len, o.score,
                   o.divergence, np.asarray(o.kmer_matches).tolist())
                  for o in ovlps] for sid, ovlps in res.items()}


@pytest.mark.parametrize("mode", ["assembly", "mapping"])
def test_overlaps_match_jax(stores, mode):
    js, ts = stores
    jidx = JaxIndex.build_solid(js, 17, select_rate=0.1, tandem_freq=10,
                                global_min_freq=2)
    tidx = KmerIndex.from_numpy(
        ts, 17, {n: getattr(jidx, n) for n in KmerIndex.FIELDS})
    if mode == "assembly":
        kw = dict(max_jump=1500, min_overlap=1000, max_overhang=1500,
                  only_max_ext=True)
        call = dict()
    else:
        kw = dict(max_jump=1500, min_overlap=500, max_overhang=0,
                  only_max_ext=False, max_divergence=0.5,
                  thin_anchors=False)
        call = dict(force_local=True)
    jeng = JaxEngine(js, jidx, **kw)
    teng = OverlapEngine(ts, tidx, **kw)
    jeng.host_dp_max = 0
    teng.host_dp_max = 0
    sids = js.ids()[:60]
    ref = _as_tuples(jeng.get_overlaps_batch(js, sids, **call))
    out = _as_tuples(teng.get_overlaps_batch(ts, sids, **call))
    assert sum(len(v) for v in ref.values()) > 50
    assert out == ref


def _overlap_pair(kmer_matches):
    from flye_tpu.overlap.structs import Overlap as JaxOverlap
    from flye_tpu_torch.overlap.structs import Overlap
    args = (0, 2, 100, 5100, 6000, 40, 5050, 5500)
    jo, to = JaxOverlap(*args), Overlap(*args)
    jo.kmer_matches = to.kmer_matches = kmer_matches
    return jo, to


@pytest.mark.parametrize("order", ["ascending", "shuffled", "ties",
                                   "empty"])
def test_anchors_for_equals_jax(order):
    """The overlap's anchors (its ends with the increasing k-mer matches
    strictly inside), in order and out of order, as the JAX package."""
    rng = np.random.default_rng(5)
    c = np.sort(rng.choice(np.arange(0, 5300), 80, replace=False))
    e = c - 60 + rng.integers(-3, 4, len(c))
    km = np.stack([c, e], axis=1).astype(np.int32)
    if order == "shuffled":
        km = km[rng.permutation(len(km))]
    elif order == "ties":
        km[10:14, 1] = km[10, 1]
        km[20:23, 0] = km[20, 0]
    elif order == "empty":
        km = km[:0]
    jo, to = _overlap_pair(km)
    ref = JaxEngine._anchors_for(None, jo)
    got = OverlapEngine._anchors_for(None, to)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert len(got) >= 2
