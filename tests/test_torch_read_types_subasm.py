"""The subassembly overlay (`--subassemblies`: k = 31, w = 10
minimizers, base-level alignment) end to end on the CPU, byte-identical
to `flye_tpu` (see test_torch_read_types.py), and its k = 31 minimizer
index against the JAX package's: at k = 31 a canonical k-mer of 2^61 or
more fills the sign bit of its packed selection word, which the host
must unpack with a logical shift."""

import numpy as np
import pytest

from test_torch_read_types import (OUTPUTS, assert_same, cpu_runtime,  # noqa: F401
                                   read_type_runs)
from torch_threads import one_torch_thread  # noqa: F401


def test_k31_minimizer_index_matches_jax():
    from flye_tpu.index import KmerIndex as JaxIndex
    from flye_tpu.io import SequenceStore as JaxStore
    from flye_tpu_torch.index import KmerIndex
    from flye_tpu_torch.io import SequenceStore
    from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
    genome = random_genome(8000, seed=3)
    reads = simulate_reads(genome, coverage=8, mean_length=3000,
                           error_rate=0.01, seed=5)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    ref = JaxIndex.build_minimizers(js, 31, 10, min_cov=1)
    out = KmerIndex.build_minimizers(ts, 31, 10, min_cov=1)
    assert (np.asarray(ref.uniq_kmers) >= 1 << 61).any()
    for name in KmerIndex.FIELDS:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(out, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return read_type_runs(tmp_path_factory.mktemp("subasm"),
                          ["--subassemblies"], 14000, 16, 6000, 0.01)


@pytest.mark.parametrize("rel", OUTPUTS)
def test_subassemblies_byte_identical(runs, rel):
    assert_same(runs, rel)
