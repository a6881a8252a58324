"""Short-plasmid recovery (`--plasmids`) ported:
`flye_tpu_torch.plasmids` against `flye_tpu.plasmids` on the inputs of
tests/test_plasmids.py (a 20 kb chromosome at 6x and a 3 kb circular
plasmid at 10x), with a tolerance of 0: equal read ids, equal
(read, circle length) pairs, equal plasmid names and bytes."""

import numpy as np
import pytest

import flye_tpu.plasmids.plasmids as jpl
import flye_tpu_torch.plasmids.plasmids as tpl
from flye_tpu.io import SequenceStore as JStore
from flye_tpu_torch.io import SequenceStore as TStore
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture(scope="module")
def inputs():
    """(reads, contigs) as each package's SequenceStore, from the same
    arrays."""
    chrom = random_genome(20000, seed=601)
    plasmid = random_genome(3000, seed=602)
    reads = [("chr_" + n, c) for n, c in simulate_reads(
        chrom, coverage=6, mean_length=5000, min_length=1500,
        error_rate=0.03, circular=False, seed=603)]
    reads += [("pl_" + n, c) for n, c in simulate_reads(
        plasmid, coverage=10, mean_length=4500, min_length=3500,
        error_rate=0.03, circular=True, seed=604)]
    out = {}
    for key, store in (("jax", JStore), ("torch", TStore)):
        r, c = store(), store()
        for name, codes in reads:
            r.add(name, codes)
        c.add("contig_1", chrom)
        out[key] = (r, c)
    return out


def test_find_unmapped_reads_equal(inputs):
    ref = jpl.find_unmapped_reads(*inputs["jax"])
    got = tpl.find_unmapped_reads(*inputs["torch"])
    assert [int(s) for s in got] == [int(s) for s in ref]
    reads = inputs["torch"][0]
    assert len(got) >= 3
    assert all(reads.name(s).startswith("pl_") for s in got)


def test_find_circular_reads_equal(inputs):
    unmapped = [int(s) for s in jpl.find_unmapped_reads(*inputs["jax"])]
    ref = jpl.find_circular_reads(inputs["jax"][0], unmapped)
    got = tpl.find_circular_reads(inputs["torch"][0], unmapped)
    assert [(int(s), int(n)) for s, n in got] == \
        [(int(s), int(n)) for s, n in ref]
    assert got


def test_recover_short_plasmids_equal(inputs):
    ref = jpl.recover_short_plasmids(*inputs["jax"], "pacbio")
    got = tpl.recover_short_plasmids(*inputs["torch"], "pacbio")
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert 1 <= len(got) <= 3
