"""The port's read-type overlays end to end on the CPU against
`flye_tpu`: `flye_tpu_torch.main --device cpu` must write the same
assembly, graph, info and consensus files, byte for byte, as
`flye_tpu.main` on the same simulated reads.  One overlay a module:
`--nano-raw --meta` here (the raw overlay with the nanopore matrix and
`uneven_coverage`); the corrected overlay (`--nano-corr`) and the
subassembly overlay (`--subassemblies`), whose base-level alignment is
costly on the CPU, in test_torch_read_types_corr.py and
test_torch_read_types_subasm.py.  `--pacbio-corr` shares the corrected
overlay, and its PacBio matrix is covered by the raw tests."""

import filecmp

import pytest

import flye_tpu.main as jax_main
import flye_tpu_torch.main as torch_main
from flye_tpu_torch.io.fasta import read_seq_file, write_fasta
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

OUTPUTS = ("assembly.fasta", "assembly_graph.gfa", "assembly_info.txt",
           "10-consensus/consensus.fasta")


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def read_type_runs(d, flags, glen, coverage, mean_length, error_rate):
    """`flye_tpu` and the port on `random_genome(glen, seed=3)`'s reads
    (seed 5) with the read-type `flags`, into d/jax and d/torch."""
    genome = random_genome(glen, seed=3)
    reads = simulate_reads(genome, coverage=coverage,
                           mean_length=mean_length, error_rate=error_rate,
                           seed=5)
    path = str(d / "reads.fasta")
    write_fasta(reads, path)
    flag, *extra = flags
    common = [flag, path, "-g", f"{glen // 1000}k", *extra]
    assert jax_main.main(common + ["-o", str(d / "jax"),
                                   "--shards", "1"]) == 0
    assert torch_main.main(common + ["-o", str(d / "torch"),
                                     "--device", "cpu"]) == 0
    assert read_seq_file(str(d / "jax" / "assembly.fasta"))   # a contig
    return d


def assert_same(runs, rel):
    assert filecmp.cmp(runs / "jax" / rel, runs / "torch" / rel,
                       shallow=False), rel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return read_type_runs(tmp_path_factory.mktemp("nano_raw_meta"),
                          ["--nano-raw", "--meta"], 30000, 25, 8000, 0.08)


@pytest.mark.parametrize("rel", OUTPUTS)
def test_nano_raw_meta_byte_identical(runs, rel):
    assert_same(runs, rel)
