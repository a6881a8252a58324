"""The HiFi read type end to end on the CPU: `flye_tpu_torch.main
--pacbio-hifi --device cpu` must write the same files, byte for byte,
as `flye_tpu.main --pacbio-hifi` on the same reads.

HiFi sets `use_minimizers=1` and `reads_base_alignment=1`: the
assembly's divergence estimation and overlap prefetch then score the
segments of every overlap with K5's plain version (on the card, K5).
30 kb genome with a 2 kb repeat in two copies, 20x of 10 kb reads at
0.5% error: the reads cross the repeat, and the file stays within a few
minutes on the CPU."""

import filecmp
import os

import pytest

import flye_tpu.main as jax_main
import flye_tpu_torch.main as torch_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

# every file flye_tpu.main writes, apart from its log and params.json
OUTPUTS = ["00-assembly/draft_assembly.fasta",
           "10-consensus/consensus.fasta",
           "20-repeat/repeat_graph_dump",
           "20-repeat/read_alignment_dump",
           "30-contigger/contigs.fasta",
           "30-contigger/contigs_stats.txt",
           "30-contigger/graph_final.gfa",
           "30-contigger/graph_final.gv",
           "30-contigger/graph_final.fasta",
           "30-contigger/scaffolds_links.txt",
           "40-polishing/filtered_contigs.fasta",
           "40-polishing/polished_stats.txt",
           "40-polishing/polished_edges.gfa",
           "assembly.fasta",
           "assembly_graph.gfa",
           "assembly_graph.gv",
           "assembly_info.txt"]


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hifi")
    genome = random_genome(30000, seed=3, repeat_spec=[(2000, 2)])
    reads = simulate_reads(genome, coverage=20, mean_length=10000,
                           error_rate=0.005, seed=5)
    path = str(d / "reads.fa")
    write_fasta(reads, path)
    common = ["--pacbio-hifi", path, "-g", "30k"]
    assert jax_main.main(common + ["-o", str(d / "jax"),
                                   "--shards", "1"]) == 0
    assert torch_main.main(common + ["-o", str(d / "torch"),
                                     "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("rel", OUTPUTS)
def test_hifi_outputs_byte_identical(runs, rel):
    ref, out = runs / "jax" / rel, runs / "torch" / rel
    assert os.path.exists(ref)   # scaffolds_links.txt may be empty
    assert filecmp.cmp(ref, out, shallow=False)


def test_hifi_assembly_is_full_length(runs):
    assert os.path.getsize(runs / "torch" / "assembly.fasta") > 30000
