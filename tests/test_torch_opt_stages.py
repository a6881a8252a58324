"""The optional stages end to end on the CPU: `flye_tpu_torch.main
--trestle --plasmids --device cpu` must write every file that
`flye_tpu.main --trestle --plasmids --shards 1` writes, byte for byte,
on the same reads, and so must runs of both resumed at `trestle` and at
`plasmids`.

Inputs: a 60 kb genome with an 8 kb two-copy repeat (the second copy
at 1% substitutions) at 30x, and a 3 kb plasmid read circular at 5x;
PacBio-raw reads, mean 8 kb, 8% error.  The plasmid stage recovers one
plasmid from them.  (At 100 kb the module took 152 s on an idle
machine, against 83 s at 60 kb, both on torch's default threads.)"""

import filecmp
import os
import shutil

import numpy as np
import pytest

import flye_tpu.main as jax_main
import flye_tpu_torch.main as torch_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

# every file flye_tpu.main writes with both stages, apart from its log
# and params.json
OUTPUTS = ["00-assembly/draft_assembly.fasta",
           "10-consensus/consensus.fasta",
           "20-repeat/repeat_graph_dump",
           "20-repeat/repeat_graph_dump_extra.fasta",
           "20-repeat/read_alignment_dump",
           "25-trestle/repeat_graph_dump",
           "25-trestle/repeat_graph_dump_extra.fasta",
           "30-contigger/contigs.fasta",
           "30-contigger/contigs_stats.txt",
           "30-contigger/graph_final.gfa",
           "30-contigger/graph_final.gv",
           "30-contigger/graph_final.fasta",
           "30-contigger/scaffolds_links.txt",
           "22-plasmids/plasmids.fasta",
           "40-polishing/filtered_contigs.fasta",
           "40-polishing/polished_stats.txt",
           "40-polishing/polished_edges.gfa",
           "assembly.fasta",
           "assembly_graph.gfa",
           "assembly_graph.gv",
           "assembly_info.txt"]
# per resume point, the outputs the resumed run writes anew (removed
# from the copy it resumes in)
RESUMED = {"trestle": [r for r in OUTPUTS if not r.startswith(
               ("00-", "10-", "20-"))],
           "plasmids": [r for r in OUTPUTS if not r.startswith(
               ("00-", "10-", "20-", "25-", "30-"))]}
FLAGS = ["--trestle", "--plasmids"]


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            if rel not in ("flye.log", "params.json"):
                out.add(rel)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("opt_stages")
    genome = random_genome(60_000, seed=3)
    rng = np.random.default_rng(103)
    unit = rng.integers(0, 4, 8000).astype(np.uint8)
    copy_b = unit.copy()
    snp = rng.random(len(unit)) < 0.01
    copy_b[snp] = (copy_b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    genome[12_000:20_000] = unit
    genome[38_000:46_000] = copy_b
    kw = dict(mean_length=8000, error_rate=0.08, error_mix=(0.2, 0.5, 0.3))
    reads = simulate_reads(genome, coverage=30, seed=5, **kw)
    reads += [("pl_" + n, c) for n, c in simulate_reads(
        random_genome(3000, seed=602), coverage=5, circular=True, seed=6,
        **kw)]
    path = str(d / "reads.fa")
    write_fasta(reads, path)
    common = ["--pacbio-raw", path, "-g", "60k"] + FLAGS
    assert jax_main.main(common + ["-o", str(d / "jax"),
                                   "--shards", "1"]) == 0
    with open(d / "jax" / "flye.log") as f:
        log = f.read()
    n = int(log.split("Recovered ")[1].split(" plasmids")[0])
    assert n >= 1, "flye_tpu recovered no plasmid from these reads"
    assert torch_main.main(common + ["-o", str(d / "torch"),
                                     "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("rel", OUTPUTS)
def test_opt_stages_outputs_byte_identical(runs, rel):
    ref, out = runs / "jax" / rel, runs / "torch" / rel
    assert os.path.exists(ref)
    assert filecmp.cmp(ref, out, shallow=False)


def test_opt_stages_write_the_same_files(runs):
    assert _files(runs / "torch") == _files(runs / "jax") == set(OUTPUTS)
    with open(runs / "torch" / "assembly_info.txt") as f:
        assert "plasmid_1\t" in f.read()


def test_graph_mean_coverage_equal(runs):
    """Trestle's mean coverage on resume, from the repeat stage's dump."""
    from flye_tpu.io.seqstore import SequenceStore as JStore
    from flye_tpu.repeat.graph import RepeatGraph as JGraph
    from flye_tpu_torch.io.seqstore import SequenceStore as TStore
    from flye_tpu_torch.repeat.graph import RepeatGraph as TGraph
    dump = runs / "jax" / "20-repeat" / "repeat_graph_dump"
    cons = str(runs / "jax" / "10-consensus" / "consensus.fasta")
    ref = jax_main._graph_mean_coverage(
        JGraph.load(JStore.from_file(cons), str(dump)))
    got = torch_main._graph_mean_coverage(
        TGraph.load(TStore.from_file(cons), str(dump)))
    assert got == ref >= 1


@pytest.mark.parametrize("stage", list(RESUMED))
def test_resumed_runs_byte_identical(runs, stage):
    """Each package's run resumed at `stage` (the files of that stage
    and later removed first) writes the same files as the other's."""
    for key, main, extra in (("jax", jax_main, ["--shards", "1"]),
                             ("torch", torch_main, ["--device", "cpu"])):
        d = runs / f"resumed_{stage}_{key}"
        shutil.copytree(runs / key, d)
        for rel in RESUMED[stage]:
            os.remove(d / rel)
        assert main.main(["--pacbio-raw", str(runs / "reads.fa"), "-g",
                          "60k", "-o", str(d), "--resume-from", stage]
                         + FLAGS + extra) == 0
    ref, out = runs / f"resumed_{stage}_jax", runs / f"resumed_{stage}_torch"
    assert _files(out) == _files(ref) == set(OUTPUTS)
    for rel in OUTPUTS:
        assert filecmp.cmp(ref / rel, out / rel, shallow=False), rel


FLAG_SETS = [[], ["--trestle"], ["--trestle", "--no-trestle"],
             ["--plasmids"], ["--meta", "--plasmids"]]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f)
                         or "none")
def test_job_list_equal(tmp_path, flags):
    names = {}
    for key, main in (("jax", jax_main), ("torch", torch_main)):
        args = main.build_parser().parse_args(
            ["--pacbio-raw", "reads.fa", "-o", str(tmp_path / key)] + flags)
        names[key] = [j.name for j in main.create_job_list(
            main.RunContext(args))]
    assert names["torch"] == names["jax"]
    assert ("trestle" in names["torch"]) == (flags == ["--trestle"])
    assert ("plasmids" in names["torch"]) == (flags == ["--plasmids"])
