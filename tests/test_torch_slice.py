"""The ported pipeline end to end on the CPU: reads -> disjointigs ->
consensus -> repeat graph -> contigs -> polished assembly through
`flye_tpu_torch.main --device cpu` must write the same files, byte for
byte, as `flye_tpu.main` on the same reads.

40 kb genome at 25x with 15 kb mean reads: large enough that wide
match groups reach both chain-DP buckets (4096 and 16384 matches)."""

import filecmp
import os
import shutil

import pytest
import torch

import flye_tpu.main as jax_main
import flye_tpu_torch.main as torch_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.parallel.runtime import (ParallelContext, get_runtime,
                                             set_runtime)
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
    d = tmp_path_factory.mktemp("slice")
    genome = random_genome(40000, seed=3)
    reads = simulate_reads(genome, coverage=25, mean_length=15000,
                           error_rate=0.08, error_mix=(0.2, 0.5, 0.3),
                           seed=5)
    path = str(d / "reads.fa")
    write_fasta(reads, path)
    common = ["--pacbio-raw", path, "-g", "40k"]
    assert jax_main.main(common + ["-o", str(d / "jax"),
                                   "--shards", "1"]) == 0
    assert torch_main.main(common + ["-o", str(d / "torch"),
                                     "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("rel", OUTPUTS)
def test_slice_outputs_byte_identical(runs, rel):
    ref, out = runs / "jax" / rel, runs / "torch" / rel
    assert os.path.exists(ref)   # scaffolds_links.txt may be empty
    assert filecmp.cmp(ref, out, shallow=False)


def test_slice_sequences_are_full_length(runs):
    for rel in OUTPUTS[:2] + ["assembly.fasta"]:
        assert os.path.getsize(runs / "torch" / rel) > 40000, rel


def test_slice_job_record_has_its_spans_and_counters(runs):
    """The port's run left its job record: the spans its CPU path
    opens, the setup and every stage among them, and its counters."""
    from flye_tpu_torch.utils import trace
    rec = trace.job_record(str(runs / "torch"))
    spans = rec["spans"]
    for name in ("job", "pipeline: setup", "reads: load",
                 "stage configure", "stage assembly", "stage consensus",
                 "stage repeat", "stage contigger", "stage polishing",
                 "stage finalize", "index build", "divergence estimation",
                 "overlap prefetch", "disjointig extension",
                 "sequence generation", "overlap: probe", "overlap: gather",
                 "overlap: prep", "overlap: chain dp",
                 "overlap: chain dp host", "overlap: finish",
                 "overlap: device wait", "polishing iteration 1/1",
                 "polish: read mapping", "polish: bubble extraction",
                 "polish: bubble kernels", "bubbles: pack", "climb: native",
                 "bubbles: write-back", "polish: homopolymer/dinucleotide"):
        assert spans[name]["calls"] >= 1, name
    assert spans["job"]["calls"] == 1
    assert rec["wall_s"] == spans["job"]["total_s"]
    assert all(0 <= s["self_s"] <= s["total_s"] + 1e-9
               for s in spans.values())
    c = rec["counters"]
    for name in ("reads.count", "reads.bases", "overlap.queries",
                 "overlap.batches", "overlap.k1_rows", "overlap.kept",
                 "polish.bubbles", "climb.batches", "climb.lane_steps"):
        assert c[name] > 0, name
    assert c["reads.bases"] > 25 * 40_000 * 0.9
    assert 0 < c["climb.lane_steps_used"] <= c["climb.lane_steps"]
    # the CPU path reads nothing back from a card, captures no graph
    assert "device.readbacks" not in c and "climb.captures" not in c


@pytest.mark.parametrize("stage", ["contigger", "polishing"])
def test_resume_reproduces_assembly(runs, stage):
    """A run resumed at the contigger reloads the repeat stage's graph
    and alignment dumps; one resumed at polishing reloads the
    contigger's state from its files.  Both write the same final
    assembly."""
    d = runs / f"resumed_{stage}"
    shutil.copytree(runs / "torch", d)
    for rel in ("assembly.fasta", "assembly_info.txt",
                "assembly_graph.gfa"):
        os.remove(d / rel)
    rc = torch_main.main(["--pacbio-raw", str(runs / "reads.fa"), "-g",
                          "40k", "-o", str(d), "--device", "cpu",
                          "--resume-from", stage])
    assert rc == 0
    for rel in ("assembly.fasta", "assembly_info.txt",
                "assembly_graph.gfa"):
        assert filecmp.cmp(runs / "torch" / rel, d / rel,
                           shallow=False), rel


def test_polish_target_byte_identical(runs):
    """The standalone polisher, two iterations on the run's draft
    assembly, writes the same polished sequences as `flye_tpu`."""
    draft = str(runs / "jax" / "00-assembly" / "draft_assembly.fasta")
    common = ["--polish-target", draft, "--pacbio-raw",
              str(runs / "reads.fa"), "-i", "2"]
    assert jax_main.main(common + ["-o", str(runs / "pt_jax")]) == 0
    assert torch_main.main(common + ["-o", str(runs / "pt_torch"),
                                     "--device", "cpu"]) == 0
    for rel in ("polished_1.fasta", "polished_2.fasta"):
        assert os.path.getsize(runs / "pt_torch" / rel) > 40000, rel
        assert filecmp.cmp(runs / "pt_jax" / rel, runs / "pt_torch" / rel,
                           shallow=False), rel


def test_cuda_device_without_card_raises():
    import torch

    from flye_tpu_torch.parallel.runtime import init_runtime
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_runtime(device="cuda")
    # --device cpu sees one CPU: --shards 2 gives an inactive one-device
    # mesh, as the JAX package's runtime on one device
    rt = init_runtime(n_shards=2, device="cpu")
    assert not rt.active and rt.n_devices == 1
    assert rt.device == torch.device("cpu")


def test_library_runtime_defaults_to_cuda():
    """With no runtime installed, library entry points get the GPU and
    never fall back to the CPU quietly: without a card that raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    set_runtime(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_runtime()
