"""The ported slice end to end on the CPU: reads -> disjointigs ->
consensus through `flye_tpu_torch.main --device cpu` must write the
same files, byte for byte, as `flye_tpu.main` on the same reads.

40 kb genome at 25x with 15 kb mean reads: large enough that wide
match groups reach both chain-DP buckets (4096 and 16384 matches)."""

import filecmp
import os

import pytest

import flye_tpu.main as jax_main
import flye_tpu_torch.main as torch_main
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads

OUTPUTS = ["00-assembly/draft_assembly.fasta",
           "10-consensus/consensus.fasta"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    genome = random_genome(40000, seed=3)
    reads = simulate_reads(genome, coverage=25, mean_length=15000,
                           error_rate=0.08, error_mix=(0.2, 0.5, 0.3),
                           seed=5)
    path = str(d / "reads.fa")
    write_fasta(reads, path)
    common = ["--pacbio-raw", path, "-g", "40k", "--stop-after",
              "consensus"]
    assert jax_main.main(common + ["-o", str(d / "jax"),
                                   "--shards", "1"]) == 0
    assert torch_main.main(common + ["-o", str(d / "torch"),
                                     "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("rel", OUTPUTS)
def test_slice_outputs_byte_identical(runs, rel):
    ref, out = runs / "jax" / rel, runs / "torch" / rel
    assert os.path.getsize(ref) > 40000
    assert filecmp.cmp(ref, out, shallow=False)


def test_later_stages_not_yet_ported(tmp_path):
    """A run that does not stop at consensus is refused up front."""
    rc = torch_main.main(["--pacbio-raw", str(tmp_path / "none.fa"),
                          "-o", str(tmp_path / "out"), "--device",
                          "cpu"])
    assert rc == 1
    with open(tmp_path / "out" / "flye.log") as f:
        assert "not yet ported" in f.read()


def test_cuda_device_without_card_raises():
    import torch

    from flye_tpu_torch.parallel.runtime import init_runtime, set_runtime
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_runtime(device="cuda")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            init_runtime(n_shards=2, device="cpu")
    finally:
        set_runtime(None)
