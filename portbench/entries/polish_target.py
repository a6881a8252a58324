"""Job kind "polish_target": the standalone polisher, as a user runs it,
`flye --polish-target draft.fasta --<read type> reads.fasta -o <dir> -i
1` on the card, through `flye_tpu_torch.main.main(argv)`, with fused
scoring (K4) selected.  The draft is the truth genome with the
configuration's `draft` errors, one record, drawn from the job's
"draft" stream.  The output judged is `polished_1.fasta`."""

import os

import gen

# the kernel libraries a polish job can launch: K1 (read mapping), K4,
# and K2+K3 for the buckets K4 does not take
KERNELS = ("chain_dp", "polish_fused", "polish_score")


def build_kernels():
    """Build and load every library of KERNELS on a CUDA machine, before
    the timer: the warm-up job may meet no bucket outside K4's, and a
    library first built in a timed job would time nvcc."""
    import torch
    if torch.cuda.is_available():
        from flye_tpu_torch.ops import _cuda
        for name in KERNELS:
            _cuda.lib(name)


def prepare(job_dir, genome, reads, config, traffic, rng):
    """Write the job's reads and draft; returns (argv, output FASTA,
    read bases).  Sets FLYE_TPU_FUSED=1 in this process's environment:
    the polisher reads it at each climb."""
    build_kernels()
    reads_path = os.path.join(job_dir, "reads.fasta")
    n = gen.write_fasta(reads, reads_path)
    draft = gen.apply_errors(genome, config["draft"]["error_rate"],
                             config["draft"]["error_mix"], rng)
    draft_path = os.path.join(job_dir, "draft.fasta")
    gen.write_fasta([("draft", draft)], draft_path)
    os.environ["FLYE_TPU_FUSED"] = "1"
    out = os.path.join(job_dir, "out")
    argv = ["--polish-target", draft_path, f"--{config['read_type']}",
            reads_path, "-o", out, "-i", "1", *config.get("flags", [])]
    return argv, os.path.join(out, "polished_1.fasta"), n
