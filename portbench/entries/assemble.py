"""Job kind "assemble": the whole pipeline, as a user runs it,
`flye --<read type> reads.fasta -g <genome length> -o <dir>` on the
card, through `flye_tpu_torch.main.main(argv)`.  The output judged is
`assembly.fasta`."""

import os

import gen


def prepare(job_dir, genome, reads, config, traffic, rng):
    """Write the job's inputs; returns (argv, output FASTA, read bases)."""
    reads_path = os.path.join(job_dir, "reads.fasta")
    n = gen.write_fasta(reads, reads_path)
    out = os.path.join(job_dir, "out")
    argv = [f"--{config['read_type']}", reads_path, "-g",
            str(len(genome)), "-o", out, *config.get("flags", [])]
    return argv, os.path.join(out, "assembly.fasta"), n
