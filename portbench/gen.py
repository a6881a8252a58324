"""The benchmark's input generator: a truth genome and its long reads,
drawn from (seed, job), with the read model of a configuration file.

The model is that of the port's simulator (`utils/simulate.py`), frozen
here so that no change to the program moves the yardstick: gamma(shape
4) read lengths with the configuration's mean and a minimum, starts
uniform on a circular genome (reads may wrap the origin), strand 50/50,
and errors at the configuration's rate with its sub/ins/del mix (an
insertion copies the base it precedes half of the time, else a uniform
base; a substitution moves the base by 1-3).  Each base draws its event
at once (vectorised), where the simulator draws a Poisson count of
sorted positions; the two agree in distribution.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# complement of codes 0-3 (A C G T)
COMPLEMENT = np.array([3, 2, 1, 0], np.uint8)
BASES = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int, job: int, part: str) -> np.random.Generator:
    """The generator of one part ("genome", "reads", "draft") of input
    `job` of a seed (a cell's pool draws its inputs from its pool seed
    and their index).  Any whole seed, negative or past 64 bits, maps
    to one stream."""
    tag = {"genome": 1, "reads": 2, "draft": 3}[part]
    s = int(seed) % (1 << 128)
    return np.random.default_rng(
        [s & (2**64 - 1), s >> 64, int(job), tag])


def random_genome(length: int, repeats, rng: np.random.Generator
                  ) -> np.ndarray:
    """A uniform random genome of `length` codes, with each (unit
    length, copies) of `repeats` pasted at uniform positions."""
    g = rng.integers(0, 4, size=length, dtype=np.uint8)
    for rep_len, copies in repeats:
        unit = rng.integers(0, 4, size=rep_len, dtype=np.uint8)
        for _ in range(copies):
            at = int(rng.integers(0, length - rep_len))
            g[at:at + rep_len] = unit
    return g


def apply_errors(seq: np.ndarray, rate: float, mix, rng) -> np.ndarray:
    """seq with each base, at probability `rate`, substituted, preceded
    by an inserted base or deleted, in the proportions of `mix`."""
    n = len(seq)
    if rate <= 0 or n == 0:
        return seq
    hit = rng.random(n) < rate
    kind = np.where(hit, rng.choice(3, size=n, p=list(mix)), -1)
    shift = rng.integers(1, 4, size=n, dtype=np.uint8)
    base = np.where(kind == 0, (seq + shift) % 4, seq).astype(np.uint8)
    same = rng.random(n) < 0.5
    ins_base = np.where(same, seq, rng.integers(0, 4, size=n,
                                                dtype=np.uint8))
    pair = np.stack([ins_base.astype(np.uint8), base], axis=1)
    keep = np.stack([kind == 1, kind != 2], axis=1)
    return pair[keep]


def simulate_reads(genome: np.ndarray, model: dict,
                   rng: np.random.Generator
                   ) -> List[Tuple[str, np.ndarray]]:
    """Reads of `genome` (circular) until their bases reach coverage x
    genome length: model keys coverage, mean_length, min_length,
    error_rate, error_mix."""
    glen = len(genome)
    target = int(model["coverage"] * glen)
    mean = float(model["mean_length"])
    genome2 = np.concatenate([genome] * 3)
    reads, total, i = [], 0, 0
    while total < target:
        length = int(rng.gamma(4.0, mean / 4.0))
        length = max(int(model["min_length"]), min(length, 2 * glen))
        start = int(rng.integers(0, glen))
        frag = genome2[start:start + length]
        strand = "+"
        if rng.random() < 0.5:
            frag = COMPLEMENT[frag[::-1]]
            strand = "-"
        read = apply_errors(frag, model["error_rate"], model["error_mix"],
                            rng)
        reads.append((f"read_{i}_pos{start}_len{length}{strand}", read))
        total += len(read)
        i += 1
    return reads


def write_fasta(records, path: str) -> int:
    """Write (name, codes) records; returns the bases written."""
    n = 0
    with open(path, "wb") as f:
        for name, codes in records:
            f.write(b">" + name.encode() + b"\n")
            f.write(BASES[codes].tobytes())
            f.write(b"\n")
            n += len(codes)
    return n


def read_fasta(path: str) -> List[Tuple[str, np.ndarray]]:
    """(name, codes) of a FASTA file; bases other than ACGT become 0."""
    lut = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
        lut[c + 32] = i
    out, name, parts = [], None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, lut[np.frombuffer(b"".join(parts),
                                                        np.uint8)]))
                name, parts = line[1:].split()[0].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        out.append((name, lut[np.frombuffer(b"".join(parts), np.uint8)]))
    return out


def make_job(seed: int, job: int, config: dict):
    """(genome, reads) of one job of a configuration."""
    genome = random_genome(int(config["genome_length"]),
                           config["repeats"], rng_for(seed, job, "genome"))
    reads = simulate_reads(genome, config["reads"],
                           rng_for(seed, job, "reads"))
    return genome, reads
