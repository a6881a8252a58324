"""The input generator: deterministic per (seed, job), and its reads
match the read model of the configuration."""

import re

import numpy as np
import pytest

import gen
import run


def config(name):
    return run.read_json(run.HERE, "configs", f"{name}.json")


def small(name, glen=40_000):
    c = config(name)
    c["genome_length"] = glen
    return c


@pytest.mark.parametrize("name", ["ecoli-pbraw-50x", "hg002-hifi-30x"])
def test_same_seed_same_inputs_other_seed_or_job_other_inputs(name):
    c = small(name)
    g1, r1 = gen.make_job(2**31 + 11, 1, c)
    g2, r2 = gen.make_job(2**31 + 11, 1, c)
    assert np.array_equal(g1, g2)
    assert len(r1) == len(r2)
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
               for a, b in zip(r1, r2))
    g3, _ = gen.make_job(2**31 + 11, 2, c)
    g4, _ = gen.make_job(2**31 + 12, 1, c)
    assert not np.array_equal(g1, g3)
    assert not np.array_equal(g1, g4)


def test_seeds_past_64_bits_and_negative_seeds_work():
    for seed in (-5, 2**70 + 3, 0):
        g = gen.random_genome(1000, [], gen.rng_for(seed, 1, "genome"))
        assert g.dtype == np.uint8 and len(g) == 1000


@pytest.mark.parametrize("name", ["ecoli-pbraw-50x", "hg002-hifi-30x"])
def test_coverage_and_mean_length_match_the_model(name):
    c = small(name, 200_000)
    genome, reads = gen.make_job(5, 1, c)
    model = c["reads"]
    total = sum(len(s) for _, s in reads)
    assert model["coverage"] * len(genome) <= total
    assert total <= model["coverage"] * len(genome) + 4 * model[
        "mean_length"]
    frag = np.array([int(re.search(r"_len(\d+)", n).group(1))
                     for n, _ in reads])
    assert frag.min() >= model["min_length"]
    # gamma(4) lengths: the mean within 4 standard errors
    se = model["mean_length"] / 2 / np.sqrt(len(frag))
    assert abs(frag.mean() - model["mean_length"]) < 4 * se + 50


@pytest.mark.parametrize("mix,ratio", [((1, 0, 0), 1.0), ((0, 1, 0), 1.08),
                                       ((0, 0, 1), 0.92),
                                       ((0.2, 0.5, 0.3), 1.016)])
def test_error_rate_and_mix_match_the_model(mix, ratio):
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, 400_000, dtype=np.uint8)
    out = gen.apply_errors(seq, 0.08, mix, rng)
    assert abs(len(out) / len(seq) - ratio) < 0.003
    if mix == (1, 0, 0):
        assert abs((out != seq).mean() - 0.08) < 0.003


def test_reads_wrap_the_circular_genome_and_take_both_strands():
    c = small("ecoli-pbraw-50x", 30_000)
    genome, reads = gen.make_job(9, 1, c)
    strands = {n[-1] for n, _ in reads}
    assert strands == {"+", "-"}
    starts = [int(re.search(r"_pos(\d+)", n).group(1)) for n, _ in reads]
    lens = [int(re.search(r"_len(\d+)", n).group(1)) for n, _ in reads]
    assert any(s + ln > len(genome) for s, ln in zip(starts, lens))


def test_fasta_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    recs = [(f"r{i}", rng.integers(0, 4, 100 + i, dtype=np.uint8))
            for i in range(5)]
    path = str(tmp_path / "x.fasta")
    assert gen.write_fasta(recs, path) == sum(len(s) for _, s in recs)
    back = gen.read_fasta(path)
    assert [n for n, _ in back] == [n for n, _ in recs]
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(back, recs))
