"""A run with the timed path broken underneath must come out not
correct, in every cell, against that cell's own limits: the harness's
look for a card skipped, the rest of a run driven on the CPU at a
small genome, once for each fault the cells can have (the exchange
between cards is not among them: every cell takes one card):
  - an answer altered where it is produced (a K1 score);
  - half of the batch left out (every second live row of a K1 batch
    comes back empty);
  - a step that returns its state unchanged (every bubble's climb hands
    back its candidate as it came in);
  - part of the answer left out (the finished assembly without the
    last third of each contig).
"""

import numpy as np
import pytest
import torch

import gen
import run

# genome length per cell on the CPU: the HiFi path leaves most of a
# 30 kb genome out (as it does some 50 kb ones, PERF.md), so its cell
# runs at its own 50 kb
GLEN = {"pbraw50-asm": 30_000, "hifi30-asm": 50_000}
CELLS = sorted(GLEN)


def altered(orig):
    def chain(cur, ext, nvalid, k, max_jump, lookback):
        s, p = orig(cur, ext, nvalid, k, max_jump, lookback)
        s = s.clone()
        s[0, 0] += 1
        return s, p
    return chain


def half_left_out(orig):
    """Every second live row of the batch left out: its score and
    parents come back empty."""
    def chain(cur, ext, nvalid, k, max_jump, lookback):
        s, p = orig(cur, ext, nvalid, k, max_jump, lookback)
        out = torch.nonzero(nvalid > 0)[1::2, 0]
        s, p = s.clone(), p.clone()
        s[out], p[out] = 0, -1
        return s, p
    return chain


def unchanged(orig):
    def climb(cand, cand_len, branches, blen, bmask, subs, max_iters,
              eps=None):
        n = len(cand_len)
        return (np.array(cand, np.uint8), np.array(cand_len, np.int32),
                np.zeros(n, np.float32), np.zeros(n, np.int32))
    return climb


def part_left_out(orig):
    """The job's assembly.fasta without the last third of each
    contig."""
    def main(argv):
        rc = orig(argv)
        path = f"{argv[argv.index('-o') + 1]}/assembly.fasta"
        contigs = gen.read_fasta(path)
        gen.write_fasta([(n, c[:2 * len(c) // 3]) for n, c in contigs],
                        path)
        return rc
    return main


# fault -> (module, attribute broken, how, the number that must fail)
FAULTS = {"k1_altered": ("chain", "_chain_dp_scan", altered, "k1_diff"),
          "k1_half_left_out": ("chain", "_chain_dp_scan", half_left_out,
                               "k1_diff"),
          "climb_state_unchanged": ("polish", "_polish_bubbles_native",
                                    unchanged, "err_window_share"),
          "part_left_out": ("main", "main", part_left_out,
                            "uncovered_share")}


def run_small(cell, monkeypatch, patch=None):
    """One run of `cell` on the CPU at GLEN[cell], every K1 launch
    sampled.
    The warm-up job returns at once: on the CPU it builds nothing that
    the window needs, and it would double the test's time."""
    from flye_tpu_torch import main

    def patches():
        if patch is not None:
            patch()
        calls = []
        orig = main.main

        def main_(argv):
            calls.append(argv)
            return 0 if len(calls) == 1 else orig(argv)
        monkeypatch.setattr(main, "main", main_)
    args = run.parse(["--workload", cell, "--seed",
                      "3000000023", "--seconds", "1", "--trace", "0"])
    return run.run_cell(
        args, require_card=False, device="cpu", patch=patches,
        overrides={"config": {"genome_length": GLEN[cell]},
                   "cell": {"must": ["chain_dp"], "jobs": 1,
                            "sample": {"chain_dp": [1.0, 4]}}})


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_at_this_size_is_correct(cell, monkeypatch):
    # the faults below fail limits that the sound path meets here
    res, lines = run_small(cell, monkeypatch)
    assert res["correct"] is True, lines


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, cell, monkeypatch):
    from flye_tpu_torch import main
    from flye_tpu_torch.ops import chain, polish
    mod_name, attr, make, number = FAULTS[fault]
    mod = {"chain": chain, "polish": polish, "main": main}[mod_name]

    def patch():
        monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res, lines = run_small(cell, monkeypatch, patch)
    assert res["correct"] is False, lines
    checks = res["checks"]
    assert number in checks["failed"], lines
    assert checks[number]["value"] > checks[number]["limit"]
