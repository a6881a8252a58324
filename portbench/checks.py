"""The check that decides `correct`, after the window: what the timed
path produced, against the benchmark's plain references.

Numbers compared (each against its limit in the cell's file; a cell
compares those its file gives a limit, `PERF.md` §2 says why):
  err_ppm_max  per job, errors per million bases of the output FASTA
               against the truth genome (`reference/truth.py`), the
               worst job of the window;
  err_window_share
               per job, the share of its output's windows that hold any
               error (or find no anchor), the worst job: base-level
               accuracy, which one local misjoin barely moves;
  uncovered_share
               per job, the share of the truth genome's bases that no
               part of the output covers, the worst job of the window
               (an assembly that leaves part of the genome out);
  k1_diff      entries of score and parent that differ between the
               sampled K1 launches and the plain chain DP
               (`reference/chain_dp.py`) on the same inputs;
  k5_diff      distances that differ between the sampled K5 launches
               and the plain Levenshtein (`reference/levenshtein.py`);
  climb_off    the share of the sampled climb bubbles whose converged
               candidate (its bases and length) differs from the plain
               climb's (`reference/climb.py`, float32) on the same
               inputs;
  climb_gap    the widest relative gap between a sampled bubble's final
               score and the plain climb's, |program - reference| /
               |reference|.
The climb is followed from the program's own inputs to it (the bubbles
the polisher extracted); the truth comparison covers every stage whole.
"""

from __future__ import annotations

import numpy as np
import torch

from gen import read_fasta
from reference import chain_dp as ref_chain
from reference import climb as ref_climb
from reference import levenshtein as ref_lev
from reference import truth as ref_truth

# most bubbles of a sampled climb batch that the plain climb reruns
CLIMB_BUBBLES = 96


def truth_numbers(jobs, device):
    """Score every job's output; returns (errors, bases, {number: worst
    job's reading}) for err_ppm_max, err_window_share and
    uncovered_share."""
    errors = bases = 0
    worst = erring = lost = 0.0
    for job in jobs:
        contigs = read_fasta(job["output"])
        s = ref_truth.score_job(contigs, job["genome"], device)
        job["truth"] = s
        errors += s["errors"]
        bases += s["bases"]
        worst = max(worst, 1e6 * s["errors"] / max(s["bases"], 1))
        erring = max(erring, s["erring_windows"] / max(s["windows"], 1))
        lost = max(lost, s["uncovered"] / len(job["genome"]))
    return errors, bases, {"err_ppm_max": worst, "err_window_share": erring,
                           "uncovered_share": lost}


def k1_diff(samples, device):
    bad = 0
    for (cur, ext, nv, score, parent), (k, mj, lb) in samples:
        t = [torch.from_numpy(np.asarray(x)).to(device)
             for x in (cur, ext, nv)]
        s, p = ref_chain.chain_dp(*t, k, mj, lb)
        bad += int((s.cpu().numpy() != score).sum()
                   + (p.cpu().numpy() != parent).sum())
    return bad


def k5_diff(samples, device):
    bad = 0
    for (a, alen, b, blen, out), _ in samples:
        t = [torch.from_numpy(np.asarray(x)).to(device)
             for x in (a, alen, b, blen)]
        d = ref_lev.edit_distance(*t)
        bad += int((d.cpu().numpy() != out).sum())
    return bad


def pick_bubbles(sample, rng):
    """A sampled climb batch cut to at most CLIMB_BUBBLES bubbles drawn
    from rng (lanes are independent: each bubble's climb reads only its
    own group lanes): (arrays, its program outputs, max_iters, groups,
    block_size, steepest)."""
    arrays, max_iters, groups, block, steepest, out = sample
    cand, cand_len, branches, blen, bmask, subs = arrays
    B = cand.shape[0]
    pick = np.sort(rng.choice(B, size=min(B, CLIMB_BUBBLES),
                              replace=False))
    lanes = (pick[:, None] * groups + np.arange(groups)[None]).reshape(-1)
    cut = (cand[pick], cand_len[pick], branches[lanes], blen[lanes],
           bmask[lanes], subs)
    return cut, [o[pick] for o in out], max_iters, groups, block, steepest


def lanes_off(a, b):
    """Bubbles whose candidates differ: (cand, cand_len) pairs a, b."""
    ca, la = a[0], a[1]
    cb, lb = b[0], b[1]
    n = 0
    for i in range(len(la)):
        if la[i] != lb[i] or not np.array_equal(ca[i, :la[i]],
                                                cb[i, :lb[i]]):
            n += 1
    return n


def score_gap(a, b):
    """The widest relative gap between the scores of a and b."""
    sa = np.asarray(a[2], np.float64)
    sb = np.asarray(b[2], np.float64)
    if not len(sb):
        return 0.0
    return float((np.abs(sa - sb) / np.maximum(np.abs(sb), 1e-30)).max())


def climb_numbers(samples, seed, device, control=False):
    """{"climb_off", "climb_gap", "bubbles"} of the program against the
    float32 plain climb, and with `control` the same of the bfloat16
    plain climb on the same bubbles ("control_climb_off",
    "control_climb_gap")."""
    rng = np.random.default_rng([int(seed) % 2**64, 11])
    off = total = off_ctl = 0
    gap = gap_ctl = 0.0
    for sample in samples:
        arrays, out, mi, g, blk, st = pick_bubbles(sample, rng)
        ref = ref_climb.climb(arrays, mi, g, blk, st, device)
        off += lanes_off(out, ref)
        gap = max(gap, score_gap(out, ref))
        total += len(out[1])
        if control:
            low = ref_climb.climb(arrays, mi, g, blk, st, device,
                                  dtype=torch.bfloat16)
            off_ctl += lanes_off(low, ref)
            gap_ctl = max(gap_ctl, score_gap(low, ref))
    if not total:
        return {}
    out = {"climb_off": off / total, "climb_gap": gap, "bubbles": total}
    if control:
        out.update(control_climb_off=off_ctl / total,
                   control_climb_gap=gap_ctl)
    return out


def run_checks(rec, jobs, limits, must, seed, device):
    """Every number and whether each is within its limit: {name:
    (number, limit)} in a fixed order, and the failures' names.  A
    kernel the cell must drive, with no call sampled, fails."""
    numbers = {}
    errors, bases, worst = truth_numbers(jobs, device)
    numbers.update(worst)
    if rec.samples["chain_dp"]:
        numbers["k1_diff"] = k1_diff(rec.samples["chain_dp"], device)
    if rec.samples["levenshtein"]:
        numbers["k5_diff"] = k5_diff(rec.samples["levenshtein"], device)
    if rec.samples["climb"]:
        c = climb_numbers(rec.samples["climb"], seed, device)
        numbers["climb_off"] = c["climb_off"]
        numbers["climb_gap"] = c["climb_gap"]
    numbers = {n: v for n, v in numbers.items() if n in limits}
    failed = [n for n, v in numbers.items() if v > limits[n]]
    failed += [f"no_{k}_sampled" for k in must if not rec.samples[k]]
    checks = {n: (v, limits[n]) for n, v in numbers.items()}
    return checks, failed, (errors, bases)
