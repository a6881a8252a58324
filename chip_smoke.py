"""Smoke run of flye_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 1.0] [--main-device cuda|cpu]
                          [--only-main]

Phases (each raises on failure; the script then exits nonzero and
prints no result):
  1. build the CUDA kernels (one nvcc per source, in parallel) and the
     native host helpers, from the sources in this checkout;
  2. K1 (chain DP) against its plain version on the card, bit-identical,
     at the main path's shapes and on edge rows;
  3. K2 + K3 (polish scoring) against their plain version on the card at
     the polisher's bucket shapes: suffix rows equal, raw scores within
     1e-3 with the same finiteness, chars exact, two launches bitwise
     equal, and a synthetic hill climb converging to the same
     candidates;
  4. K5 (Levenshtein) against its plain version on the card at the main
     path's [4096, 64] and the segment buckets S = 16/64/256/1024,
     bit-identical, on edge rows
     (alen 0, blen 0, both 0, full length, identical strings) and
     random and related pairs, two launches bitwise equal;
  5. the main path, `flye_tpu_torch.main --pacbio-raw ... --device cuda`
     on a simulated 1 Mb genome at 30x, run to `assembly.fasta`: every
     kernel must have launched, the consensus must reach IDENTITY_FLOOR
     and the assembly ASSEMBLY_IDENTITY_FLOOR (window identity against
     the truth genome) with ASSEMBLY_CONTIGS contigs, and the assembly
     graph and info files must be non-empty.
Each kernel is timed (CUDA events) beside its plain version and its
bound: the larger of the bytes it must move over the card's memory rate
and the operations its inputs need over the card's peak rate for their
type.  It prints the card's name and power limit, a `{"kernels": [...]}`
line, and last `{"ok": true, "device": {...}}`.  `--main-device cpu`
runs the main path on the CPU instead (how the floors were measured);
`--only-main` skips phases 2-4.
"""

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, ".smoke_run")
# window identity of the port's `--device cpu` run on the same reads
# (1 Mb, 30x, the seeds of phase_main): 0.999959798994975 on an
# H100 machine's CPU, minus 1e-3; see PERF.md.  Checked at 1 Mb only.
IDENTITY_FLOOR = 0.998959798994975
# the same `--device cpu` run's assembly.fasta: window identity
# 0.9999598997493735 on an H100 machine's CPU, minus 1e-3, and its
# contig count; see PERF.md.  Checked at 1 Mb only.
ASSEMBLY_IDENTITY_FLOOR = 0.9989598997493735
ASSEMBLY_CONTIGS = 1

KERNELS = {
    "chain_dp": ("flye_tpu_torch/csrc/chain_dp.cu",
                 "flye_tpu/ops/chain_pallas.py:44"),
    "polish_backward": ("flye_tpu_torch/csrc/polish_score.cu",
                        "flye_tpu/ops/polish_pallas.py:224"),
    "polish_forward_score": ("flye_tpu_torch/csrc/polish_score.cu",
                             "flye_tpu/ops/polish_pallas.py:273"),
    "levenshtein": ("flye_tpu_torch/csrc/levenshtein.cu",
                    "flye_tpu/ops/align_pallas.py:26"),
}

# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): 3.35 TB/s of
# device memory and 67 TFLOP/s of float32 outside the tensor cores
# (132 SMs x 128 lanes x 2 x 1.98 GHz).  Integer work runs on the 64
# int32 lanes of each SM: 132 x 64 x 1.98 GHz = 16.7 Tops/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# operations per unit of work, counted from each plain version's
# arithmetic:
# K1, per (match, predecessor) pair: two coordinate differences, four
# range compares and three ands, a min and a clamp (match), |dcur-dext|,
# a compare, a double, a halve and a select (gap), match - gap, the
# score add and the running max.
K1_OPS_PER_PAIR = 20
# K2, per suffix-row cell: match add, gap add, max, minus sg, the
# running max, plus sg, the row select.
K2_OPS_PER_CELL = 7
# K3, per prefix-row cell: the same 7 for the forward row, then the
# deletion score (2 adds, max, weighted add: 4) and for each of the 4
# chars the edited row (2 adds, 1 max, 1 gap add) reduced for insertion
# and substitution (2 x 4): 4 + 4 x 12.
K3_OPS_PER_CELL = 7 + 4 + 4 * 12
# K5, per DP cell: compare, two adds, min, minus j, the running min,
# plus j.
K5_OPS_PER_CELL = 7


def bound(n_bytes, n_ops, ops_per_s):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------- phase 1

def phase_build():
    from flye_tpu_torch import native
    from flye_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    err = []

    def build_native():
        try:
            native.get()
        except Exception as e:  # reported below, on the main thread
            err.append(e)
    th = threading.Thread(target=build_native)
    th.start()
    sources = ["chain_dp", "polish_score", "levenshtein"]
    _cuda.build(sources)
    th.join()
    if err:
        raise err[0]
    for name in sources:
        _cuda.lib(name)
    print(f"[build] kernels + native in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[build] card: {card_line()}", flush=True)


# ---------------------------------------------------------------- phase 2

def make_matches(T, M, rng, noise=60):
    span = 40 * M   # ~one seed match every 40 bases, as on real reads
    cur = np.sort(rng.integers(0, span, size=(T, M)), axis=1)
    ext = cur + 300 + rng.integers(-noise, noise, size=(T, M))
    nvalid = rng.integers(1, M + 1, size=T)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))


def phase_chain(report):
    import torch
    from flye_tpu_torch.ops.chain import _chain_dp_scan, chain_dp
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    per_shape = []
    for T, M in [(2048, 4096), (32, 4096), (8, 16384)]:
        cur, ext, nv = make_matches(T, M, rng)
        nv[0], nv[1], nv[2] = 0, 1, M      # edge rows
        args = [torch.from_numpy(a).to(dev) for a in (cur, ext, nv)]
        s_k, p_k = chain_dp(*args, 17, 1500, 1024)
        s_p, p_p = _chain_dp_scan(*args, 17, 1500, 1024)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(p_k, p_p)):
            bad = int((s_k != s_p).sum() + (p_k != p_p).sum())
            raise AssertionError(f"K1 != plain at T={T} M={M}: {bad} "
                                 "entries differ")
        ms = cuda_ms(lambda: chain_dp(*args, 17, 1500, 1024), 3)
        plain_ms = cuda_ms(lambda: _chain_dp_scan(*args, 17, 1500, 1024),
                           1)
        n_par = int((p_k >= 0).sum())
        # predecessor pairs: match i of a row links back to min(i, L)
        i = np.arange(M)
        pairs = sum(int(np.minimum(i[:n], 1024).sum()) for n in nv)
        b_ms, b_by = bound(16 * T * M + 4 * T, K1_OPS_PER_PAIR * pairs,
                           INT32_OPS_PER_S)
        print(f"[K1] T={T} M={M} L=1024: bit-identical ({n_par} parents);"
              f" kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        per_shape.append({"shape": [T, M, 1024], "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by})
    report["chain_dp"] = {"max_abs_err": 0, "per_shape": per_shape}


# ---------------------------------------------------------------- phase 3

def polish_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(Cb // 2, Cb - Cb // 8, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(S // 2, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)
    return cand, clen, branches, blen, bmask, subs


def phase_polish(report):
    import torch
    import flye_tpu_torch.ops.polish as TP
    dev = torch.device("cuda")
    per_k2, per_k3 = [], []
    err_k2 = err_k3 = 0.0
    # (Cb, S, R) buckets with the lane counts timed at each
    for (Cb, S, R), B in [((64, 96, 8), 1024), ((160, 240, 8), 256),
                          ((384, 576, 8), 64), ((1536, 2304, 8), 8)]:
        args = [torch.from_numpy(a).to(dev)
                for a in polish_inputs(Cb + S, (B, Cb, R, S))]
        cand, clen, branches, blen, bmask, subs = args
        tables = TP._tables(cand, clen, branches, blen, subs)
        bt = TP._backward_rows_cuda(cand, clen, branches, blen, subs,
                                    tables)
        Bm = TP._backward_rows(cand, clen, branches, blen, subs, tables)
        fin = Bm > -1e29
        if not torch.equal(fin, bt.transpose(0, 1) > -1e29):
            raise AssertionError(f"K2 finiteness differs at {Cb, S, R}")
        e2 = float((bt.transpose(0, 1) - Bm)[fin].abs().max())
        raw_k = TP._forward_scores_cuda(cand, branches, blen, bmask, subs,
                                        tables, bt)
        raw_k2 = TP.score_edits_raw(*args)
        if not all(torch.equal(a, b) for a, b in zip(raw_k, raw_k2)):
            raise AssertionError(f"two launches differ at {Cb, S, R}")
        raw_p = TP._forward_scores(cand, branches, blen, bmask, subs,
                                   tables, Bm)
        e3 = 0.0
        for a, b in zip(raw_k, raw_p):
            fa, fb = a > -1e29, b > -1e29
            if not torch.equal(fa, fb):
                raise AssertionError(f"K3 finiteness differs at "
                                     f"{Cb, S, R}")
            if fa.any():
                e3 = max(e3, float((a - b)[fa].abs().max()))
        fk = TP._finish_scores(cand, clen, *raw_k, groups=1)
        fp = TP._finish_scores(cand, clen, *raw_p, groups=1)
        if not (torch.equal(fk[3], fp[3]) and torch.equal(fk[5], fp[5])):
            raise AssertionError(f"chars differ at {Cb, S, R}")
        if max(e2, e3) > 1e-3:
            raise AssertionError(f"scores differ by {max(e2, e3)} at "
                                 f"{Cb, S, R}")
        err_k2, err_k3 = max(err_k2, e2), max(err_k3, e3)
        ms2 = cuda_ms(lambda: TP._backward_rows_cuda(
            cand, clen, branches, blen, subs, tables), 3)
        ms3 = cuda_ms(lambda: TP._forward_scores_cuda(
            cand, branches, blen, bmask, subs, tables, bt), 3)
        del Bm
        pl2 = cuda_ms(lambda: TP._backward_rows(
            cand, clen, branches, blen, subs, tables), 1)
        Bm = TP._backward_rows(cand, clen, branches, blen, subs, tables)
        pl3 = cuda_ms(lambda: TP._forward_scores(
            cand, branches, blen, bmask, subs, tables, Bm), 1)
        del Bm, bt
        torch.cuda.empty_cache()
        # bytes: inputs read once, outputs written once; operations:
        # the live cells (candidate rows up to clen, branch columns up
        # to blen; K3 only on the branches bmask keeps)
        rows = B * (Cb + 1) * R * (S + 1) * 4          # bt, f32
        side = B * R * (S + 1) * 4                     # sg or gp
        small = B * Cb + B * R * S + 4 * B * R + 4 * B * Cb + 100
        cells = (clen[:, None].long() * (blen.long() + 1))
        b2 = bound(small + side + 4 * B * (Cb + 1) + 4 * B + rows,
                   K2_OPS_PER_CELL * int(cells.sum()), FP32_OPS_PER_S)
        cells3 = ((clen[:, None].long() + 1) * (blen.long() + 1)
                  * bmask.long())
        b3 = bound(small + side + 4 * B * R + rows
                   + 4 * B * (1 + Cb + 4 * (Cb + 1) + 4 * Cb),
                   K3_OPS_PER_CELL * int(cells3.sum()), FP32_OPS_PER_S)
        print(f"[K2+K3] (Cb,S,R)=({Cb},{S},{R}) x{B} lanes: max err "
              f"K2 {e2:.2e} K3 {e3:.2e}, chars exact, launches "
              f"bitwise equal; K2 {ms2:.3f} ms (plain {pl2:.1f} ms, "
              f"bound {b2[0]:.4f} ms, {b2[1]}), K3 {ms3:.3f} ms (plain "
              f"{pl3:.1f} ms, bound {b3[0]:.4f} ms, {b3[1]})", flush=True)
        per_k2.append({"shape": [B, Cb, R, S], "ms": ms2, "plain_ms": pl2,
                       "bound_ms": b2[0], "bound_by": b2[1]})
        per_k3.append({"shape": [B, Cb, R, S], "ms": ms3, "plain_ms": pl3,
                       "bound_ms": b3[0], "bound_by": b3[1]})

    # synthetic hill climb: kernels vs plain scoring, same schedule
    rng = np.random.default_rng(7)
    B, C, Cb, S, R = 64, 30, 40, 60, 24
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 2)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    flip = rng.random((B, R, S)) < 0.05
    branches = np.where(flip, rng.integers(0, 4, (B, R, S)),
                        branches).astype(np.uint8)
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    clen = np.full(B, C, np.int32)
    k_out = TP.polish_bubbles(cand, clen, branches, blen, bmask, subs,
                              max_iters=2 * Cb, use_kernel=True,
                              device="cuda")
    p_out = TP.polish_bubbles(cand, clen, branches, blen, bmask, subs,
                              max_iters=2 * Cb, use_kernel=False,
                              device="cuda")
    if not (np.array_equal(k_out[0], p_out[0])
            and np.array_equal(k_out[1], p_out[1])):
        raise AssertionError("hill climb: kernels and plain converge "
                             "differently")
    fixed = sum(int(np.array_equal(k_out[0][i, :k_out[1][i]], true[i]))
                for i in range(B))
    print(f"[K2+K3] hill climb x{B}: kernel == plain, {fixed}/{B} "
          "bubbles restored to the truth", flush=True)
    report["polish_backward"] = {"max_abs_err": err_k2,
                                 "per_shape": per_k2}
    report["polish_forward_score"] = {"max_abs_err": err_k3,
                                      "per_shape": per_k3}


# ---------------------------------------------------------------- phase 4

def lev_inputs(B, S, seed):
    """Random pairs, half of them with b a 10%-mutated copy of a, and
    the edge rows first: alen 0, blen 0, both 0, both full, identical
    full-length strings."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, S)).astype(np.uint8)
    b = rng.integers(0, 4, (B, S)).astype(np.uint8)
    half = B // 2
    mut = rng.random((half, S)) < 0.1
    b[:half] = np.where(mut, b[:half], a[:half])
    al = rng.integers(0, S + 1, B).astype(np.int32)
    bl = rng.integers(0, S + 1, B).astype(np.int32)
    al[:5] = [0, S, 0, S, S]
    bl[:5] = [S, 0, 0, S, S]
    b[4] = a[4]
    return a, al, b, bl


def phase_lev(report):
    import torch
    from flye_tpu_torch.ops.align import (_edit_distance_plain,
                                          edit_distance_batch)
    dev = torch.device("cuda")
    per_shape = []
    # first the shape the 1 Mb main path hands K5, then the buckets
    for S, B in [(64, 4096), (16, 4096), (64, 1024), (256, 256),
                 (1024, 64)]:
        a, al, b, bl = lev_inputs(B, S, S + B)
        args = [torch.from_numpy(x).to(dev) for x in (a, al, b, bl)]
        d_k = edit_distance_batch(*args)
        d_k2 = edit_distance_batch(*args)
        d_p = _edit_distance_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(d_k, d_p):
            raise AssertionError(f"K5 != plain at S={S} B={B}: "
                                 f"{int((d_k != d_p).sum())} pairs differ")
        if not torch.equal(d_k, d_k2):
            raise AssertionError(f"two K5 launches differ at S={S}")
        edge = d_k[:5].tolist()
        if edge[:3] != [S, S, 0] or edge[4] != 0:
            raise AssertionError(f"K5 edge rows at S={S}: {edge}")
        ms = cuda_ms(lambda: edit_distance_batch(*args), 20)
        plain_ms = cuda_ms(lambda: _edit_distance_plain(*args), 1)
        cells = int((al.astype(np.int64) * bl).sum())
        b_ms, b_by = bound(2 * B * S + 12 * B, K5_OPS_PER_CELL * cells,
                           INT32_OPS_PER_S)
        print(f"[K5] S={S} B={B}: bit-identical, edge rows {edge}, "
              f"launches bitwise equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {b_ms:.5f} ms ({b_by}, {cells} "
              "cells)", flush=True)
        per_shape.append({"shape": [B, S], "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by})
    report["levenshtein"] = {"max_abs_err": 0, "per_shape": per_shape}


# ---------------------------------------------------------------- phase 5

def window_identity(contigs, genome, device, n_windows=400, win=2000,
                    seed=0, k=32):
    """Window identity of contigs against the truth genome (the logic
    of scripts/run_scale.py): sample windows, anchor each by an exact
    k-mer (several offsets, both strands, every occurrence), and
    edit-distance it against the anchored truth slice on `device` with
    K5's plain version (the check stays independent of the kernels).
    Returns (mean_identity, n_anchored, n_sampled)."""
    import torch
    from flye_tpu_torch.io.fasta import COMPLEMENT
    from flye_tpu_torch.ops.align import _edit_distance_plain

    def pack(seq):
        out = np.zeros(len(seq) - k + 1, np.uint64)
        for i in range(k):
            out = (out << np.uint64(2)) | seq[i:i + len(out)].astype(
                np.uint64)
        return out

    occ = {}
    for pos, km in enumerate(pack(genome)):
        occ.setdefault(int(km), []).append(pos)
    rng = np.random.default_rng(seed)
    rows_a, rows_b, lens_a, lens_b, groups = [], [], [], [], []
    n_sampled = 0
    pad = win // 5
    S = 1
    while S < win + 2 * pad + 1:
        S <<= 1
    total = sum(len(s) for _, s in contigs)
    if total == 0:
        return 0.0, 0, 0
    for name, seq in contigs:
        if len(seq) < win + k:
            continue
        per = max(1, int(n_windows * len(seq) / total))
        for _ in range(per):
            st = int(rng.integers(0, len(seq) - win))
            w = seq[st:st + win]
            wr = COMPLEMENT[w[::-1]]
            n_sampled += 1
            gid = n_sampled - 1
            anchored = False
            for off in (0, win // 4, win // 2):
                for cand in (w, wr):
                    km = 0
                    for i in range(k):
                        km = (km << 2) | int(cand[off + i])
                    for tpos in occ.get(km, ())[:4]:
                        w0 = tpos - off
                        if w0 - pad < 0 or w0 + win + pad > len(genome):
                            continue
                        tslice = genome[w0 - pad:w0 + win + pad]
                        ra = np.zeros(S, np.uint8)
                        rb = np.zeros(S, np.uint8)
                        ra[:win] = cand
                        rb[:len(tslice)] = tslice
                        rows_a.append(ra)
                        rows_b.append(rb)
                        lens_a.append(win)
                        lens_b.append(len(tslice))
                        groups.append(gid)
                        anchored = True
                    if anchored:
                        break
                if anchored:
                    break
    if not rows_a:
        return 0.0, 0, n_sampled
    dev = torch.device(device)
    d = _edit_distance_plain(
        torch.from_numpy(np.stack(rows_a)).to(dev),
        torch.tensor(lens_a, dtype=torch.int32, device=dev),
        torch.from_numpy(np.stack(rows_b)).to(dev),
        torch.tensor(lens_b, dtype=torch.int32, device=dev)).cpu().numpy()
    slack = np.array(lens_b) - np.array(lens_a)
    ident = 1.0 - np.maximum(d - slack, 0) / np.array(lens_a)
    best = {}
    for g, v in zip(groups, ident):
        if v > best.get(g, -1.0):
            best[g] = v
    vals = np.asarray(list(best.values()))
    return float(vals.mean()), len(best), n_sampled


class _StageTimes(logging.Handler):
    """Collects the pipeline's "<step>: done in X s" log lines and the
    start time of each ">>> STAGE: <job>"."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []
        self.starts = []

    def emit(self, record):
        msg = record.getMessage()
        if ": done in " in msg:
            self.lines.append(msg)
        elif msg.startswith(">>> STAGE: "):
            self.starts.append((msg[len(">>> STAGE: "):], record.created))

    def job_seconds(self, t_end):
        ends = [t for _, t in self.starts[1:]] + [t_end]
        return {name: round(e - t, 3)
                for (name, t), e in zip(self.starts, ends)}


def phase_main(genome_mb, device):
    import torch
    from flye_tpu_torch import native
    from flye_tpu_torch import main as flye_main
    from flye_tpu_torch.io.fasta import read_seq_file, write_fasta
    from flye_tpu_torch.ops import _cuda
    from flye_tpu_torch.ops import align
    from flye_tpu_torch.utils.simulate import random_genome, simulate_reads

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    glen = int(genome_mb * 1_000_000)
    t0 = time.perf_counter()
    genome = random_genome(glen, seed=11,
                           repeat_spec=[(5000, 3), (2000, 4)])
    reads = simulate_reads(genome, coverage=30, mean_length=8000,
                           error_rate=0.08, error_mix=(0.2, 0.5, 0.3),
                           seed=7)
    reads_path = os.path.join(RUN_DIR, "reads.fasta")
    write_fasta(reads, reads_path)
    n_bases = sum(len(s) for _, s in reads)
    print(f"[main] simulated {glen} bp genome, {len(reads)} reads, "
          f"{n_bases} bases in {time.perf_counter() - t0:.1f} s",
          flush=True)

    stages = _StageTimes()
    # on the root logger: the CLI replaces the package logger's handlers
    logging.getLogger().addHandler(stages)
    # the [B, S] shapes the main path hands K5 (the wrapper counts)
    lev_shapes = []
    lev_launch = align._edit_distance_cuda

    def recorded(a, *rest):
        lev_shapes.append(list(a.shape))
        return lev_launch(a, *rest)
    align._edit_distance_cuda = recorded
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    out = os.path.join(RUN_DIR, "out")
    t0 = time.perf_counter()
    try:
        rc = flye_main.main(["--pacbio-raw", reads_path, "-o", out, "-g",
                             f"{glen}", "--device", device])
        torch.cuda.synchronize()
    finally:
        align._edit_distance_cuda = lev_launch
    wall = time.perf_counter() - t0
    jobs = stages.job_seconds(time.time())
    launches = dict(_cuda.LAUNCHES)
    logging.getLogger().removeHandler(stages)
    if rc != 0:
        raise RuntimeError(f"main path exited with {rc}")
    peak = torch.cuda.max_memory_allocated()
    for line in stages.lines:
        print(f"[main]   {line}", flush=True)
    print(f"[main] stage seconds {jobs}", flush=True)
    print(f"[main] wall {wall:.1f} s to assembly.fasta, device peak "
          f"memory {peak / 2**30:.2f} GiB, launches {launches}, K5 "
          f"shapes [B, S] {lev_shapes}", flush=True)
    if not native.loaded():
        raise AssertionError("native helpers were not loaded")
    if len(jobs) != 7:
        raise AssertionError(f"expected 7 stages, ran {list(jobs)}")
    if device == "cuda":
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main "
                                 f"path: {missing}")
    for rel in ("assembly_graph.gfa", "assembly_info.txt"):
        path = os.path.join(out, rel)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"{rel} missing or empty")
    checked = device == "cuda" and genome_mb == 1.0
    for rel, floor in (("10-consensus/consensus.fasta", IDENTITY_FLOOR),
                       ("assembly.fasta", ASSEMBLY_IDENTITY_FLOOR)):
        contigs = read_seq_file(os.path.join(out, rel))
        total = sum(len(s) for _, s in contigs)
        if total == 0:
            raise AssertionError(f"empty {rel}")
        ident, n_anch, n_win = window_identity(contigs, genome, "cuda")
        print(f"[main] {rel}: {len(contigs)} contigs, {total} bp (truth "
              f"{glen}); window identity {ident!r} ({n_anch}/{n_win} "
              "windows anchored)", flush=True)
        if checked and ident < floor:
            raise AssertionError(f"{rel}: identity {ident!r} below the "
                                 f"floor {floor}")
    if checked and len(contigs) != ASSEMBLY_CONTIGS:
        raise AssertionError(f"{len(contigs)} contigs in assembly.fasta, "
                             f"the CPU run has {ASSEMBLY_CONTIGS}")
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    return launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--main-device", choices=["cuda", "cpu"],
                    default="cuda")
    ap.add_argument("--only-main", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build()
    report = {}
    if not args.only_main:
        phase_chain(report)
        phase_polish(report)
        phase_lev(report)
    launches = phase_main(args.genome_mb, args.main_device)

    # the first shape of each kernel heads its entry; no single PyTorch
    # call computes any of these functions, so library_ms is null
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = report.get(name)
        head = r["per_shape"][0] if r else {}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"] if r else None,
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"), "library_ms": None,
            "per_shape": r["per_shape"] if r else []})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {e!r}", file=sys.stderr)
        sys.exit(1)
