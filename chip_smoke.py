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
  4. the main path, `flye_tpu_torch.main --pacbio-raw ... --stop-after
     consensus --device cuda` on a simulated 1 Mb genome at 30x: the
     consensus must be non-empty, every kernel must have launched, and
     its window identity against the truth genome must reach IDENTITY
     _FLOOR.
It prints the card's name and power limit, a `{"kernels": [...]}` line,
and last `{"ok": true, "device": {...}}`.  `--main-device cpu` runs the
main path on the CPU instead (how the identity floor was measured);
`--only-main` skips phases 2-3.
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

KERNELS = {
    "chain_dp": ("flye_tpu_torch/csrc/chain_dp.cu",
                 "flye_tpu/ops/chain_pallas.py:44"),
    "polish_backward": ("flye_tpu_torch/csrc/polish_score.cu",
                        "flye_tpu/ops/polish_pallas.py:224"),
    "polish_forward_score": ("flye_tpu_torch/csrc/polish_score.cu",
                             "flye_tpu/ops/polish_pallas.py:273"),
}


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
    _cuda.build(["chain_dp", "polish_score"])
    th.join()
    if err:
        raise err[0]
    for name in ("chain_dp", "polish_score"):
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
        print(f"[K1] T={T} M={M} L=1024: bit-identical ({n_par} parents);"
              f" kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
        per_shape.append({"shape": [T, M, 1024], "ms": ms,
                          "plain_ms": plain_ms})
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
        print(f"[K2+K3] (Cb,S,R)=({Cb},{S},{R}) x{B} lanes: max err "
              f"K2 {e2:.2e} K3 {e3:.2e}, chars exact, launches "
              f"bitwise equal; K2 {ms2:.3f} ms (plain {pl2:.1f} ms), "
              f"K3 {ms3:.3f} ms (plain {pl3:.1f} ms)", flush=True)
        per_k2.append({"shape": [B, Cb, R, S], "ms": ms2, "plain_ms": pl2})
        per_k3.append({"shape": [B, Cb, R, S], "ms": ms3, "plain_ms": pl3})

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

def window_identity(contigs, genome, device, n_windows=400, win=2000,
                    seed=0, k=32):
    """Window identity of contigs against the truth genome (the logic
    of scripts/run_scale.py): sample windows, anchor each by an exact
    k-mer (several offsets, both strands, every occurrence), and
    edit-distance it against the anchored truth slice on `device`.
    Returns (mean_identity, n_anchored, n_sampled)."""
    import torch
    from flye_tpu_torch.io.fasta import COMPLEMENT
    from flye_tpu_torch.ops.align import edit_distance_batch

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
    d = edit_distance_batch(
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
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    rc = flye_main.main(["--pacbio-raw", reads_path, "-o",
                         os.path.join(RUN_DIR, "out"), "-g", f"{glen}",
                         "--stop-after", "consensus", "--device", device])
    torch.cuda.synchronize()
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
    print(f"[main] wall {wall:.1f} s, device peak memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}", flush=True)
    if not native.loaded():
        raise AssertionError("native helpers were not loaded")
    if device == "cuda":
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main "
                                 f"path: {missing}")
    consensus = read_seq_file(os.path.join(RUN_DIR, "out", "10-consensus",
                                           "consensus.fasta"))
    total = sum(len(s) for _, s in consensus)
    if total == 0:
        raise AssertionError("empty consensus")
    ident, n_anch, n_win = window_identity(consensus, genome, "cuda")
    print(f"[main] consensus: {len(consensus)} contigs, {total} bp "
          f"(truth {glen}); window identity {ident:.6f} "
          f"({n_anch}/{n_win} windows anchored)", flush=True)
    if device == "cuda" and genome_mb == 1.0 and ident < IDENTITY_FLOOR:
        raise AssertionError(f"identity {ident:.6f} below the floor "
                             f"{IDENTITY_FLOOR}")
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
    launches = phase_main(args.genome_mb, args.main_device)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = report.get(name)
        head = r["per_shape"][0] if r else {}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"] if r else None,
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
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
