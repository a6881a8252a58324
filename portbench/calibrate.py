"""The readings that the limits of `correct` are set from, for one cell,
in one process on the card.

    python3 portbench/calibrate.py --workload <name> [--seeds a,b,...]
                                   [--control-seeds c,d,e]
                                   [--fault-seeds f,g,h]

After one warm-up job, for each seed of --seeds: one job of the cell on
that seed's first window job, with the recorder sampling as a run does,
then the check's numbers (`checks.py`): the program's readings, whose
largest over the seeds is each number's lower reading.  On the same
sampled climb bubbles the control's readings: the plain climb in
bfloat16 against the plain climb in float32 (`climb_off`, `climb_gap`),
whose least over the seeds is the upper reading.  For each
seed of --control-seeds: one job with the control put in the program's
place (every climb batch climbed by the plain climb in bfloat16), and
its truth numbers.  For each seed of --fault-seeds: one job with each
of two faults planted, and its truth numbers (`err_ppm_max`,
`err_window_share`, `uncovered_share`):
"climb_unchanged", every climb batch handed back as it came in (the
consensus and polishing stages do nothing), and "part_left_out", the
finished assembly without the last third of each contig.  One JSON
line per reading on stdout, and a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    a = p.parse_args(argv)
    import numpy as np
    import torch
    import checks
    import gen
    import run
    from hooks import Recorder
    from reference import climb as ref_climb
    from flye_tpu_torch import main as flye_main
    from flye_tpu_torch.ops import polish

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    run.cache_env()
    cell = run.read_json(HERE, "workloads", f"{a.workload}.json")
    config = run.read_json(HERE, "configs", f"{cell['config']}.json")
    traffic = run.read_json(HERE, "traffic", f"{cell['traffic']}.json")
    entry = run.load("entries", traffic["entry"])
    base = tempfile.mkdtemp(prefix="portbench-cal-")
    readings = []

    def job_of(seed, job):
        return run.make_job(base, seed, job, config, traffic, entry, "cuda")

    def low(climb, arrays, max_iters):
        cand, clen, score = ref_climb.climb(
            arrays, max_iters, climb.groups, climb.block_size,
            climb.steepest, climb.device, dtype=torch.bfloat16)
        return (cand, clen.astype(np.int32), score.astype(np.float32),
                np.zeros(len(clen), np.int32))

    def unchanged(climb, arrays, max_iters):
        cand, clen = np.array(arrays[0], np.uint8), np.array(arrays[1],
                                                             np.int32)
        return (cand, clen, np.zeros(len(clen), np.float32),
                np.zeros(len(clen), np.int32))

    def cut_output(path):
        contigs = gen.read_fasta(path)
        gen.write_fasta([(n, c[:2 * len(c) // 3]) for n, c in contigs],
                        path)

    def one(seed, mode="program"):
        control = mode != "program"
        job = job_of(seed, 1)
        rec = Recorder(seed, cell["sample"])
        saved = polish._Climb.run
        if mode in ("control", "climb_unchanged"):
            polish._Climb.run = low if mode == "control" else unchanged
        try:
            with rec:
                rc, wall, _, _ = run.run_job(flye_main, job["argv"], torch,
                                             "cuda")
                rec.settle()
        finally:
            polish._Climb.run = saved
        if rc == 0 and mode == "part_left_out":
            cut_output(job["output"])
        if rc != 0:
            return {"seed": seed, "control": control, "mode": mode,
                    "rc": rc}
        _, _, worst = checks.truth_numbers([job], "cuda")
        out = {"seed": seed, "control": control, "mode": mode,
               "wall_s": wall, **worst, "truth": job["truth"]}
        if not control:
            if rec.samples["chain_dp"]:
                out["k1_diff"] = checks.k1_diff(rec.samples["chain_dp"],
                                                "cuda")
            if rec.samples["levenshtein"]:
                out["k5_diff"] = checks.k5_diff(
                    rec.samples["levenshtein"], "cuda")
            if rec.samples["climb"]:
                t0 = time.perf_counter()
                out.update(checks.climb_numbers(
                    rec.samples["climb"], seed, "cuda", control=True),
                    climb_check_s=time.perf_counter() - t0)
            out["sampled"] = {k: len(v) for k, v in rec.samples.items()}
        shutil.rmtree(job["dir"], ignore_errors=True)
        polish._CLIMBS.clear()
        torch.cuda.empty_cache()
        return out

    try:
        warm = job_of(0, 0)
        run.run_job(flye_main, warm["argv"], torch, "cuda")
        for seed in [int(s) for s in a.seeds.split(",") if s]:
            r = one(seed)
            readings.append(r)
            print(json.dumps(r), flush=True)
        for seed in [int(s) for s in a.control_seeds.split(",") if s]:
            r = one(seed, "control")
            readings.append(r)
            print(json.dumps(r), flush=True)
        for seed in [int(s) for s in a.fault_seeds.split(",") if s]:
            for mode in ("climb_unchanged", "part_left_out"):
                r = one(seed, mode)
                readings.append(r)
                print(json.dumps(r), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    prog = [r for r in readings if not r["control"] and "err_ppm_max" in r]
    ctl = [r for r in readings if r["mode"] == "control"
           and "err_ppm_max" in r]
    summary = {"workload": a.workload, "seeds": len(prog)}
    truth_names = ("err_ppm_max", "err_window_share", "uncovered_share")
    for name in truth_names + ("k1_diff", "k5_diff", "climb_off",
                               "climb_gap"):
        vals = [r[name] for r in prog if r.get(name) is not None]
        if vals:
            summary[f"{name}.lower"] = max(vals)
        vals = [r[f"control_{name}"] for r in prog
                if r.get(f"control_{name}") is not None]
        if vals:
            summary[f"{name}.upper"] = min(vals)
    for name in truth_names:
        if ctl:
            summary[f"{name}.control"] = min(r[name] for r in ctl)
    for mode in ("climb_unchanged", "part_left_out"):
        got = [r for r in readings if r["mode"] == mode and "rc" not in r]
        for name in truth_names:
            if got:
                summary[f"{name}.{mode}"] = min(r[name] for r in got)
    summary["failed_runs"] = [(r["seed"], r["mode"]) for r in readings
                              if "rc" in r]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
