"""Climb steps per CUDA graph, measured on one GPU.

    python3 scripts/torch_climb_steps.py [--steps 8,4]

Builds the kernels, runs `chip_smoke.py`'s raw path (phase 5, 1 Mb,
with its census), then resumes that run from consensus in fresh
processes without the census, in turns: host-stepped
(FLYE_TPU_HOST_POLL=1), resident with each `_CLIMB_STEPS` of --steps,
the same again in reverse order, host-stepped last.  Each run must
write every output file as phase 5 did; each prints its stage walls,
"bubble kernels" steps, scoring launches and device peak memory.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import chip_smoke as cs  # noqa: E402

# a `chip_smoke.py --child` run with the climb's steps per graph set
CHILD = ("import sys; sys.path.insert(0, %r); "
         "import flye_tpu_torch.ops.polish as TP; "
         "TP._CLIMB_STEPS = int(sys.argv[1]); "
         "import chip_smoke as cs; cs.child_main(sys.argv[2])") % ROOT


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="8,4",
                    help="comma-separated steps per climb graph")
    steps = [int(n) for n in ap.parse_args().steps.split(",")]
    t0 = time.perf_counter()
    cs.phase_build()
    cs.phase_main(1.0, "cuda")
    out, reads, glen, _ = cs.KEPT["raw"]
    host = {"FLYE_TPU_HOST_POLL": "1"}
    turns = ([("host", host, 8)] + [(f"r{n}", {}, n) for n in steps]
             + [(f"r{n}b", {}, n) for n in reversed(steps)]
             + [("hostb", host, 8)])
    for tag, env, n in turns:
        d = f"{out}_{tag}"
        cs.resume_copy(out, d)
        full = {k: v for k, v in os.environ.items()
                if k != "FLYE_TPU_HOST_POLL"}
        full.update(env)
        spec = json.dumps({"tag": tag, "argv": [
            "--pacbio-raw", reads, "-o", d, "-g", f"{glen}", "--device",
            "cuda", "--resume-from", "consensus"]})
        p = subprocess.run([sys.executable, "-c", CHILD, str(n), spec],
                           env=full, capture_output=True, text=True,
                           timeout=600)
        if p.returncode:
            raise RuntimeError(f"{tag}: exit {p.returncode}\n"
                               f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        differ = cs.same_files(out, d, cs.run_files(d))
        if differ:
            raise AssertionError(f"{tag} differs from phase 5 in {differ}")
        print(f"[steps] {tag} ({n} steps a graph): files as phase 5's; "
              f"{cs.run_text(r)}", flush=True)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(cs.RUN_DIR, ignore_errors=True)
    print(f"[steps] done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
