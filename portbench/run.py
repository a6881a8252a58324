"""The benchmark of flye_tpu_torch on one card: one cell, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

A cell (`workloads/<name>.json`) names a configuration
(`configs/<config>.json`: the genome, the read model, the flags), a
traffic mix (`traffic/<traffic>.json`: the job kind, `entries/<kind>.py`,
and its parameters), its number of jobs and the seed of its pool of
inputs.  Each job is one call of the CLI entry users run,
`flye_tpu_torch.main.main(argv)`, in this process, with `--device cuda`,
in a fresh directory under TMPDIR.  Jobs run one at a time, back to back
(a closed loop of one user per card).

The inputs: the cell's `jobs` genomes with their reads (and drafts),
drawn from (`pool_seed`, index), are the same set in every run; --seed
draws their order (and which launches the check samples).  So every
seed runs the same work in another order, and a run's numbers differ
from another seed's by the host and the order alone.

Set-up: imports, the CUDA context, the kernel libraries (built into
`flye_tpu_torch/_build/` by the first run in a checkout), and one
warm-up job on the pool's input `jobs` (one more genome of the pool,
outside the window's set), which also captures the climb's CUDA graphs
for the shapes it meets.  The window: the pool's jobs in the seed's
order, each timed from the call to its return and a synchronize;
another starts while the timed seconds are under --seconds (the cell's
`jobs` are sized to fill it).  After the window: the check
(`checks.py`), then one JSON line on stdout.

--trace 0 prints the cell's end-to-end metrics (BENCHMARK.json); --trace
1 runs the window under torch.profiler and prints the cell's per-layer
metrics, each read by `metrics/<name>.py`, with `device.busy_s`,
`device.window_s` and a `breakdown`.  Exits nonzero with no result
without a CUDA card, and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "flye_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else
    the time this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_IMPORT


def cache_env():
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernel libraries already build into flye_tpu_torch/_build/)."""
    base = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def load(kind: str, name: str):
    """The module HERE/<kind>/<name>.py, found by name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class StageLog(logging.Handler):
    """The program's stage and step times from its log (the way
    `chip_smoke.py` `_StageTimes` reads them): ">>> STAGE: <job>"
    starts, and each `stage_timer` step from its "<step>: started" to
    its "<step>: done in" record, timed by the records' clocks."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.starts, self.steps, self.open = [], [], {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(">>> STAGE: "):
            self.starts.append((msg[len(">>> STAGE: "):], record.created))
        elif msg.endswith(": started"):
            self.open.setdefault(msg[:-len(": started")], []).append(
                record.created)
        elif ": done in " in msg:
            name = msg.split(": done in ")[0]
            if self.open.get(name):
                self.steps.append((name,
                                   record.created - self.open[name].pop()))

    def stages(self, t_end: float) -> dict:
        ends = [t for _, t in self.starts[1:]] + [t_end]
        out = {}
        for (name, t), e in zip(self.starts, ends):
            out[name] = out.get(name, 0.0) + (e - t)
        return out


class RunView:
    """What a per-layer metric reads: the traced window's jobs (their
    stages and steps), the reduced trace, and the launches' bounds by
    kernel ({kernel: [(launches, bound ms of each)]}, one entry per
    noted call of `roofline/<kernel>.py`)."""

    def __init__(self, jobs, trace, bounds):
        self.jobs = jobs
        self.trace = trace
        self.bounds = bounds

    def bound_s(self, kernel):
        """The summed bound of the window's launches of `kernel`, s;
        None without a launch."""
        b = self.bounds.get(kernel)
        if not b:
            return None
        return sum(n * ms for n, ms in b) / 1e3

    def stage_mean(self, name):
        vals = [j["stages"][name] for j in self.jobs
                if name in j["stages"]]
        return sum(vals) / len(self.jobs) if vals else None

    def step_mean(self, pred):
        vals = [sum(s for n, s in j["steps"] if pred(n)) for j in self.jobs]
        if not any(pred(n) for j in self.jobs for n, _ in j["steps"]):
            return None
        return sum(vals) / len(self.jobs)

    def kernel_s(self, part):
        if not self.trace:
            return 0.0
        return sum(s for n, s in self.trace["kernel_s"].items()
                   if part in n)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def another_job(timed: float, n_jobs: int, seconds: float,
                jobs: int) -> bool:
    """Whether the window starts another job: until the cell's `jobs`
    are done, while the timed seconds so far are under `seconds`."""
    return n_jobs < jobs and (n_jobs == 0 or timed < seconds)


def read_rate(jobs) -> float:
    """Mbp of input reads per second: all the window's read bases over
    the sum of its jobs' walls."""
    return (sum(j["read_bases"] for j in jobs) / 1e6
            / sum(j["wall"] for j in jobs))


def make_job(base, seed, job, config, traffic, entry, device):
    """The inputs of job `job` drawn from `seed`, written under
    base/s<seed>j<job> before its timer starts: {"job", "genome", "dir",
    "argv", "output", "read_bases"}."""
    import gen
    genome, reads = gen.make_job(seed, job, config)
    job_dir = os.path.join(base, f"s{seed}j{job}")
    os.makedirs(job_dir)
    argv, output, n = entry.prepare(job_dir, genome, reads, config, traffic,
                                    gen.rng_for(seed, job, "draft"))
    return {"job": job, "genome": genome, "dir": job_dir,
            "argv": argv + ["--device", device], "output": output,
            "read_bases": n}


def rooflines():
    """{kernel: module} of every `roofline/<kernel>.py`."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "roofline"))
                   if f.endswith(".py"))
    return {n: load("roofline", n) for n in names}


def bounds_of(roofs, notes, bounds):
    """Add each noted call's (launches, bound ms) to bounds[kernel]."""
    import peaks
    for kernel, noted in notes.items():
        for n in noted:
            count, n_bytes, ops, rate = roofs[kernel].counted(n)
            bounds.setdefault(kernel, []).append(
                (count, peaks.bound(n_bytes, ops, rate)[0]))


def run_job(flye_main, argv, torch, device):
    """One timed job: the CLI call and a synchronize.  Returns (exit
    code, wall s, stage times, step times)."""
    log = StageLog()
    root = logging.getLogger()
    root.addHandler(log)
    try:
        t0 = time.perf_counter()
        rc = flye_main.main(argv)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        root.removeHandler(log)
    return rc, wall, log.stages(time.time()), log.steps


def run_cell(args, require_card=True, device="cuda", patch=None,
             overrides=None):
    """One run of one cell.  Returns (result dict, check lines), or
    raises SystemExit with a nonzero code and no result.  The tests'
    hooks: `patch`, a callable, runs once everything is imported and
    before the warm-up (to break the timed path underneath);
    `overrides` {"config": {...}, "cell": {...}} updates the cell's
    files as read (to run it at a size the CPU holds)."""
    t_start = process_start()
    sys.path[:0] = [HERE, ROOT]
    cache_env()
    cell = read_json(HERE, "workloads", f"{args.workload}.json")
    config = read_json(HERE, "configs", f"{cell['config']}.json")
    traffic = read_json(HERE, "traffic", f"{cell['traffic']}.json")
    bench = read_json(ROOT, "BENCHMARK.json")
    for part, d in (overrides or {}).items():
        {"config": config, "cell": cell, "traffic": traffic}[part].update(d)

    import torch
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found; no CPU fallback", file=sys.stderr)
        raise SystemExit(3)

    import checks
    from hooks import Recorder
    import tracing
    from torch.profiler import record_function
    from flye_tpu_torch import main as flye_main
    entry = load("entries", traffic["entry"])
    if patch is not None:
        patch()

    base = tempfile.mkdtemp(prefix="portbench-")
    try:
        import numpy as np
        n_jobs = int(cell["jobs"])
        order = np.random.default_rng(
            [int(args.seed) % 2**64, 5]).permutation(n_jobs)

        def make(index):
            return make_job(base, cell["pool_seed"], int(index), config,
                            traffic, entry, device)

        # set-up: one warm-up job on the pool's input outside the window
        warm = make(n_jobs)
        rc = run_job(flye_main, warm["argv"], torch, device)[0]
        if rc != 0:
            print(f"portbench: the warm-up job exited {rc}",
                  file=sys.stderr)
            raise SystemExit(5)
        shutil.rmtree(warm["dir"], ignore_errors=True)

        trace = bool(args.trace)
        roofs = rooflines() if trace else {}
        rec = Recorder(args.seed, cell["sample"], roofs)
        jobs, bounds = [], {}
        prof = None
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if trace:
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(tp.ProfilerActivity.CUDA)
            prof = tp.profile(activities=acts)
        job = make(order[0])
        setup_s = time.time() - t_start
        timed = 0.0
        with rec:
            if prof is not None:
                prof.start()
            while True:
                with record_function(f"{tracing.JOB_RANGE}{job['job']}"):
                    rc, wall, stages, steps = run_job(
                        flye_main, job["argv"], torch, device)
                rec.settle()
                job.update(rc=rc, wall=wall, stages=stages, steps=steps)
                jobs.append(job)
                # each launch's bound ms, from its inputs, after the job
                bounds_of(roofs, rec.take_notes(), bounds)
                timed += wall
                if not another_job(timed, len(jobs), args.seconds, n_jobs):
                    break
                job = make(order[len(jobs)])
            if prof is not None:
                prof.stop()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        found = forbidden_modules()
        if found:
            print(f"portbench: loaded in this process: {found}",
                  file=sys.stderr)
            raise SystemExit(4)

        # after the window: the program's state freed, then the check
        from flye_tpu_torch.ops import polish
        polish._CLIMBS.clear()
        if device == "cuda":
            torch.cuda.empty_cache()
        n_failed = sum(1 for j in jobs if j["rc"] != 0)
        ok_jobs = [j for j in jobs if j["rc"] == 0]
        numbers, failed, (errors, bases) = checks.run_checks(
            rec, ok_jobs, cell["limits"], cell.get("must", []), args.seed,
            device)
        if n_failed:
            failed.append(f"{n_failed}_jobs_failed")
        e2e = {
            "read_mbp_s": read_rate(jobs),
            "qv": checks.ref_truth.qv(errors, bases),
            "peak_device_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        units = {m["name"]: m["unit"] for m in
                 bench["end_to_end"] + bench["per_layer"]}

        def mine(m):
            return args.workload in m.get("workloads", [args.workload])

        result = {"correct": not failed, "attempted": len(jobs),
                  "failed": n_failed}
        if trace:
            kernels, ranges = tracing.events_of(prof)
            red = tracing.reduce(kernels, ranges)
            view = RunView(jobs, red, bounds)
            metrics = {}
            for m in bench["per_layer"]:
                if mine(m):
                    v = load("metrics", m["name"]).read(view)
                    if v is not None:
                        metrics[m["name"]] = {"value": v,
                                              "unit": units[m["name"]]}
            result["metrics"] = metrics
        else:
            result["metrics"] = {
                m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                for m in bench["end_to_end"] if mine(m)}
        dev_name = (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu")
        result["device"] = {"platform": "gpu" if device == "cuda" else
                            "cpu", "kind": dev_name,
                            "count": cell["chips"],
                            "memory_peak_bytes": int(peak)}
        if trace:
            result["device"].update(busy_s=red["busy_s"],
                                    window_s=red["window_s"],
                                    power_limit=power_limit()
                                    if device == "cuda" else "none")
            result["breakdown"] = {"device_ops": red["device_ops"],
                                   "idle_gaps": red["idle_gaps"]}
        result["jobs"] = [{"wall_s": j["wall"], "read_bases":
                           j["read_bases"], "stages": j["stages"],
                           "truth": j.get("truth")} for j in jobs]
        result["recorder"] = {"calls": rec.calls, "host_s": rec.host_s,
                              "graph_captures": rec.captures,
                              "sampled": {k: len(v) for k, v in
                                          rec.samples.items()}}
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, (v, lim) in numbers.items()}
        if failed:
            result["checks"]["failed"] = failed
        lines = [f"check {n}: {v!r} (limit {lim!r})"
                 for n, (v, lim) in numbers.items()]
        lines += [f"check failed: {f}" for f in failed]
        return result, lines
    finally:
        shutil.rmtree(base, ignore_errors=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result, lines = run_cell(args)
    except SystemExit as e:
        return int(e.code or 1)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
