"""The window's arithmetic: the rate over jobs, the rule for starting
another job, qv and its cap, the stage and step times, the idle share
and gaps on a synthetic trace, and the metric readers."""

import logging
import math

import numpy as np
import pytest
import torch

import run
import tracing
from reference import truth


def test_rate_is_all_bases_over_all_walls():
    jobs = [{"read_bases": 10_000_000, "wall": 20.0},
            {"read_bases": 10_000_000, "wall": 30.0}]
    assert run.read_rate(jobs) == pytest.approx(20.0 / 50.0)


@pytest.mark.parametrize("timed,n,seconds,jobs,more", [
    (0.0, 0, 51, 2, True), (22.0, 1, 51, 2, True), (44.0, 2, 51, 2, False),
    (50.9, 9, 51, 10, True), (51.0, 9, 51, 10, False),
    (60.0, 0, 10, 1, True), (60.0, 1, 10, 2, False)])
def test_another_job_until_the_cells_jobs_or_the_seconds_are_done(
        timed, n, seconds, jobs, more):
    assert run.another_job(timed, n, seconds, jobs) is more


def test_qv_and_its_cap():
    assert truth.qv(1, 10_000) == pytest.approx(40.0)
    assert truth.qv(10, 1_000_000) == pytest.approx(50.0)
    # no error found: counted as one, so the cap is 10 log10(bases)
    assert truth.qv(0, 200_000) == pytest.approx(10 * math.log10(200_000))


def test_semi_global_counts_edits_of_the_whole_window_only():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 4, 300, dtype=np.uint8)
    a = b[100:200].copy()
    a[10] = (a[10] + 1) % 4                       # one substitution
    a = np.delete(a, 50)                          # one deletion
    A = torch.from_numpy(np.stack([a, b[:99]]))
    B = torch.from_numpy(np.stack([b, b]))
    d = truth.semi_global(A, torch.tensor([99, 99], dtype=torch.int32), B,
                          torch.tensor([300, 300], dtype=torch.int32))
    assert d.tolist() == [2, 0]


def test_truth_score_counts_errors_and_the_missing_genome_apart():
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 20_000, dtype=np.uint8)
    exact = truth.score_job([("c", np.roll(g, -777))], g, "cpu")
    assert exact["errors"] == 0 and exact["uncovered"] == 0
    assert exact["bases"] == 20_000
    bad = g.copy()
    bad[[1000, 5000, 9000]] = (bad[[1000, 5000, 9000]] + 1) % 4
    half = truth.score_job([("c", bad[:10_000])], g, "cpu")
    assert (half["errors"], half["bases"]) == (3, 10_000)
    # three errors in three of the five windows
    assert (half["windows"], half["erring_windows"]) == (5, 3)
    assert 9_800 <= half["uncovered"] <= 10_000
    junk = rng.integers(0, 4, 3000, dtype=np.uint8)
    mixed = truth.score_job([("c", g), ("j", junk)], g, "cpu")
    # an unanchored window counts all its bases as errors
    assert mixed["unanchored"] == 2 and mixed["errors"] == 3000
    assert mixed["erring_windows"] == 2
    rc = truth.score_job([("c", truth.COMPLEMENT[g[::-1]])], g, "cpu")
    assert rc["errors"] == 0


def test_the_check_holds_each_output_to_the_error_and_coverage_limits(
        tmp_path):
    import checks
    import gen
    from hooks import Recorder
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 20_000, dtype=np.uint8)
    jobs = []
    for i, out in enumerate([g, g[:13_000]]):
        path = str(tmp_path / f"a{i}.fasta")
        gen.write_fasta([("c", out)], path)
        jobs.append({"genome": g, "output": path})
    limits = {"err_ppm_max": 400, "err_window_share": 0.3,
              "uncovered_share": 0.05}
    numbers, failed, (errors, bases) = checks.run_checks(
        Recorder(1, {}), jobs, limits, [], 1, "cpu")
    assert numbers["err_ppm_max"] == (0.0, 400)
    assert numbers["err_window_share"] == (0.0, 0.3)
    # the worst job left 7,000 of 20,000 bases out
    assert numbers["uncovered_share"][0] == pytest.approx(0.35, abs=0.01)
    assert failed == ["uncovered_share"]
    assert (errors, bases) == (0, 33_000)


def stage_log(records):
    log = run.StageLog()
    logger = logging.getLogger("portbench-test")
    for msg, t in records:
        rec = logger.makeRecord("x", logging.INFO, "f", 1, msg, (), None)
        rec.created = t
        log.emit(rec)
    return log


def test_stage_and_step_times_from_the_log():
    log = stage_log([(">>> STAGE: assembly", 10.0),
                     ("overlap prefetch: started", 11.0),
                     ("overlap prefetch: done in 2.0 s [RSS]", 13.5),
                     (">>> STAGE: consensus", 20.0),
                     ("polishing iteration 1/1: started", 20.5),
                     ("polish: bubble kernels: started", 21.0),
                     ("polish: bubble kernels: done in 1.0 s", 22.25),
                     ("polishing iteration 1/1: done in 4.0 s", 24.5)])
    assert log.stages(30.0) == {"assembly": 10.0, "consensus": 10.0}
    assert dict(log.steps) == {"overlap prefetch": 2.5,
                               "polish: bubble kernels": 1.25,
                               "polishing iteration 1/1": 4.0}


@pytest.mark.parametrize("raw,name", [
    ("void chain_dp_kernel<1>(int const*, int)", "chain_dp_kernel<1>"),
    ("void (anonymous namespace)::polish_backward_kernel<4>(float*)",
     "(anonymous namespace)::polish_backward_kernel<4>"),
    ("at::native::vectorized_elementwise_kernel<2, F, std::array<char*, "
     "1ul> >(int, F, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel<2, F, std::array<char*, "
     "1ul> >"), ("Kernel", "Kernel")])
def test_kernel_names_lose_their_arguments_only(raw, name):
    assert tracing.kernel_name(raw) == name


def synthetic_trace():
    s = 1_000_000_000
    ranges = [(0, 10 * s, "portbench job 1"), (12 * s, 22 * s,
                                                 "portbench job 2"),
              (1 * s, 5 * s, "stage assembly"),
              (2 * s, 4 * s, "overlap prefetch"),
              (5 * s, 10 * s, "stage consensus"),
              (13 * s, 21 * s, "polish: bubble kernels")]
    kernels = [(int(2.5 * s), 3 * s, "void chain_dp_kernel<1>(int const*)"),
               (int(2.75 * s), int(3.5 * s), "polish_backward_kernel"),
               (11 * s, int(12.5 * s), "outside_then_inside"),
               (14 * s, 15 * s, "void polish_forward_score_kernel<4>(x)")]
    return kernels, ranges


def test_idle_share_busy_time_and_gaps_on_a_synthetic_trace():
    red = tracing.reduce(*synthetic_trace())
    assert red["window_s"] == pytest.approx(20.0)
    # busy: [2.5, 3.5] in job 1, [12, 12.5] and [14, 15] in job 2
    assert red["busy_s"] == pytest.approx(2.5)
    assert red["idle_share"] == pytest.approx(1 - 2.5 / 20)
    names = dict(red["device_ops"])
    assert names["chain_dp_kernel<1>"] == pytest.approx(0.5)
    assert names["polish_forward_score_kernel<4>"] == pytest.approx(1.0)
    gaps = red["idle_gaps"]
    # each gap labelled by the innermost range open where it starts
    assert gaps == [["polish: bubble kernels", pytest.approx(7.0)],
                    ["overlap prefetch", pytest.approx(6.5)],
                    ["between the program's ranges", pytest.approx(2.5)],
                    ["between the program's ranges", pytest.approx(1.5)]]


def view(jobs, red=None, k1=(), pairs=()):
    bounds = {"chain_dp": [(1, ms) for ms in k1],
              "polish_pair": list(pairs)}
    return run.RunView(jobs, red, {k: v for k, v in bounds.items() if v})


def test_metric_readers():
    jobs = [{"stages": {"assembly": 4.0, "repeat": 1.0},
             "steps": [("overlap prefetch", 2.0),
                       ("polishing iteration 1/1", 3.0),
                       ("polish: bubble kernels", 1.0),
                       ("polishing iteration 1/1", 5.0)]},
            {"stages": {"assembly": 6.0, "repeat": 3.0},
             "steps": [("overlap prefetch", 4.0),
                       ("polishing iteration 1/1", 2.0)]}]
    red = tracing.reduce(*synthetic_trace())
    v = view(jobs, red, k1=[100.0], pairs=[(2, 150.0)])
    read = {m: run.load("metrics", m).read(v) for m in (
        "assembly_s", "overlap_s", "polisher_s", "bubble_kernels_s",
        "repeat_s", "roofline.chain_dp", "roofline.polish_pair",
        "device_idle_share")}
    assert read["assembly_s"] == pytest.approx(5.0)
    assert read["overlap_s"] == pytest.approx(3.0)
    assert read["polisher_s"] == pytest.approx(5.0)
    assert read["bubble_kernels_s"] == pytest.approx(0.5)
    assert read["repeat_s"] == pytest.approx(2.0)
    assert read["roofline.chain_dp"] == pytest.approx(100 * 0.1 / 0.5)
    # K2 0.75 s + K3 1.0 s of device time for 2 pairs of 150 ms
    assert read["roofline.polish_pair"] == pytest.approx(100 * 0.3 / 1.75)
    assert read["device_idle_share"] == pytest.approx(87.5)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    jobs = [{"stages": {}, "steps": [("polishing iteration 1/1", 3.0)]}]
    v = view(jobs, {"kernel_s": {}, "idle_share": None})
    for m in ("assembly_s", "overlap_s", "repeat_s", "bubble_kernels_s",
              "roofline.chain_dp", "roofline.polish_pair",
              "device_idle_share"):
        assert run.load("metrics", m).read(v) is None, m
