"""The port's device-resident hill climb (`ops/polish._Climb`, steps of
`_climb_step`) against the JAX package's `_converge_loop`, and the
`--profile` trace.

The JAX side runs `flye_tpu`'s `polish_bubbles(..., use_pallas=True)`,
which reaches `_converge_pallas_packed` -> `_converge_loop`, with its
Pallas scoring in interpret mode (as tests/test_polish_pallas.py runs
it) or, for the max_iters cut-offs, through the kernel's plain reference
`_score_edits_raw_jnp`; the port runs the same climb on the CPU with the
plain scoring (`resident=True`).  Tolerances: cand, cand_len and iters
exact; score within 1e-3, the tolerance tests/test_polish_pallas.py:
42-45 holds the Pallas scoring to (the two packages group branches
differently, 16 a lane in the JAX package's packed kernels against 8, so
the sums differ in their last bits)."""

import filecmp
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flye_tpu.ops.polish as P
import flye_tpu.ops.polish_pallas as PP
import flye_tpu_torch.ops.polish as TP
from flye_tpu_torch import main as torch_main
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from test_torch_polish import _climb_inputs


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Route the JAX package's Pallas scoring through the interpreter."""
    orig = PP._score_edits_pallas
    monkeypatch.setattr(
        PP, "_score_edits_pallas",
        lambda *a, interpret=False, **k: orig(*a, interpret=True, **k))


def _assert_climbs_equal(ref, out):
    names = ("cand", "cand_len", "score", "iters")
    for name, r, o in zip(names, ref, out):
        r = np.asarray(r)
        assert r.shape == o.shape, name
        if name == "score":
            assert np.abs(r - o).max() < 1e-3, name
        else:
            np.testing.assert_array_equal(o, r, err_msg=name)


def _long_climb_inputs(seed=3):
    """Bubbles of 18 bases in a 24-base buffer, 3 branches with 3% noise
    and 7 planted errors a lane: with blocks of 8 (three blocks, so the
    block parity alternates) lanes still climb after 8 steps."""
    rng = np.random.default_rng(seed)
    B, C, Cb, S, R = 4, 18, 24, 24, 3
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.choice(C, 7, replace=False)
        cand[i, idx] = (cand[i, idx] + 1 + i % 3) % 4
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    flip = rng.random((B, R, S)) < 0.03
    branches = np.where(flip, rng.integers(0, 4, (B, R, S)),
                        branches).astype(np.uint8)
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    return (cand, np.full(B, C, np.int32), branches, blen, bmask, subs)


@pytest.mark.parametrize("R", [3, 24])
@pytest.mark.parametrize("noisy", [False, True])
def test_resident_climb_matches_converge_loop(interpret_pallas, R, noisy):
    _, args = _climb_inputs(R, noisy)
    ref = P.polish_bubbles(*args, max_iters=24, use_pallas=True)
    out = TP.polish_bubbles(*args, max_iters=24, device="cpu",
                            resident=True)
    _assert_climbs_equal(ref, out)


@pytest.fixture
def plain_pallas(monkeypatch):
    """Route the JAX package's Pallas scoring through its plain reference
    `_score_edits_raw_jnp` on the branches of `_long_climb_inputs` (the
    packed tables the loop hands the kernel are ignored), and drop the
    loop's compiled programs afterwards so no later caller meets them."""
    _, _, branches, blen, bmask, _ = _long_climb_inputs()

    def plain(cand, cand_len, subs, *prep, **kw):
        return P._score_edits_raw_jnp(cand, cand_len, jnp.asarray(branches),
                                      jnp.asarray(blen), jnp.asarray(bmask),
                                      subs)
    monkeypatch.setattr(PP, "_score_edits_pallas", plain)
    yield
    P._converge_pallas_packed.clear_cache()


@pytest.mark.parametrize("max_iters", [3, 7, 8])
def test_resident_climb_max_iters_guard(plain_pallas, monkeypatch,
                                        max_iters):
    """Cut off while lanes still climb (odd and even caps): the four
    outputs equal `_converge_loop`'s, and steps past the cap or past the
    last lane's convergence change nothing (chunks of 2 and of 8)."""
    args = _long_climb_inputs()
    ref = P.polish_bubbles(*args, max_iters=max_iters, block_size=8,
                           use_pallas=True)
    assert (np.asarray(ref[3]) == max_iters).all()
    outs = []
    for steps in (2, 8):
        monkeypatch.setattr(TP, "_CLIMB_STEPS", steps)
        outs.append(TP.polish_bubbles(*args, max_iters=max_iters,
                                      block_size=8, device="cpu",
                                      resident=True))
        _assert_climbs_equal(ref, outs[-1])
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


def test_resident_climb_past_convergence_is_a_no_op(monkeypatch):
    """A climb that converges long before its cap gives the same bytes
    however many steps run after the last lane is done."""
    _, args = _climb_inputs(3, True)
    outs = []
    for steps in (1, 3, 16):
        monkeypatch.setattr(TP, "_CLIMB_STEPS", steps)
        outs.append(TP.polish_bubbles(*args, max_iters=48, device="cpu",
                                      resident=True))
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert a.tobytes() == b.tobytes()


def test_resident_climb_default_routes():
    """On the CPU the default stays the native climber; the resident
    climb runs only when asked for."""
    _, args = _climb_inputs(24, True)
    native = TP.polish_bubbles(*args, max_iters=24, device="cpu")
    resident = TP.polish_bubbles(*args, max_iters=24, device="cpu",
                                 resident=True)
    host = TP.polish_bubbles(*args, max_iters=24, device="cpu",
                             use_kernel=False)
    for a, b, c in zip(native[:2], resident[:2], host[:2]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # the host loop counts at its polls, the resident climb every step
    # against the old done flag: one more for each lane
    np.testing.assert_array_equal(resident[3], host[3] + 1)


@pytest.mark.parametrize("seed,shape", [
    (0, (5, 24, 3, 40)), (2, (4, 20, 18, 60)), (5, (3, 16, 5, 130))])
def test_prepared_tables_are_bitwise_equal(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 4, (B, Cb)).astype(np.uint8),
        rng.integers(10, Cb + 1, B).astype(np.int32),
        rng.integers(0, 4, (B, R, S)).astype(np.uint8),
        rng.integers(8, S + 1, (B, R)).astype(np.int32),
        rng.random((B, R)) < 0.8,
        np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32))]
    _, _, branches, blen, bmask, subs = args
    prep = TP._prepare_branches(branches, blen, bmask, subs)
    ref = TP._score_edits_raw(*args)
    out = TP._score_edits_raw(*args, prep=prep)
    for r, o in zip(ref, out):
        assert TP.bitwise_equal(r, o)
    assert torch.equal(prep[2], bmask.to(torch.float32))


def test_profile_writes_a_trace_and_changes_no_output(tmp_path):
    """`--profile` on the CPU: a torch.profiler trace under
    OUT_DIR/profile that parses and holds the run's stages, and every
    other file as the run without it writes (the log aside)."""
    from flye_tpu_torch.io.fasta import write_fasta
    from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
    genome = random_genome(15000, seed=3)
    reads = tmp_path / "reads.fa"
    write_fasta(simulate_reads(genome, seed=5, coverage=12,
                               mean_length=3000, error_rate=0.03), reads)
    outs = {}
    for tag, extra in (("plain", []), ("profiled", ["--profile"])):
        outs[tag] = tmp_path / tag
        rc = torch_main.main(["--pacbio-raw", str(reads), "-g", "15k",
                              "-o", str(outs[tag]), "--device", "cpu",
                              "--stop-after", "assembly"] + extra)
        assert rc == 0
    traces = glob.glob(str(outs["profiled"] / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"stage configure", "stage assembly"} <= names
    assert sum(e.get("cat") == "cpu_op" for e in events) > 0

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if not os.path.relpath(d, root).startswith("profile")
                      and f != "flye.log")
    assert files(outs["plain"]) == files(outs["profiled"])
    assert files(outs["plain"])
    for rel in files(outs["plain"]):
        assert filecmp.cmp(outs["plain"] / rel, outs["profiled"] / rel,
                           shallow=False), rel
