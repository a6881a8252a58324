"""The port's CUDA kernels against their plain versions.

This file imports no JAX, so it also runs on a machine with a GPU and
no JAX (the tests' conftest imports JAX; skip it there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked `gpu` skip without a CUDA device.  K1 and K5 must match
bit for bit; K2's rows exactly on their live region (rows below
cand_len, columns up to blen: the rest of its output is undefined), the
four raw score outputs of K2+K3 bit for bit, chars exactly; K4's
outputs must equal K2+K3's and the plain version's bit for bit.  The
device index paths (`ops.kmers.stream_probe_packed`,
`solid_select_device`: plain tensor code, no hand-written kernel) must
give on the card what they give on the CPU, bit for bit."""

import os

import numpy as np
import pytest
import torch

import flye_tpu_torch.ops.align as TA
import flye_tpu_torch.ops.polish as TP
from flye_tpu_torch.index import KmerIndex
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.ops.kmers import (solid_select_device,
                                      stream_probe_packed,
                                      stream_select_packed)
from flye_tpu_torch.ops.chain import _chain_dp_scan, chain_dp
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils.simulate import K1_ROW_KINDS, k1_row_kinds


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_matches(T, M, rng, noise=60):
    cur = np.sort(rng.integers(0, 40 * M, size=(T, M)), axis=1)
    ext = cur + 300 + rng.integers(-noise, noise, size=(T, M))
    nvalid = rng.integers(1, M + 1, size=T)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))


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


def test_require_rejects_bad_inputs():
    t = torch.zeros((2, 3), dtype=torch.int32)
    cpu = torch.device("cpu")
    _cuda.require(t, "t", torch.int32, (2, 3), cpu)
    with pytest.raises(ValueError, match="dtype"):
        _cuda.require(t, "t", torch.int64, (2, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        _cuda.require(t, "t", torch.int32, (3, 2), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.require(t.T, "t", torch.int32, (3, 2), cpu)


def test_header_change_marks_its_sources_stale(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or a csrc header the
    source includes is newer than it; a header it does not include
    leaves it alone."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "rows.cuh").write_text("// shared rows\n")
    (csrc / "other.cuh").write_text("// not included\n")
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "rows.cuh"\n')
    so = build / "libk.so"
    so.write_bytes(b"")
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build))
    t = so.stat().st_mtime
    for f in ("rows.cuh", "other.cuh", "k.cu"):
        os.utime(csrc / f, (t - 10, t - 10))
    assert not _cuda._stale("k")
    os.utime(csrc / "other.cuh", (t + 10, t + 10))
    assert not _cuda._stale("k")
    os.utime(csrc / "rows.cuh", (t + 10, t + 10))
    assert _cuda._stale("k")
    so.unlink()
    os.utime(csrc / "rows.cuh", (t - 10, t - 10))
    assert _cuda._stale("k")


def test_kernel_sources_list_the_shared_row_header():
    """K2+K3 and K4 both build from csrc/polish_rows.cuh."""
    for name in ("polish_score", "polish_fused"):
        heads = [os.path.basename(p) for p in _cuda._sources(name)[1:]]
        assert heads == ["polish_rows.cuh"], name


@pytest.mark.gpu
@pytest.mark.parametrize("kind,T,M,L,max_jump", [
    pytest.param("synthetic", *shape, 1500, id="-".join(map(str, shape)))
    for shape in [(32, 4096, 1024), (8, 300, 1024), (5, 200, 48),
                  (3, 64, 64)]] + [
    pytest.param(kind, T, M, L, mj, id=f"{kind}-{T}-{M}-{L}-{mj}")
    for kind in K1_ROW_KINDS
    for T, M, L, mj in [(6, 4096, 1024, 1500), (6, 512, 16, 50),
                        (600, 512, 48, 1500)]])
def test_chain_kernel_matches_plain(cuda_device, kind, T, M, L, max_jump):
    """Synthetic rows (with an empty and a one-match row) and the row
    kinds of the window cut, in both of K1's modes (a few rows: several
    warps per row; 600 rows: a warp per row): bit-identical, two
    launches bitwise equal."""
    rng = np.random.default_rng(T + M)
    if kind == "synthetic":
        cur, ext, nvalid = make_matches(T, M, rng)
        nvalid[0] = 0
        nvalid[1] = 1
    else:
        cur, ext, nvalid = k1_row_kinds(kind, T, M, max_jump, rng)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (cur, ext, nvalid)]
    before = _cuda.LAUNCHES["chain_dp"]
    s_k, p_k = chain_dp(*args, 15, max_jump, L)
    assert _cuda.LAUNCHES["chain_dp"] == before + 1
    s_k2, p_k2 = chain_dp(*args, 15, max_jump, L)
    s_p, p_p = _chain_dp_scan(*args, 15, max_jump, min(L, M))
    assert torch.equal(s_k, s_p)
    assert torch.equal(p_k, p_p)
    assert torch.equal(s_k, s_k2) and torch.equal(p_k, p_k2)


def check_pair_bitwise(args):
    """K2's live region against the plain rows, and K2+K3's four outputs
    bit for bit against the plain version; two launches bitwise equal.
    Returns (the kernels' raw outputs, the plain version's)."""
    cand, clen, branches, blen, bmask, subs = args
    _, R, S = branches.shape
    tables = TP._tables(cand, clen, branches, blen, subs)
    before = (_cuda.LAUNCHES["polish_backward"],
              _cuda.LAUNCHES["polish_forward_score"])
    bt = TP._backward_rows_cuda(cand, clen, branches, blen, subs, tables)
    raw_k = TP._forward_scores_cuda(cand, clen, branches, blen, bmask, subs,
                                    tables, bt)
    assert (_cuda.LAUNCHES["polish_backward"],
            _cuda.LAUNCHES["polish_forward_score"]) == (before[0] + 1,
                                                        before[1] + 1)
    Bm = TP._backward_rows(cand, clen, branches, blen, subs, tables)
    live = TP._bt_live(clen, blen, cand.shape[1], S)
    want = Bm[:-1].permute(1, 2, 0, 3)                 # [B, R, Cb, S+1]
    got = TP._bt_rows(bt, clen, blen, S)
    assert TP.bitwise_equal(got[live], want[live])
    raw_k2 = TP.score_edits_raw(*args)
    raw_p = TP._score_edits_raw(*args)
    for a, b, c in zip(raw_k, raw_k2, raw_p):
        assert TP.bitwise_equal(a, b)
        assert TP.bitwise_equal(a, c)
    return raw_k, raw_p


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 8, 96), (16, 160, 8, 240),
                                   (8, 48, 3, 63), (4, 32, 8, 31)])
def test_polish_kernels_match_plain(cuda_device, shape):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in polish_inputs(sum(shape), shape)]
    raw_k, raw_p = check_pair_bitwise(args)
    cand, clen = args[0], args[1]
    fk = TP._finish_scores(cand, clen, *raw_k, groups=1)
    fp = TP._finish_scores(cand, clen, *raw_p, groups=1)
    assert torch.equal(fk[3], fp[3]) and torch.equal(fk[5], fp[5])


def edge_inputs(case):
    """Inputs of one K2/K3 edge case: (B, Cb, R, S) and lengths set so
    that the case's rows, columns or branches sit at their limits."""
    shapes = {"blen": (2, 24, 6, 96), "clen": (3, 20, 4, 63),
              "branch0": (4, 24, 8, 96), "R1": (6, 20, 1, 96),
              "R32": (2, 20, 32, 63), "S31": (8, 32, 8, 31),
              "S63": (8, 48, 8, 63), "S96": (8, 64, 8, 96),
              "S127": (8, 96, 8, 127), "S240": (4, 160, 8, 240)}
    shape = shapes[case]
    cand, clen, branches, blen, bmask, subs = polish_inputs(
        sum(shape) + 2, shape)
    B, Cb, R, S = shape
    if case == "blen":      # every branch width a scan tile can meet
        blen[:] = [0, 1, 31, 32, 33, S]
    elif case == "clen":    # no candidate row, one, all
        clen[:] = [0, 1, Cb]
    elif case == "branch0":  # lanes with branch 0 the only live one
        bmask[:2, 1:] = False
        blen[:2, 1:] = 0
        blen[0, 0] = S
    elif case.startswith("S"):
        blen[0], blen[1] = S, 0
    return cand, clen, branches, blen, bmask, subs


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["blen", "clen", "branch0", "R1", "R32",
                                  "S31", "S63", "S96", "S127", "S240"])
def test_polish_kernels_edge_cases_bitwise(cuda_device, case):
    """K2+K3 at the edges of their tiling (branch widths around the
    32-column scan, candidate lengths 0, 1 and Cb, a lane scored by
    branch 0 alone, 1 and 32 branches, the register buckets up to S = 127
    and a chunked one) equal the plain version bit for bit."""
    check_pair_bitwise([torch.from_numpy(a).to(cuda_device)
                        for a in edge_inputs(case)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 8, 96), (32, 48, 8, 63),
                                   (8, 48, 3, 63), (4, 32, 8, 31)])
def test_fused_kernel_matches_pair_and_plain(cuda_device, shape):
    """K4 equals K2+K3 and the plain version bit for bit (the same
    arithmetic in the same order), chars exact."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in polish_inputs(sum(shape) + 1, shape)]
    cand, clen = args[0], args[1]
    before = _cuda.LAUNCHES["polish_fused"]
    raw_f = TP.score_edits_raw(*args, fused=True)
    raw_f2 = TP.score_edits_raw(*args, fused=True)
    assert _cuda.LAUNCHES["polish_fused"] == before + 2
    raw_pair = TP.score_edits_raw(*args)
    assert _cuda.LAUNCHES["polish_fused"] == before + 2
    for a, b, c in zip(raw_f, raw_f2, raw_pair):
        assert torch.equal(a, b) and torch.equal(a, c)
    raw_p = TP._score_edits_raw(*args)
    for a, b in zip(raw_f, raw_p):
        assert TP.bitwise_equal(a, b)
    fk = TP._finish_scores(cand, clen, *raw_f, groups=1)
    fp = TP._finish_scores(cand, clen, *raw_p, groups=1)
    assert torch.equal(fk[3], fp[3]) and torch.equal(fk[5], fp[5])


@pytest.mark.gpu
def test_hill_climb_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(7)
    B, C, Cb, S, R = 16, 30, 40, 60, 24
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 2)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    clen = np.full(B, C, np.int32)
    args = (cand, clen, branches, blen, bmask, subs)
    k = TP.polish_bubbles(*args, max_iters=2 * Cb, use_kernel=True,
                          device=cuda_device)
    p = TP.polish_bubbles(*args, max_iters=2 * Cb, use_kernel=False,
                          device=cuda_device)
    np.testing.assert_array_equal(k[0], p[0])
    np.testing.assert_array_equal(k[1], p[1])
    for i in range(B):
        np.testing.assert_array_equal(k[0][i, :k[1][i]], true[i])


def climb_inputs(B=16, C=30, Cb=40, S=60, R=24, seed=7):
    """Bubbles with two planted errors each and noisy branches (three
    groups of 8 branch rows a bubble)."""
    rng = np.random.default_rng(seed)
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
    blen = rng.integers(C - 2, C + 3, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.9
    bmask[:, 0] = True
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    return cand, np.full(B, C, np.int32), branches, blen, bmask, subs


@pytest.mark.gpu
@pytest.mark.parametrize("fused,route", [
    (False, ("polish_backward", "polish_forward_score")),
    (True, ("polish_fused",))])
def test_graph_climb_matches_host_stepped(cuda_device, monkeypatch, fused,
                                          route):
    """The CUDA-graph climb (K2+K3, and K4 with fused) writes the same
    candidates, lengths and scores as the host-stepped loop
    (FLYE_TPU_HOST_POLL) and all four outputs bit for bit as the same
    climb on the CPU through the plain version; LAUNCHES counts the
    graph's warm-up step and replays x captured launches exactly."""
    args = climb_inputs()
    monkeypatch.delenv("FLYE_TPU_HOST_POLL", raising=False)
    TP._CLIMBS.clear()
    outs = []
    for _ in range(2):          # capture, then the cached graph
        before = dict(_cuda.LAUNCHES)
        outs.append(TP.polish_bubbles(*args, max_iters=80, fused=fused,
                                      device=cuda_device))
        took = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        (climb,) = TP._CLIMBS.values()
        graph = climb.graph
        assert set(graph.launches) == set(route)
        for name in route:
            per_step = graph.launches[name] // TP._CLIMB_STEPS
            assert graph.launches[name] == per_step * TP._CLIMB_STEPS > 0
            warm = per_step if len(outs) == 1 else 0
            assert took[name] == warm + graph.launches[name] * (
                graph.replays - getattr(graph, "_seen", 0))
        graph._seen = graph.replays
        assert sum(took.values()) == sum(took[n] for n in route)
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()
    cpu = TP.polish_bubbles(*args, max_iters=80, device="cpu",
                            resident=True)
    for a, b in zip(outs[0], cpu):
        assert a.tobytes() == b.tobytes()
    monkeypatch.setenv("FLYE_TPU_HOST_POLL", "1")
    before = dict(_cuda.LAUNCHES)
    host = TP.polish_bubbles(*args, max_iters=80, fused=fused,
                             device=cuda_device)
    assert _cuda.LAUNCHES[route[0]] > before[route[0]]
    for a, b in zip(outs[0][:3], host[:3]):
        assert a.tobytes() == b.tobytes()


def lev_inputs(B, S, seed, codes=(0, 1, 2, 3)):
    """Random and related pairs with the edge rows first: alen 0, blen
    0, both 0, both full, identical full-length strings; the codes drawn
    from `codes`."""
    rng = np.random.default_rng(seed)
    pick = np.asarray(codes, np.uint8)
    a = pick[rng.integers(0, len(pick), (B, S))]
    b = pick[rng.integers(0, len(pick), (B, S))]
    half = B // 2
    mut = rng.random((half, S)) < 0.1
    b[:half] = np.where(mut, b[:half], a[:half])
    al = rng.integers(0, S + 1, B).astype(np.int32)
    bl = rng.integers(0, S + 1, B).astype(np.int32)
    al[:5] = [0, S, 0, S, S]
    bl[:5] = [S, 0, 0, S, S]
    b[4] = a[4]
    return a, al, b, bl


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(4096, 16), (4096, 64), (1024, 64),
                                 (256, 256), (64, 1024), (37, 100)])
def test_levenshtein_kernel_matches_plain(cuda_device, B, S):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in lev_inputs(B, S, B + S)]
    before = _cuda.LAUNCHES["levenshtein"]
    d_k = TA.edit_distance_batch(*args)
    d_k2 = TA.edit_distance_batch(*args)
    assert _cuda.LAUNCHES["levenshtein"] == before + 2
    d_p = TA._edit_distance_plain(*args)
    assert torch.equal(d_k, d_p)
    assert torch.equal(d_k, d_k2)
    assert d_k[:5].tolist() == [S, S, 0, int(d_p[3]), 0]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(512, 16), (512, 64), (32, 1024),
                                 (6, 16384)])
def test_levenshtein_kernel_codes_past_3_match_plain(cuda_device, B, S):
    """Codes 4, 200 and 255 beside 0-3 (the general match path of the
    bit-parallel rows), up to the widest rows the kernel takes."""
    args = [torch.from_numpy(x).to(cuda_device)
            for x in lev_inputs(B, S, B + S + 1, (0, 1, 2, 3, 4, 200, 255))]
    d_k = TA.edit_distance_batch(*args)
    d_p = TA._edit_distance_plain(*args)
    assert torch.equal(d_k, d_p)
    assert d_k[:5].tolist() == [S, S, 0, int(d_p[3]), 0]


def anchored_inputs(seed, n_ov, per_ov, length, n_seqs, use_hpc, device):
    """Random strands with homopolymer runs, resident on device, and
    n_ov overlaps between random strands of them, each with per_ov
    ascending anchors (a few sparse, so every bucket and the cut over
    1024 are reached, and some past the strand's end)."""
    rng = np.random.default_rng(seed)
    store = SequenceStore()
    for i in range(n_seqs):
        codes = rng.integers(0, 4, length)
        store.add(f"s{i}", np.repeat(codes, rng.integers(1, 4, length))[
            :length].astype(np.uint8))
    res = TA.ResidentStrands(store, device, use_hpc)
    anchors, owner, meta = [], [], []
    for o in range(n_ov):
        sid, eid = (int(x) for x in rng.integers(0, 2 * n_seqs, 2))
        k = per_ov if o % 8 else max(2, per_ov // 500)
        top = length + (200 if o % 5 == 0 else 0)
        anchors.append(np.stack([np.sort(rng.integers(0, top, k)),
                                 np.sort(rng.integers(0, top, k))], 1))
        owner.append(np.full(k, o, np.int32))
        meta.append((res.base([sid])[0], length, res.base([eid])[0], length))
    return (res, np.concatenate(anchors), np.concatenate(owner),
            np.array(meta, np.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("use_hpc,n_ov,per_ov", [(True, 64, 300),
                                                 (False, 64, 300),
                                                 (True, 448, 12000)])
def test_anchored_kernels_match_plain(cuda_device, use_hpc, n_ov, per_ov,
                                     monkeypatch):
    """The anchored segment pass on the card (`anchor_geometry`,
    `anchor_rows`, then K5 per bucket) equals its plain versions run on
    the card, bit for bit, each kernel alone and the whole pass, up to a
    batch of more than 2^22 segments; one geometry launch, one row
    gather and one K5 launch a bucket."""
    res, anc, owner, meta = anchored_inputs(n_ov + per_ov, n_ov, per_ov,
                                            64_000, 32, use_hpc,
                                            cuda_device)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
            for x in (anc.astype(np.int32), owner, meta)]
    geo_k = TA._anchor_geometry_cuda(*args, res.run, res.run,
                                     TA.SEGMENT_BUCKETS)
    geo_p = TA._anchor_geometry_plain(*args, res.run, res.run,
                                      TA.SEGMENT_BUCKETS)
    for x, y in zip(geo_k, geo_p):
        assert x.dtype == y.dtype and torch.equal(x, y)
    key = geo_p[5]
    for b, S in enumerate(TA.SEGMENT_BUCKETS):
        idx = torch.nonzero(key == b + 1).flatten()
        if idx.numel():
            rows_k = TA._anchor_rows_cuda(res.codes, res.codes,
                                          *geo_p[:4], idx, S)
            rows_p = TA._anchor_rows_plain(res.codes, res.codes,
                                           *geo_p[:4], idx, S)
            for x, y in zip(rows_k, rows_p):
                assert x.dtype == y.dtype and torch.equal(x, y)
            del rows_k, rows_p
    before = dict(_cuda.LAUNCHES)
    d_k = TA.anchored_distances(res, res, anc, owner, meta)
    took = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}
    buckets = int(torch.unique(key[key > 0]).numel())
    assert took["anchor_geometry"] == 1
    assert took["anchor_rows"] == took["levenshtein"] == buckets >= 3
    before = dict(_cuda.LAUNCHES)
    with monkeypatch.context() as m:
        for name in ("_anchor_geometry", "_anchor_rows", "_edit_distance"):
            m.setattr(TA, f"{name}_cuda", getattr(TA, f"{name}_plain"))
        d_p = TA.anchored_distances(res, res, anc, owner, meta)
    assert _cuda.LAUNCHES == before
    np.testing.assert_array_equal(d_k, d_p)
    assert int(geo_p[4].max()) > 0       # a side cut at 1024
    if n_ov * per_ov > 2 ** 22:
        assert int((key > 0).sum()) >= 2 ** 22


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["assembly", "repeat"])
def test_engine_on_card_equals_cpu(cuda_device, mode, tmp_path):
    """A small HiFi simulation through `OverlapEngine`: on the card it
    takes the resident path by itself and gives the overlaps of the CPU's
    host path: coordinates, divergence, each overlap's per_seg and spans."""
    from test_torch_anchored import _hifi_store, engine_run

    from flye_tpu_torch.assemble.driver import build_read_index
    from flye_tpu_torch.config.params import Config
    store = _hifi_store()
    index = build_read_index(store, Config("hifi"))
    cpu = engine_run(store, index, mode, None, tmp_path / "cpu")
    set_runtime(ParallelContext(cuda_device))
    card = engine_run(store, index, mode, "runtime", tmp_path / "card")
    assert card[0] == cpu[0]
    assert card[1] == cpu[1]
    assert card[2]["align.anchored_segments"] == \
        cpu[2]["align.packed_segments"] > 1000
    assert "align.packed_segments" not in card[2]


# (Cb, S, R) of the polisher's buckets the JAX package fuses (K4's route)
FUSED_BUCKETS = [(32, 31, 8), (48, 63, 8), (64, 96, 8), (96, 127, 8),
                 (160, 240, 8), (32, 31, 16), (48, 63, 16), (64, 96, 16),
                 (96, 127, 16), (32, 31, 32), (48, 63, 32), (64, 96, 32),
                 (32, 31, 56), (48, 63, 56)]


@pytest.mark.gpu
@pytest.mark.parametrize("Cb,S,R", FUSED_BUCKETS)
def test_fused_kernel_at_the_jax_fused_buckets(cuda_device, Cb, S, R):
    """K4 at every bucket it takes: all four outputs equal the plain
    version's bit for bit, and K2+K3's where they take R."""
    shape = (8, Cb, R, S)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in polish_inputs(Cb + S + R, shape)]
    assert TP.cuda_route(True, Cb, R, S) == "polish_fused"
    before = _cuda.LAUNCHES["polish_fused"]
    raw_f = TP.score_edits_raw(*args, fused=True)
    assert _cuda.LAUNCHES["polish_fused"] == before + 1
    for a, b in zip(raw_f, TP._score_edits_raw(*args)):
        assert TP.bitwise_equal(a, b)
    if R <= 32:
        for a, b in zip(raw_f, TP._score_edits_raw_cuda(*args)):
            assert TP.bitwise_equal(a, b)


def _kernel_unavailable(monkeypatch):
    """Make every kernel library fail to build, and the plain loop fail
    the test if the wrapper ever falls back to it."""
    def no_lib(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}")

    def no_plain(*args):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(_cuda, "lib", no_lib)
    monkeypatch.setattr(TA, "_edit_distance_plain", no_plain)


@pytest.mark.gpu
def test_levenshtein_cuda_tensor_raises_without_kernel(cuda_device,
                                                       monkeypatch):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in lev_inputs(16, 16, 1)]
    _kernel_unavailable(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TA.edit_distance_batch(*args)


def test_levenshtein_device_tensor_never_runs_plain(monkeypatch):
    """Any tensor that is not on the CPU takes the kernel route and
    raises when the kernel is unavailable (meta tensors stand in for a
    device here)."""
    meta = [torch.empty((8, 16), dtype=torch.uint8, device="meta"),
            torch.empty(8, dtype=torch.int32, device="meta"),
            torch.empty((8, 16), dtype=torch.uint8, device="meta"),
            torch.empty(8, dtype=torch.int32, device="meta")]
    _kernel_unavailable(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TA.edit_distance_batch(*meta)
    with pytest.raises(ValueError, match="segment width"):
        TA._edit_distance_cuda(
            *[torch.empty((2, 32768) if i % 2 == 0 else (2,),
                          dtype=torch.uint8 if i % 2 == 0
                          else torch.int32, device="meta")
              for i in range(4)])


def _raw_index(k=17):
    """Simulated raw reads (100 kb genome, 20x, 8% error, with a read
    shorter than k and an empty one) and their solid-k-mer index, built
    on the host."""
    from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
    genome = random_genome(100_000, seed=5, repeat_spec=[(2000, 3)])
    store = SequenceStore()
    for name, codes in simulate_reads(genome, coverage=20, mean_length=8000,
                                      error_rate=0.08, seed=6):
        store.add(name, codes)
    store.add("short", genome[:k - 1])
    store.add("empty", genome[:0])
    idx = KmerIndex.build_solid(store, k, select_rate=0.1, tandem_freq=100,
                                repeat_kmer_rate=3)
    return store, idx


@pytest.mark.gpu
@pytest.mark.parametrize("narrow", [True, False])
def test_stream_probe_on_card_matches_cpu(cuda_device, narrow):
    """The raw path's probe batches ([512 | 64, 16384], k = 17) over
    both strands of the reads, card against CPU."""
    store, idx = _raw_index()
    starts, n_total, stream = idx._read_stream(store, store.ids(True))
    starts_p = idx._padded_starts(starts, n_total)
    up, rp = idx._device_tables()
    step = idx._STREAM_W - (idx.k - 1)
    seen = 0
    for r0, chunk in list(idx._stream_chunks(stream, n_total, 1))[-3:]:
        args = [torch.from_numpy(x) for x in (chunk, starts_p)]
        kw = dict(k=idx.k, step=step, narrow=narrow)
        cpu = stream_probe_packed(args[0], args[1], r0, n_total, up, rp,
                                  idx.num_kmers - 1, **kw)
        card = stream_probe_packed(
            args[0].to(cuda_device), args[1].to(cuda_device), r0, n_total,
            up.to(cuda_device), rp.to(cuda_device), idx.num_kmers - 1,
            **kw)
        assert torch.equal(card.cpu(), cpu)
        seen |= int(((cpu >> (28 if narrow else 32)) & 3).max())
    assert seen


@pytest.mark.gpu
@pytest.mark.parametrize("sample", [1, 2])
def test_solid_select_on_card_matches_cpu(cuda_device, sample):
    store, idx = _raw_index()
    starts, n_total, stream = idx._read_stream(store, store.ids())
    starts_p = torch.from_numpy(idx._padded_starts(starts, n_total))
    W, step = idx._STREAM_W, idx._STREAM_W - (idx.k - 1)
    packed = torch.cat([
        stream_select_packed(torch.from_numpy(chunk), starts_p, r0,
                             n_total, k=idx.k, w=1, sample=sample,
                             step=step).view(-1)
        for r0, chunk in idx._stream_chunks(stream, n_total, 1)])
    idx90 = torch.from_numpy(idx._p90_ranks(np.diff(starts), idx.k, sample,
                                            len(starts_p)))
    kw = dict(k=idx.k, W=W, step=step, tandem_freq=100, global_min=2)
    pk, pg, n = solid_select_device(packed, starts_p, idx90, 0.1, **kw)
    cpk, cpg, cn = solid_select_device(
        packed.to(cuda_device), starts_p.to(cuda_device),
        idx90.to(cuda_device), 0.1, **kw)
    assert 0 < n == cn
    assert torch.equal(cpk.cpu(), pk) and torch.equal(cpg.cpu(), pg)
