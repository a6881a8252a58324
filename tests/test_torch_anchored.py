"""The anchored segment path of the overlap engine on the CPU.

On one card the engine flattens a batch's anchors on the host
(`OverlapEngine._flat_anchors`) and derives, gathers and scores every
inter-anchor segment on the device from the reads kept there
(`ops.align.ResidentStrands`, `ops.align.anchored_distances`).  Here the
flattening is held against `_anchors_for` overlap by overlap, the plain
versions of the device pass against `anchored_divergence` +
`SegmentBatcher.run` (the host path, which `--device cpu` runs), and the
engine's two paths against each other on simulated HiFi reads."""

import numpy as np
import pytest
import torch

from flye_tpu_torch.assemble.driver import build_read_index
from flye_tpu_torch.config.params import Config
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.ops.align import (ResidentStrands, SegmentBatcher,
                                      anchored_distances,
                                      anchored_divergence)
from flye_tpu_torch.overlap import OverlapEngine
from flye_tpu_torch.overlap.structs import Overlap
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.utils import trace
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _overlaps(case, rng, n=40):
    """Overlaps whose k-mer matches lie in order, out of order, on ties,
    outside the overlap, or are missing."""
    ovs = []
    for i in range(n):
        cb, eb = int(rng.integers(0, 500)), int(rng.integers(0, 500))
        span = int(rng.integers(50, 4000))
        ov = Overlap(2 * i, 2 * i + 3, cb, cb + span, 9000, eb,
                     eb + span + int(rng.integers(-20, 20)), 9000)
        k = int(rng.integers(0, 120))
        c = np.sort(rng.integers(cb - 30, cb + span + 30, k))
        e = c - cb + eb + rng.integers(-3, 4, k)
        km = np.stack([c, e], axis=1)
        kind = case if case != "mixed" else rng.choice(
            ["ascending", "shuffled", "ties", "empty"])
        if kind == "shuffled" and k > 3:
            km = km[rng.permutation(k)]
        elif kind == "ties" and k > 6:
            km[2:5, 1] = km[2, 1]
        elif kind == "empty":
            km = km[:0]
        ov.kmer_matches = np.clip(km, 0, None).astype(np.int32)
        ovs.append(ov)
    return ovs


@pytest.mark.parametrize("case", ["ascending", "shuffled", "ties", "empty",
                                  "mixed", "none"])
def test_flat_anchors_equal_anchors_for(case, tmp_path):
    """`_flat_anchors` gives each overlap's `_anchors_for`, and counts the
    overlaps that take its greedy pass."""
    rng = np.random.default_rng(len(case))
    ovs = _overlaps(case, rng) if case != "none" else []
    with trace.job(str(tmp_path)):
        flat, off = OverlapEngine.__new__(OverlapEngine)._flat_anchors(ovs)
    rec = trace.job_record(str(tmp_path))
    assert flat.dtype == np.int32 and len(off) == len(ovs) + 1
    fallbacks = 0
    for o, ov in enumerate(ovs):
        ref = OverlapEngine._anchors_for(None, ov)
        np.testing.assert_array_equal(flat[off[o]:off[o + 1]], ref)
        inner = ref[1:-1]
        km = np.asarray(ov.kmer_matches, np.int64)
        strict = km[(ov.cur_begin < km[:, 0]) & (km[:, 0] < ov.cur_end)
                    & (ov.ext_begin < km[:, 1]) & (km[:, 1] < ov.ext_end)]
        fallbacks += len(strict) != len(inner) or not np.array_equal(
            strict, inner)
    assert rec["counters"]["align.anchor_fallbacks"] == fallbacks
    if case in ("shuffled", "ties"):
        assert fallbacks > 0


CODES_PAST_3 = np.array([4, 200, 255], np.uint8)


def _store(rng, n, length, past_3=False):
    store = SequenceStore()
    for i in range(n):
        codes = rng.integers(0, 4, int(rng.integers(length // 2, length)))
        codes = np.repeat(codes, rng.integers(1, 4, len(codes)))
        codes = codes[:length].astype(np.uint8)
        if past_3:
            hit = rng.random(len(codes)) < 0.1
            codes[hit] = CODES_PAST_3[rng.integers(0, 3, hit.sum())]
        store.add(f"s{i}", codes)
    return store


def _anchors(case, rng, alen, blen):
    """Ascending anchors over two strands of these lengths."""
    k = int(rng.integers(2, 60))
    top = 400 if case == "past_end" else 0
    c = np.sort(rng.integers(0, alen + top + 1, k))
    e = np.sort(rng.integers(0, blen + top + 1, k))
    if case == "empty_sides":
        c[1::3] = c[0::3][:len(c[1::3])]      # empty a sides
        e[1::2] = e[0::2][:len(e[1::2])]      # empty b sides, both at times
        c, e = np.sort(c), np.sort(e)
    if case == "over_1024":
        k = max(3, k)
        c = np.sort(np.concatenate([[0, min(alen, 1500)],
                                    rng.integers(0, alen + 1, k - 2)]))
        e = np.sort(np.concatenate([[0, min(blen, 40)],
                                    rng.integers(0, blen + 1, k - 2)]))
        if rng.random() < 0.5:
            c, e = e, c
    return np.stack([c, e], axis=1).astype(np.int64)


@pytest.mark.parametrize("use_hpc", [False, True])
@pytest.mark.parametrize("case", ["both_strands", "codes_past_3",
                                  "empty_sides", "over_1024", "past_end"])
def test_anchored_distances_plain_equal_host(case, use_hpc, tmp_path):
    """The device pass's plain versions score every segment as
    `anchored_divergence` + `SegmentBatcher.run`: both strands of two
    stores, codes past 3 (forward strands: the host complement takes
    only 0-3), segments empty on one side or both, sides over 1024 (cut,
    and charged the rest), anchors past a strand's end."""
    rng = np.random.default_rng([len(case), use_hpc])
    past_3 = case == "codes_past_3"
    length = 3000 if case == "over_1024" else 1200
    qs = _store(rng, 4, length, past_3)
    ts = qs if past_3 else _store(rng, 3, length)
    strands = 1 if past_3 else 2
    k = 15
    batcher = SegmentBatcher()
    pending, flat, owner, meta = [], [], [], []
    q_res = ResidentStrands(qs, "cpu", use_hpc)
    t_res = q_res if ts is qs else ResidentStrands(ts, "cpu", use_hpc)
    for o in range(30):
        sid = 2 * int(rng.integers(0, len(qs))) + int(rng.integers(0,
                                                                  strands))
        eid = 2 * int(rng.integers(0, len(ts))) + int(rng.integers(0,
                                                                  strands))
        anc = _anchors(case, rng, qs.length(sid), ts.length(eid))
        pending.append(anchored_divergence(qs.get(sid), ts.get(eid), anc, k,
                                           use_hpc=use_hpc, batcher=batcher))
        flat.append(anc)
        owner.append(np.full(len(anc), o, np.int32))
        meta.append((q_res.base([sid])[0], qs.length(sid),
                     t_res.base([eid])[0], ts.length(eid)))
    queued = batcher._n
    ref = batcher.run()
    before = dict(_cuda.LAUNCHES)
    with trace.job(str(tmp_path)):
        dist = anchored_distances(q_res, t_res, np.concatenate(flat),
                                  np.concatenate(owner), np.array(meta))
    live = trace.job_record(str(tmp_path))["counters"][
        "align.anchored_segments"]
    assert _cuda.LAUNCHES == before
    assert dist.dtype == np.int64
    off = np.cumsum([0] + [len(a) for a in flat])
    assert live == queued
    charged = 0
    for o, fin in enumerate(pending):
        div, per_seg, spans = fin(ref)
        got = dist[off[o]:off[o + 1] - 1]
        np.testing.assert_array_equal(got, per_seg)
        charged += per_seg.sum()
    # the slots between two overlaps score 0
    assert (dist[off[1:-1] - 1] == 0).all()
    assert dist.sum() == charged
    if case == "over_1024":
        assert dist.max() > 1024 // 2


def _hifi_store():
    genome = random_genome(5000, seed=3, repeat_spec=[(600, 2)])
    reads = simulate_reads(genome, coverage=12, mean_length=2500,
                           min_length=1000, error_rate=0.005, seed=5)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


@pytest.fixture(scope="module")
def hifi():
    set_runtime(ParallelContext("cpu"))
    store = _hifi_store()
    yield store, build_read_index(store, Config("hifi"))
    set_runtime(None)


def engine_run(store, index, mode, device, tmp_path):
    """get_overlaps_batch over both strands of every read, with segments
    scored on `device`'s resident path (None: the host path; "runtime":
    the engine's own choice); returns the overlaps as tuples, each
    overlap's (per_seg, spans) as `_keep_or_trim` received them, and the
    job's counters."""
    kw = dict(max_jump=1500, min_overlap=1000, max_overhang=500,
              only_max_ext=True, nucl_alignment=True, use_hpc=True)
    if mode == "repeat":
        kw.update(max_overhang=0, only_max_ext=False, keep_alignment=True,
                  partition_bad_mappings=True, max_divergence=0.004)
    if mode == "raw":
        kw.update(use_hpc=False)
    eng = OverlapEngine(store, index, **kw)
    if device != "runtime":
        eng._resident_device = lambda query_store: device
    segs = []
    keep = eng._keep_or_trim

    def keep_or_trim(ov, seg_info, *rest):
        segs.append(tuple(np.asarray(x).tolist() for x in seg_info))
        return keep(ov, seg_info, *rest)
    eng._keep_or_trim = keep_or_trim
    with trace.job(str(tmp_path)):
        res = eng.get_overlaps_batch(store, store.ids(both_strands=True))
    ovs = {sid: [(o.cur_id, o.ext_id, o.cur_begin, o.cur_end, o.ext_begin,
                  o.ext_end, o.score, o.divergence,
                  type(o.divergence).__name__,
                  np.asarray(o.kmer_matches).tolist()) for o in v]
           for sid, v in res.items()}
    return ovs, segs, trace.job_record(str(tmp_path))["counters"]


@pytest.mark.parametrize("mode", ["assembly", "repeat", "raw"])
def test_engine_resident_path_equals_host_path(hifi, mode, tmp_path):
    """The engine's resident path (its plain versions on the CPU) keeps
    and trims the same overlaps with the same divergences and segment
    distances as the host path, and counts its segments as anchored,
    none as packed."""
    store, index = hifi
    host = engine_run(store, index, mode, None, tmp_path / "host")
    res = engine_run(store, index, mode, torch.device("cpu"),
                     tmp_path / "resident")
    assert res[0] == host[0]
    assert res[1] == host[1]
    assert sum(map(len, host[0].values())) > 20
    assert host[2]["align.packed_segments"] > 1000
    assert res[2]["align.anchored_segments"] == \
        host[2]["align.packed_segments"]
    assert "align.packed_segments" not in res[2]
    assert "align.anchored_segments" not in host[2]
    if mode == "repeat":   # some overlaps were trimmed
        assert sum(map(len, res[0].values())) != len(res[1])
