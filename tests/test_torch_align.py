"""flye_tpu_torch edit distance (the K5 kernel's plain version), the
segment batcher and anchored divergence vs the JAX package.

Integer outputs: exact equality with the JAX package's jnp
`edit_distance_batch` and with its Pallas kernel in interpret mode
(the form tests/test_align_pallas.py runs on the CPU)."""

import numpy as np
import pytest
import torch

from flye_tpu.ops.align import SegmentBatcher as JaxBatcher
from flye_tpu.ops.align import anchored_divergence as jax_anchored
from flye_tpu.ops.align import edit_distance_batch as jax_edit
from flye_tpu.ops.align_pallas import edit_distance_batch_pallas
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.ops.align import (SegmentBatcher, anchored_divergence,
                                      edit_distance_batch)
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _pairs(B, S, seed, related=True):
    """Random pairs at width S with lengths 0 and S among them; half of
    the b rows are mutated copies of a, so distances span small to
    large."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, S)).astype(np.uint8)
    b = rng.integers(0, 4, (B, S)).astype(np.uint8)
    if related:
        mut = rng.random((B, S)) < 0.1
        b[: B // 2] = np.where(mut[: B // 2], b[: B // 2], a[: B // 2])
    al = rng.integers(0, S + 1, B).astype(np.int32)
    bl = rng.integers(0, S + 1, B).astype(np.int32)
    al[:4] = [0, S, 0, S]
    bl[:4] = [S, 0, 0, S]
    if B > 5:
        b[5], al[5], bl[5] = a[5], S, S      # identical strings
    return a, al, b, bl


def _torch(a, al, b, bl):
    return edit_distance_batch(torch.from_numpy(a), torch.from_numpy(al),
                               torch.from_numpy(b),
                               torch.from_numpy(bl)).numpy()


@pytest.mark.parametrize("B,S", [(13, 16), (37, 64), (16, 64), (9, 256)])
def test_edit_distance_equals_jnp_and_pallas(B, S):
    a, al, b, bl = _pairs(B, S, B * 1000 + S)
    got = _torch(a, al, b, bl)
    ref = np.asarray(jax_edit(a, al, b, bl))
    pallas = np.asarray(edit_distance_batch_pallas(a, al, b, bl,
                                                   interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert got[0] == S and got[1] == S and got[2] == 0 and got[5] == 0


@pytest.mark.parametrize("B,S", [(21, 16), (12, 64), (7, 300)])
def test_edit_distance_codes_past_3_equal_jnp(B, S):
    """Codes 4, 200 and 255 beside 0-3, which K5's bit-parallel rows
    match on their general path: equal to the JAX package's distances."""
    a, al, b, bl = _pairs(B, S, B + S + 5)
    rng = np.random.default_rng(S)
    codes = np.array([4, 200, 255], np.uint8)
    a = np.where(rng.random(a.shape) < 0.3,
                 codes[rng.integers(0, 3, a.shape)], a).astype(np.uint8)
    b = np.where(rng.random(b.shape) < 0.3,
                 codes[rng.integers(0, 3, b.shape)], b).astype(np.uint8)
    b[5] = a[5]
    got = _torch(a, al, b, bl)
    np.testing.assert_array_equal(got, np.asarray(jax_edit(a, al, b, bl)))
    assert got[5] == 0


def test_edit_distance_equals_jnp_at_1024():
    a, al, b, bl = _pairs(6, 1024, 7)
    np.testing.assert_array_equal(_torch(a, al, b, bl),
                                  np.asarray(jax_edit(a, al, b, bl)))


def test_edit_distance_cpu_launches_no_kernel():
    before = dict(_cuda.LAUNCHES)
    _torch(*_pairs(8, 16, 3))
    assert _cuda.LAUNCHES == before


def _segments(seed, n=120):
    """Segment pairs of every bucket, one longer than the largest (the
    batcher truncates those and charges the length difference)."""
    rng = np.random.default_rng(seed)
    segs = []
    for i in range(n):
        la = int(rng.choice([0, 3, 15, 40, 100, 300, 900]))
        lb = max(0, la + int(rng.integers(-3, 4)))
        a = rng.integers(0, 4, la).astype(np.uint8)
        b = a[:lb].copy() if lb <= la else np.concatenate(
            [a, rng.integers(0, 4, lb - la).astype(np.uint8)])
        flip = rng.random(len(b)) < 0.08
        b[flip] = (b[flip] + 1) % 4
        segs.append((a, b))
    segs.append((rng.integers(0, 4, 1100).astype(np.uint8),
                 rng.integers(0, 4, 1030).astype(np.uint8)))
    return segs


def test_segment_batcher_equals_jax():
    segs = _segments(11)
    jb, tb = JaxBatcher(), SegmentBatcher()
    for a, b in segs:
        assert jb.add(a, b) == tb.add(a, b)
    np.testing.assert_array_equal(tb.run(), jb.run())


@pytest.mark.parametrize("use_hpc", [False, True])
def test_anchored_divergence_equals_jax(use_hpc):
    rng = np.random.default_rng(21 + use_hpc)
    cur = rng.integers(0, 4, 3000).astype(np.uint8)
    ext = cur.copy()
    flip = rng.random(len(ext)) < 0.08
    ext[flip] = (ext[flip] + 1) % 4
    ext = np.insert(ext, [500, 1200, 2500], [1, 2, 3])
    cpos = np.sort(rng.choice(np.arange(1, 2990), 60, replace=False))
    anchors = np.stack([np.concatenate([[0], cpos, [2990]]),
                        np.concatenate([[0], cpos + (cpos > 500)
                                        + (cpos > 1200) + (cpos > 2500),
                                        [2993]])], axis=1)
    ref = jax_anchored(cur, ext, anchors, 17, use_hpc=use_hpc)
    jb, tb = JaxBatcher(), SegmentBatcher()
    fin_j = jax_anchored(cur, ext, anchors, 17, use_hpc=use_hpc,
                         batcher=jb)
    fin_t = anchored_divergence(cur, ext, anchors, 17, use_hpc=use_hpc,
                                batcher=tb)
    got_own = anchored_divergence(cur, ext, anchors, 17, use_hpc=use_hpc)
    for got in (fin_t(tb.run()), got_own):
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    assert fin_j(jb.run())[0] == ref[0]
    assert 0 < ref[0] < 0.5


@pytest.mark.parametrize("use_hpc", [False, True])
@pytest.mark.parametrize("case", ["repeated_anchor", "past_the_end",
                                  "one_segment", "giant_gap"])
def test_anchored_divergence_edges_equal_jax(use_hpc, case):
    """Empty segments (repeated anchors, both sides empty), anchors past
    the sequence end, a lone segment and a gap longer than the largest
    bucket score as in the JAX package, alone and batched together."""
    rng = np.random.default_rng(31)
    cur = rng.integers(0, 4, 2500).astype(np.uint8)
    cur[100:110] = 2                          # homopolymer runs
    ext = np.concatenate([cur[:1200], rng.integers(0, 4, 40),
                          cur[1200:]]).astype(np.uint8)
    anchors = {
        "repeated_anchor": [[0, 0], [50, 50], [50, 50], [50, 52],
                            [300, 302], [300, 302], [900, 900]],
        "past_the_end": [[0, 0], [1000, 1000], [2400, 2440],
                         [2600, 2580]],
        "one_segment": [[5, 5], [700, 700]],
        "giant_gap": [[0, 0], [100, 100], [1300, 1340], [1400, 1440]],
    }[case]
    anchors = np.asarray(anchors)
    ref = jax_anchored(cur, ext, anchors, 17, use_hpc=use_hpc)
    got = anchored_divergence(cur, ext, anchors, 17, use_hpc=use_hpc)
    jb, tb = JaxBatcher(), SegmentBatcher()
    fin_j = [jax_anchored(cur, ext, anchors, 17, use_hpc=use_hpc,
                          batcher=jb) for _ in range(2)]
    fin_t = [anchored_divergence(cur, ext, anchors, 17, use_hpc=use_hpc,
                                 batcher=tb) for _ in range(2)]
    dj, dt = jb.run(), tb.run()
    np.testing.assert_array_equal(dt, dj)
    for out in [got] + [f(dt) for f in fin_t]:
        assert out[0] == ref[0]
        np.testing.assert_array_equal(out[1], ref[1])
        np.testing.assert_array_equal(out[2], ref[2])
