"""flye_tpu_torch's file task bus (`parallel/taskbus.py`), its polish
handler and the ava shard files, against the JAX package's.  The
counterpart of tests/test_taskbus.py: claim exclusivity, coordinator
work stealing, the worker's serve loop, and the polish handler on the
JAX test's packed chunk; plus `dump_shard` / `load_shard`."""

import threading

import numpy as np
import pytest

from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.parallel.taskbus import TaskBus


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _double(payload):
    return {"y": payload["x"] * 2}


def test_coordinator_self_processes(tmp_path):
    """collect() with no workers claims and runs every task itself."""
    bus = TaskBus(str(tmp_path), 0)
    bus.register("dbl", _double)
    for i in range(5):
        bus.submit("dbl", f"t{i}", {"x": np.full(3, i)})
    res = bus.collect("dbl", [f"t{i}" for i in range(5)])
    for i in range(5):
        np.testing.assert_array_equal(res[f"t{i}"]["y"], np.full(3, 2 * i))
    assert bus.stats["submitted"]["dbl"] == 5
    assert bus.stats["collected"]["dbl"] == 5
    assert bus.stats["ran"]["dbl"] == 5


def test_worker_serves_until_done(tmp_path):
    coord = TaskBus(str(tmp_path), 0)
    coord.register("dbl", _double)
    worker = TaskBus(str(tmp_path), 1)
    worker.register("dbl", _double)
    t = threading.Thread(target=worker.serve, kwargs={"poll_s": 0.01})
    t.start()
    try:
        for i in range(8):
            coord.submit("dbl", f"t{i}", {"x": np.full(2, i)})
        res = coord.collect("dbl", [f"t{i}" for i in range(8)])
        assert len(res) == 8
        for i in range(8):
            np.testing.assert_array_equal(res[f"t{i}"]["y"],
                                          np.full(2, 2 * i))
    finally:
        coord.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()
    # every task ran exactly once, on one of the two
    assert coord.stats["ran"]["dbl"] + worker.stats["ran"]["dbl"] == 8


def test_claim_is_exclusive(tmp_path):
    b0 = TaskBus(str(tmp_path), 0)
    b1 = TaskBus(str(tmp_path), 1)
    b0.submit("s", "only", {"x": np.zeros(1)})
    task = b0._pending("s")[0]
    c0 = b0._try_claim(task)
    c1 = b1._try_claim(task)
    assert (c0 is None) != (c1 is None)  # exactly one winner


def test_polish_task_handler_matches_jax():
    """The bus polish handler, worker (native climber) and coordinator
    (the runtime's device path, here the CPU's), on the JAX test's
    packed chunk: equal to `flye_tpu`'s `_polish_task` and to the port's
    `polish_bubbles`, exactly."""
    from flye_tpu.polishing.polisher import _polish_task as jax_task
    from flye_tpu_torch.ops.polish import polish_bubbles
    from flye_tpu_torch.polishing.polisher import _polish_task

    rng = np.random.default_rng(11)
    B, C, Cb, R, S = 6, 20, 28, 5, 40
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        p = rng.integers(0, C, 2)
        cand[i, p] = (cand[i, p] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))

    payload = dict(cand=cand, clen=clen, branches=branches, blen=blen,
                   bmask=bmask.astype(np.uint8), subs=subs,
                   max_iters=np.int32(16))
    ref = jax_task(dict(payload), prefer_native=True)
    direct = polish_bubbles(cand, clen, branches, blen, bmask, subs,
                            max_iters=16)
    assert not np.array_equal(ref["cand"], cand)   # the climb edited
    for prefer_native in (True, False):
        out = _polish_task(dict(payload), prefer_native=prefer_native)
        for key, d in (("cand", direct[0]), ("clen", direct[1])):
            assert out[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(out[key], ref[key])
            np.testing.assert_array_equal(out[key], d)


def _ava_stores():
    """A 12 kb genome at 10x, 3 kb reads: makers of the port's and the
    JAX package's all-vs-all overlap stores as the assembly stage builds
    them, each on its package's solid index."""
    from flye_tpu_torch.index import KmerIndex
    from flye_tpu_torch.io import SequenceStore
    from flye_tpu_torch.overlap import OverlapEngine, OverlapStore
    from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
    genome = random_genome(12000, seed=21)
    reads = simulate_reads(genome, coverage=10, mean_length=3000,
                           min_length=1000, error_rate=0.05, seed=22)
    kw = dict(max_jump=1500, min_overlap=1000, max_overhang=1500,
              keep_alignment=False, only_max_ext=True, max_divergence=1.0)
    ts = SequenceStore()
    for name, codes in reads:
        ts.add(name, codes)
    tidx = KmerIndex.build_solid(ts, 17, select_rate=0.1, tandem_freq=10)

    def port_store():
        return OverlapStore(OverlapEngine(ts, tidx, **kw), ts, packed=True)
    from flye_tpu.index import KmerIndex as JaxIndex
    from flye_tpu.io import SequenceStore as JaxStore
    from flye_tpu.overlap import OverlapEngine as JaxEngine
    from flye_tpu.overlap import OverlapStore as JaxOverlapStore
    js = JaxStore()
    for name, codes in reads:
        js.add(name, codes)
    jidx = JaxIndex.build_solid(js, 17, select_rate=0.1, tandem_freq=10)

    def jax_store():
        return JaxOverlapStore(JaxEngine(js, jidx, **kw), js, packed=True)
    return ts, port_store, jax_store


def _cache(store, ids):
    return {sid: [(o.cur_id, o.ext_id, o.cur_begin, o.cur_end, o.cur_len,
                   o.ext_begin, o.ext_end, o.ext_len, o.score,
                   o.divergence,
                   None if o.kmer_matches is None
                   else np.asarray(o.kmer_matches).tolist())
                  for o in store.lazy_overlaps(sid)] for sid in ids}


def test_ava_shard_exchange(tmp_path):
    """A worker's shard (`dump_shard`) merged into the coordinator's
    partition (`load_shard`) reproduces the single-process overlap
    cache, both strands; the shard file holds the JAX package's keys
    and arrays for the same partition."""
    from flye_tpu_torch.parallel import host_partition
    ts, port_store, jax_store = _ava_stores()
    ids = ts.ids()
    single = port_store()
    single.prefetch(ids)
    ref = _cache(single, ts.ids(both_strands=True))
    assert sum(map(len, ref.values())) > 0

    coord, worker = port_store(), port_store()
    coord.prefetch(host_partition(ids, 0, 2))
    worker.prefetch(host_partition(ids, 1, 2))
    shard = str(tmp_path / "ava_shard_1.npz")
    worker.dump_shard(shard)
    coord.load_shard(shard)

    def computed(*a, **kw):
        raise AssertionError("a read's overlaps were computed, not merged")
    # every read's overlaps now come from the two partitions
    coord.engine.get_overlaps = computed
    assert _cache(coord, ts.ids(both_strands=True)) == ref

    jworker = jax_store()
    jworker.prefetch(host_partition(ids, 1, 2))
    jshard = str(tmp_path / "jax_shard_1.npz")
    jworker.dump_shard(jshard)
    with np.load(shard) as a, np.load(jshard) as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a["cur_id"]) > 0 and a["anchors"].shape[1] == 2
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
