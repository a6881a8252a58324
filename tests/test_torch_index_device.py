"""flye_tpu_torch's device index paths against the JAX package's.

The flat-stream probe (`stream_probe_packed`, `probe_stream_flat`), the
padded-batch probe (`probe_batch`, `lookup`), the device solid-k-mer
selection (`solid_select_device`, `build_solid(device_select=True)`)
and the engine's FLYE_TPU_PROBE switch, on the CPU.  Every comparison
is exact; uint64 words are compared as their int64 bit patterns."""

import logging

import numpy as np
import pytest
import torch

from flye_tpu.index import KmerIndex as JaxIndex
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.ops.kmers import canonical_kmers as jax_canonical
from flye_tpu.ops.kmers import extract_kmers as jax_extract
from flye_tpu.ops.kmers import solid_select_device as jax_solid_select
from flye_tpu.ops.kmers import stream_probe_packed as jax_probe
from flye_tpu.overlap import OverlapEngine as JaxEngine
from flye_tpu_torch.index import KmerIndex
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.ops.kmers import (canonical_kmers, extract_kmers,
                                      solid_select_device,
                                      stream_probe_packed,
                                      stream_select_packed)
from flye_tpu_torch.overlap import OverlapEngine
from flye_tpu_torch.utils.simulate import random_genome
from test_torch_kmers import (_assert_same_index, _stream_chunks,
                              cpu_runtime, read_sets)
from test_torch_overlap import _as_tuples, stores

_INT64_MAX = np.iinfo(np.int64).max


def _table(stream, k, rng):
    """A sorted k-mer table holding about half of the stream's canonical
    k-mers and as many absent ones, padded to a power of two with
    max-int64 as the index pads it, and random repetitive flags."""
    canon, _, valid = jax_canonical(stream[None], np.asarray([len(stream)]),
                                    k)
    present = np.unique(np.asarray(canon)[np.asarray(valid)])
    present = present[rng.random(len(present)) < 0.5]
    absent = rng.integers(0, 1 << (2 * k), len(present), dtype=np.int64)
    uniq = np.unique(np.concatenate([present, absent]))
    Up = 1 << max(10, (len(uniq) - 1).bit_length())
    up = np.full(Up, _INT64_MAX, np.int64)
    up[:len(uniq)] = uniq
    rp = np.zeros(Up, bool)
    rp[:len(uniq)] = rng.random(len(uniq)) < 0.2
    return up, rp, len(uniq) - 1


@pytest.mark.parametrize("k", [9, 17])
def test_padded_kmers_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (5, 64)).astype(np.uint8)
    lens = np.asarray([64, 0, k - 1, k, 40], np.int32)
    for ref, out in zip(jax_extract(codes, lens, k),
                        extract_kmers(torch.from_numpy(codes),
                                      torch.from_numpy(lens), k)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for ref, out in zip(jax_canonical(codes, lens, k),
                        canonical_kmers(torch.from_numpy(codes),
                                        torch.from_numpy(lens), k)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("k", [9, 17])
def test_stream_probe_packed_matches_jax(k, narrow):
    W = 256
    # reads shorter than k, empty reads and reads across rows
    lens = np.array([700, k - 1, 0, k, 1100, 3, 431, 0], np.int64)
    chunks, starts, n_total, step = _stream_chunks(lens, k, 1, W,
                                                   seed=k + narrow)
    stream = np.concatenate([chunks[:, :step].ravel(), chunks[-1, step:]])
    up, rp, rmax = _table(stream[:n_total], k, np.random.default_rng(k))
    saw = 0
    for r0 in (0, 3, 7):
        rows = chunks[r0:r0 + 4]
        ref = np.asarray(jax_probe(rows, starts, np.int64(r0),
                                   np.int64(n_total), up, rp,
                                   np.int64(rmax), k=k, step=step,
                                   narrow=narrow))
        out = stream_probe_packed(
            torch.from_numpy(rows), torch.from_numpy(starts), r0, n_total,
            torch.from_numpy(up), torch.from_numpy(rp), rmax, k=k,
            step=step, narrow=narrow).numpy()
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
        shift = 28 if narrow else 32
        saw |= int(np.bitwise_or.reduce((ref >> shift).ravel() & 3))
    assert saw == 3   # hits and repetitive k-mers both occur


@pytest.mark.parametrize("k,rate,tandem,sample",
                         [(13, 0.5, 10, 1), (9, 1.0, 5, 1),
                          (17, 0.4, 100, 2)])
def test_solid_select_device_matches_jax(read_sets, k, rate, tandem,
                                         sample):
    _, ts = read_sets
    W = 256
    lens = ts.lengths
    chunks, starts, n_total, step = _stream_chunks(lens, k, 1, W, seed=0)
    # the reads' own bases in place of the helper's random stream, so
    # that k-mers recur across reads
    reads = np.concatenate([ts.get(s) for s in ts.ids()])
    pad = np.zeros(len(chunks) * step + (W - step), np.uint8)
    pad[:n_total] = reads
    chunks = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        pad, shape=(len(chunks), W), strides=(step, 1)))
    packed = stream_select_packed(
        torch.from_numpy(chunks), torch.from_numpy(starts), 0, n_total,
        k=k, w=1, sample=sample, step=step).reshape(-1)
    idx90 = KmerIndex._p90_ranks(lens, k, sample, len(starts))
    pk, pg, n = solid_select_device(
        packed, torch.from_numpy(starts), torch.from_numpy(idx90), rate,
        k=k, W=W, step=step, tandem_freq=tandem, global_min=2)
    rpk, rpg, rn = jax_solid_select(
        packed.numpy().view(np.uint64), starts, idx90, np.float32(rate),
        k=k, W=W, step=step, sample=sample, tandem_freq=tandem,
        global_min=2)
    rn = int(rn)
    assert 0 < n == rn < int((packed & 1).sum())
    np.testing.assert_array_equal(pk.numpy(),
                                  np.asarray(rpk)[:rn].view(np.int64))
    np.testing.assert_array_equal(pg.numpy(),
                                  np.asarray(rpg)[:rn].astype(np.int64))


def _perturbed_store(store_cls):
    """tests/test_index.py's store for the device selection: 12 copies
    of a 600 bp genome with 8 substitutions each."""
    genome = random_genome(600, seed=11)
    store = store_cls()
    local = np.random.default_rng(7)
    for i in range(12):
        mut = genome.copy()
        flips = local.integers(0, len(mut), size=8)
        mut[flips] = (mut[flips] + local.integers(1, 4, size=8)) % 4
        store.add(f"r{i}", mut)
    return store


@pytest.mark.parametrize("case", ["perturbed-13", "perturbed-9", "reads-17"])
def test_build_solid_device_select_matches(read_sets, case):
    if case == "reads-17":
        js, ts = read_sets
        k, kw = 17, dict(select_rate=0.1, tandem_freq=10)
    else:
        js, ts = _perturbed_store(JaxStore), _perturbed_store(SequenceStore)
        k, kw = ((13, dict(select_rate=0.5, tandem_freq=10))
                 if case == "perturbed-13"
                 else (9, dict(select_rate=1.0, tandem_freq=5)))
    ref = JaxIndex.build_solid(js, k, global_min_freq=2, **kw)
    host = KmerIndex.build_solid(ts, k, global_min_freq=2,
                                 device_select=False, **kw)
    dev = KmerIndex.build_solid(ts, k, global_min_freq=2,
                                device_select=True, **kw)
    assert ref.num_kmers > 0
    _assert_same_index(ref, dev)
    _assert_same_index(host, dev)


def test_build_solid_device_select_without_kmers():
    """Reads all shorter than k: nothing is selected, and the index is
    the JAX device path's (its sample_rate is the total length)."""
    js, ts = JaxStore(), SequenceStore()
    for i, ln in enumerate((5, 12, 0, 16)):
        codes = np.full(ln, i % 4, np.uint8)
        js.add(f"r{i}", codes)
        ts.add(f"r{i}", codes)
    ref = JaxIndex.build_solid(js, 17, select_rate=0.5, tandem_freq=10,
                               device_select=True)
    dev = KmerIndex.build_solid(ts, 17, select_rate=0.5, tandem_freq=10,
                                device_select=True)
    assert dev.num_kmers == 0 and dev.sample_rate == 33.0
    _assert_same_index(ref, dev)


@pytest.fixture(scope="module")
def probe_indexes(read_sets):
    js, ts = read_sets
    # a low repeat cutoff, so that some probed k-mers are repetitive
    jidx = JaxIndex.build_solid(js, 17, select_rate=0.1, tandem_freq=10,
                                global_min_freq=2, repeat_kmer_rate=1.5)
    assert jidx.repetitive.any()
    tidx = KmerIndex.from_numpy(
        ts, 17, {n: getattr(jidx, n) for n in KmerIndex.FIELDS})
    return jidx, tidx


def test_probe_stream_flat_matches_host_and_jax(read_sets, probe_indexes):
    js, ts = read_sets
    jidx, tidx = probe_indexes
    sids = ts.ids(both_strands=True)[:40]
    flat = tidx.probe_stream_flat(ts, sids)
    host = tidx.probe_stream_host(ts, sids)
    ref = jidx.probe_stream_flat(js, sids)
    assert len(flat[0]) > 1000 and len(flat[3]) > 0
    for name, a, b, c in zip(("g_hit", "row_hit", "fwd_hit", "g_rep",
                              "starts"), flat, host, ref):
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)
    assert flat[5] == host[5] == ref[5]


def test_probe_stream_flat_short_and_empty_reads(read_sets, probe_indexes):
    _, ts = read_sets
    _, tidx = probe_indexes
    g = ts.get(ts.ids()[0])
    qs = SequenceStore()
    for name, codes in (("a", g[100:2100]), ("empty", g[:0]),
                        ("short", g[:5]), ("b", g[500:1800]),
                        ("k", g[:17])):
        qs.add(name, codes)
    sids = qs.ids(both_strands=True)
    flat = tidx.probe_stream_flat(qs, sids)
    host = tidx.probe_stream_host(qs, sids)
    for a, b in zip(flat[:5], host[:5]):
        np.testing.assert_array_equal(a, b)
    assert flat[5] == host[5]
    empty = tidx.probe_stream_flat(qs, [qs.id_by_name("empty")])
    assert len(empty[0]) == len(empty[3]) == 0


def test_probe_batch_and_lookup_match_jax(read_sets, probe_indexes):
    js, ts = read_sets
    jidx, tidx = probe_indexes
    sids = ts.ids(both_strands=True)[:6]
    pad = 1 << (max(ts.length(s) for s in sids) - 1).bit_length()
    batch = np.zeros((len(sids) + 1, pad), np.uint8)
    lens = np.zeros(len(sids) + 1, np.int32)    # the last row is empty
    for i, s in enumerate(sids):
        batch[i, :ts.length(s)] = ts.get(s)
        lens[i] = ts.length(s)
    ref = jidx.probe_batch(batch, lens)
    out = tidx.probe_batch(batch, lens)
    assert ref[1].any() and ref[2].any()
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    uniq = np.asarray(jidx.uniq_kmers)
    rng = np.random.default_rng(3)
    q = np.concatenate([uniq[rng.integers(0, len(uniq), 300)],
                        uniq[np.flatnonzero(jidx.repetitive)][:20],
                        rng.integers(0, 1 << 34, 300), [-12345, 0,
                                                        uniq[-1] + 1]])
    for a, b in zip(tidx.lookup(q), jidx.lookup(q)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tidx.kmer_freq(q), jidx.kmer_freq(q))
    np.testing.assert_array_equal(tidx.is_repetitive(q),
                                  jidx.is_repetitive(q))
    assert tidx.is_repetitive(q).any()
    assert len(tidx.lookup(q[:0])[0]) == 0


_ENGINE_KW = dict(max_jump=1500, min_overlap=1000, max_overhang=1500,
                  only_max_ext=True)


@pytest.fixture(scope="module")
def engine_ref(stores):
    """The JAX engine's assembly-mode overlaps of 60 reads (host probe)
    and its index's fields."""
    js, _ = stores
    jidx = JaxIndex.build_solid(js, 17, select_rate=0.1, tandem_freq=10,
                                global_min_freq=2)
    sids = js.ids()[:60]
    ref = _as_tuples(JaxEngine(js, jidx, **_ENGINE_KW)
                     .get_overlaps_batch(js, sids))
    assert sum(len(v) for v in ref.values()) > 50
    return {n: getattr(jidx, n) for n in KmerIndex.FIELDS}, sids, ref


def _engine(stores, engine_ref, probe_env, monkeypatch):
    _, ts = stores
    fields, sids, ref = engine_ref
    monkeypatch.setenv("FLYE_TPU_PROBE", probe_env)
    teng = OverlapEngine(ts, KmerIndex.from_numpy(ts, 17, fields),
                         **_ENGINE_KW)
    return teng, ts, sids, ref


def test_engine_device_probe_never_calls_host(stores, engine_ref,
                                              monkeypatch):
    """FLYE_TPU_PROBE=device: the overlaps equal the JAX engine's, and
    the host probe is never called (it raises here)."""
    teng, ts, sids, ref = _engine(stores, engine_ref, "device",
                                  monkeypatch)
    calls = []
    flat = KmerIndex.probe_stream_flat

    def counted(self, *a):
        calls.append(1)
        return flat(self, *a)

    def host_raises(self, *a):
        raise AssertionError("the host probe was called")

    monkeypatch.setattr(KmerIndex, "probe_stream_flat", counted)
    monkeypatch.setattr(KmerIndex, "probe_stream_host", host_raises)
    out = _as_tuples(teng.get_overlaps_batch(ts, sids))
    assert out == ref
    assert calls and teng._probe_path == "device"


def test_index_without_host_probe_takes_the_device(stores, engine_ref,
                                                   monkeypatch):
    """An index that may not be probed on the host (`host_probe_ok`
    False, as the JAX package's sharded index) is probed on the device
    under the default switch, through `_remap_rows`."""
    teng, ts, sids, ref = _engine(stores, engine_ref, "host", monkeypatch)
    teng.index.host_probe_ok = False
    remapped = []
    teng.index._remap_rows = lambda row: remapped.append(len(row)) or row
    assert teng.index.probe_stream_host(ts, sids) is None
    out = _as_tuples(teng.get_overlaps_batch(ts, sids))
    assert out == ref
    assert remapped and teng._probe_path == "host"


def test_engine_auto_probe_matches_jax(stores, engine_ref, monkeypatch,
                                       caplog):
    teng, ts, sids, ref = _engine(stores, engine_ref, "auto", monkeypatch)
    with caplog.at_level(logging.INFO, logger="flye_tpu_torch"):
        out = _as_tuples(teng.get_overlaps_batch(ts, sids))
    assert out == ref
    assert teng._probe_path in ("host", "device")
    assert any("probe path auto-tune: host" in r.getMessage()
               for r in caplog.records)
    # latched: the next batch takes the chosen path without timing
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="flye_tpu_torch"):
        again = _as_tuples(teng.get_overlaps_batch(ts, sids[:10]))
    assert again == {s: ref[s] for s in sids[:10]}
    assert not any("auto-tune" in r.getMessage() for r in caplog.records)


def test_defaults_stay_on_the_host(stores, monkeypatch):
    """No switch set: the engine probes on the host and build_solid
    counts on the host (the device paths raise here)."""
    js, ts = stores
    monkeypatch.delenv("FLYE_TPU_PROBE", raising=False)
    monkeypatch.delenv("FLYE_TPU_DEVICE_COUNT", raising=False)

    def device_raises(self, *a):
        raise AssertionError("a device path was taken")

    monkeypatch.setattr(KmerIndex, "_solid_select_device", device_raises)
    monkeypatch.setattr(KmerIndex, "probe_stream_flat", device_raises)
    tidx = KmerIndex.build_solid(ts, 17, select_rate=0.1, tandem_freq=10)
    teng = OverlapEngine(ts, tidx, max_jump=1500, min_overlap=1000,
                         max_overhang=1500, only_max_ext=True)
    assert sum(map(len, teng.get_overlaps_batch(ts, ts.ids()[:20])
                   .values())) > 0
    assert teng._probe_path == "host"


def test_device_select_failure_raises(monkeypatch, caplog):
    """A failing device selection, asked for by argument or by
    FLYE_TPU_DEVICE_COUNT=1, is logged and the index is counted on the
    host, as in the JAX package: bit-equal to the host-built one."""
    ts = _perturbed_store(SequenceStore)
    kw = dict(select_rate=0.5, tandem_freq=10)
    host = KmerIndex.build_solid(ts, 13, device_select=False, **kw)

    def fails(*a, **kw):
        raise RuntimeError("device selection failed")

    import flye_tpu_torch.ops.kmers as TK
    monkeypatch.setattr(TK, "solid_select_device", fails)
    for env in (None, "1"):
        caplog.clear()
        if env is None:
            idx = KmerIndex.build_solid(ts, 13, device_select=True, **kw)
        else:
            monkeypatch.setenv("FLYE_TPU_DEVICE_COUNT", env)
            idx = KmerIndex.build_solid(ts, 13, **kw)
        assert any("device solid-kmer selection failed (device selection "
                   "failed); falling back to host counting" in r.getMessage()
                   and r.levelno == logging.WARNING
                   for r in caplog.records)
        assert host.num_kmers > 0
        _assert_same_index(host, idx)


@pytest.mark.parametrize("msg, falls_back", [
    ("CUDA out of memory. Tried to allocate 20.00 GiB", True),
    ("CUDA error: out of memory", True),
    ("CUDA error: an illegal memory access was encountered", False),
    ("CUDA error: unspecified launch failure", False)])
def test_device_select_broken_context_raises(monkeypatch, caplog, msg,
                                             falls_back):
    """Running out of the card's memory falls back to host counting; a
    CUDA error that leaves the context broken is raised, not logged."""
    ts = _perturbed_store(SequenceStore)
    kw = dict(select_rate=0.5, tandem_freq=10)

    def fails(*a, **kw):
        raise RuntimeError(msg)

    import flye_tpu_torch.ops.kmers as TK
    monkeypatch.setattr(TK, "solid_select_device", fails)
    if falls_back:
        idx = KmerIndex.build_solid(ts, 13, device_select=True, **kw)
        _assert_same_index(KmerIndex.build_solid(ts, 13, device_select=False,
                                                 **kw), idx)
        assert any("falling back to host counting" in r.getMessage()
                   for r in caplog.records)
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            KmerIndex.build_solid(ts, 13, device_select=True, **kw)


@pytest.mark.parametrize("k", [17, 31])
def test_solid_sort_fallback_matches_jax_radix(monkeypatch, read_sets, k):
    """Past RADIX_COUNT_MAX k-mers, where the flat 4^k table does not
    apply (k = 31; k = 17 below 150 M k-mers), the host selection counts
    by a stable argsort: with the cut lowered, the frequencies equal
    `flye_tpu`'s native radix counter's on the same stream and the index
    equals `flye_tpu`'s."""
    import flye_tpu.native as jax_native
    import flye_tpu_torch.index.kmer_index as TKI
    js, ts = read_sets
    kw = dict(select_rate=0.1, tandem_freq=10, global_min_freq=2)
    ref = JaxIndex.build_solid(js, k, **kw)
    seen = {}
    select = KmerIndex._select_with_freq

    def spy(self, kmers, seq, pos, flip, freq, *a):
        seen["kmers"], seen["freq"] = kmers, freq
        return select(self, kmers, seq, pos, flip, freq, *a)

    monkeypatch.setattr(KmerIndex, "_select_with_freq", spy)
    monkeypatch.setattr(TKI, "RADIX_COUNT_MAX", 1)
    out = KmerIndex.build_solid(ts, k, device_select=False, **kw)
    assert seen["freq"].dtype == np.int64   # the argsort branch's counts
    radix = np.frombuffer(jax_native.get().count_kmer_freqs_radix(
        np.ascontiguousarray(seen["kmers"], np.int64), k), np.int32)
    assert radix.max() > 1
    np.testing.assert_array_equal(seen["freq"], radix)
    assert ref.num_kmers > 0
    _assert_same_index(ref, out)
