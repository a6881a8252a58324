"""flye_tpu_torch's hash-partitioned multi-process mode
(FLYE_TPU_PARTITIONED=1) on the CPU, against the JAX package.

Two OS processes of the port's CLI on tests/test_partitioned.py's 20 kb
input: each builds and holds only its k-mer hash shard of the index
(count exchange, freq join, per-read selection, posting exchange) and
the all-vs-all probes go through the file bus.  The files must equal
`flye_tpu`'s single-process run byte for byte, and each shard must hold
about half the index.  Three processes (a shard count that is not a
power of two) build the index alone, and its shards must be the
one-process index cut by hash, k-mer for k-mer.  One process on a mesh
of three CPU shards (every index built by the posting exchange) writes
`flye_tpu`'s files too.  The stream helpers are held against the JAX
package's on the same arrays."""

import filecmp
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import flye_tpu.main as jax_main
from flye_tpu.io import SequenceStore as JaxStore
from flye_tpu.parallel import partitioned as JP
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.io.fasta import write_fasta
from flye_tpu_torch.parallel import ParallelContext, set_runtime
from flye_tpu_torch.parallel import partitioned as TP
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process of the port's CLI: the port only (no JAX), one torch thread
_STUB = ("import sys, torch; torch.set_num_threads(1); "
         "from flye_tpu_torch.main import main; sys.exit(main(sys.argv[1:]))")
_SHARD = re.compile(r"partitioned index: shard (\d)/(\d) holds (\d+) "
                    r"k-mers / (\d+) postings")


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _env(rank, world):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               FLYE_TPU_PARTITIONED="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_all(cmds, timeout=300):
    """Start every (argv, env) together; returns their stderr logs, and
    raises unless each exits 0."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in cmds]
    try:
        logs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {rank}:\n{log[-3000:]}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned")
    genome = random_genome(20000, seed=3)
    reads = simulate_reads(genome, coverage=12, mean_length=4000,
                           error_rate=0.05, seed=5, circular=False)
    path = d / "reads.fasta"
    write_fasta(reads, str(path))
    assert jax_main.main(["--pacbio-raw", str(path), "-o", str(d / "jax"),
                          "-g", "20k", "-m", "1500", "--shards", "1"]) == 0
    argv = ["--pacbio-raw", str(path), "-o", str(d / "part"), "-g", "20k",
            "-m", "1500", "--device", "cpu"]
    logs = _run_all([([sys.executable, "-c", _STUB, *argv], _env(r, 2))
                     for r in (0, 1)])
    return d, logs


def test_each_process_holds_a_shard(runs):
    d, logs = runs
    held = []
    for rank, log in enumerate(logs):
        m = _SHARD.search(log)
        assert m, log[-3000:]
        assert (int(m.group(1)), int(m.group(2))) == (rank, 2)
        held.append(int(m.group(3)))
    total = sum(held)
    assert total > 0
    for n in held:
        # a hash split: each shard within [25%, 75%] of the whole
        assert 0.25 * total <= n <= 0.75 * total, held
    # the worker contributed its ava shard, and the streams went
    # through the bus
    assert (d / "part" / "00-assembly" / "ava_shard_1.npz").exists()
    pdir = d / "part" / "00-assembly" / ".partition"
    for name in ("counts_1_0.npz", "gcounts_1.npz", "post_0_1.npz",
                 "ms_1_0_0.npz", "est_1_0.npz", "divergence.json"):
        assert (pdir / name).exists(), name


@pytest.mark.parametrize("rel", ["assembly.fasta",
                                 "00-assembly/draft_assembly.fasta"])
def test_two_processes_match_flye_tpu(runs, rel):
    d = runs[0]
    assert filecmp.cmp(d / "jax" / rel, d / "part" / rel, shallow=False)


# one process of the CLI on a mesh of three shards of the CPU: the
# package has no switch for a mesh of repeated devices, so the stub
# installs one over the runtime the CLI builds
_MESH_STUB = """
import sys, torch
torch.set_num_threads(1)
import flye_tpu_torch.parallel.runtime as R
real = R.init_runtime
def init_runtime(n_shards=None, device="cuda"):
    rt = real(n_shards, device)
    rt.mesh = R.make_mesh_local(3, devices=[rt.device] * 3)
    return rt
R.init_runtime = init_runtime
from flye_tpu_torch.main import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.parametrize("rel", ["assembly.fasta", "assembly_graph.gfa",
                                 "00-assembly/draft_assembly.fasta"])
def test_three_shard_mesh_cli_matches_flye_tpu(runs, rel):
    """The whole pipeline with every index hash-sharded over 3 shards
    and the batched kernels' rows split where they divide: the files
    of `flye_tpu`'s run."""
    d = runs[0]
    out = d / "mesh3"
    if not out.exists():
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        log = _run_all([([sys.executable, "-c", _MESH_STUB,
                          "--pacbio-raw", str(d / "reads.fasta"), "-o",
                          str(out), "-g", "20k", "-m", "1500", "--device",
                          "cpu"], env)])[0]
        assert "Building mesh-sharded solid-kmer index" in log
        assert "Building mesh-sharded minimizer index" in log
    assert filecmp.cmp(d / "jax" / rel, out / rel, shallow=False)


# the start of a run: the worker starts first, beside a prior attempt's
# nonce and echo; both must pass the rendezvous and a barrier after it
_START = """
import sys
from flye_tpu_torch.parallel.distributed import (file_barrier,
                                                 start_rendezvous)
from flye_tpu_torch.parallel.runtime import init_runtime
init_runtime(device="cpu")
start_rendezvous(sys.argv[1], timeout_s=60)
file_barrier(sys.argv[1], "after_start", timeout_s=60)
"""


def test_start_rendezvous_holds_a_worker_until_the_coordinator(tmp_path):
    """A worker started before the coordinator waits for it, whatever a
    prior attempt left: the coordinator's cleanup (here of `.hello`)
    cannot delete what the worker publishes after the rendezvous."""
    hello = tmp_path / ".hello"
    hello.mkdir()
    (hello / "1").write_text("stale")
    (hello / "1.ack").write_text("stale")
    worker = subprocess.Popen([sys.executable, "-c", _START, str(tmp_path)],
                              env=_env(1, 2), stderr=subprocess.PIPE,
                              text=True)
    try:
        with pytest.raises(subprocess.TimeoutExpired):
            worker.wait(timeout=8)      # held, not let go by the stale echo
        logs = _run_all([([sys.executable, "-c", _START, str(tmp_path)],
                          _env(0, 2))], timeout=60)
        assert worker.wait(timeout=60) == 0, worker.stderr.read()[-3000:]
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    assert "Traceback" not in logs[0]
    assert (tmp_path / ".barriers" / "after_start.1").exists()


# three processes build the index only, each saving its shard
_BUILD = """
import sys, numpy as np, torch
torch.set_num_threads(1)
from flye_tpu_torch.config import Config
from flye_tpu_torch.io import SequenceStore
from flye_tpu_torch.parallel.partitioned import build_partitioned_index
from flye_tpu_torch.parallel.runtime import init_runtime
from flye_tpu_torch.utils.simulate import random_genome, simulate_reads
read_type, out = sys.argv[1], sys.argv[2]
rt = init_runtime(device="cpu")
store = SequenceStore()
for name, codes in simulate_reads(random_genome(6000, seed=21), coverage=10,
                                  mean_length=2000, error_rate=0.05,
                                  seed=22, circular=False):
    store.add(name, codes)
idx = build_partitioned_index(store, Config(read_type), out, rt)
np.savez(f"{out}/idx_{rt.process_index}.npz",
         **{n: np.asarray(getattr(idx, n)) for n in idx.FIELDS})
"""


@pytest.mark.parametrize("read_type", ["raw", "hifi"])
def test_three_process_index_is_the_full_index_by_hash(tmp_path,
                                                       read_type):
    """raw: solid k-mers (the count exchange and freq join); hifi:
    minimizers.  Each shard holds exactly the one-process index's rows
    of its hash class, with the same postings, counts and flags, and
    the global repetitive cutoff and sample rate."""
    from flye_tpu_torch.assemble.driver import build_read_index
    from flye_tpu_torch.config import Config
    from flye_tpu_torch.index.sharded import ShardedKmerIndex

    _run_all([([sys.executable, "-c", _BUILD, read_type, str(tmp_path)],
               _env(r, 3)) for r in range(3)])
    store = SequenceStore()
    for name, codes in simulate_reads(random_genome(6000, seed=21),
                                      coverage=10, mean_length=2000,
                                      error_rate=0.05, seed=22,
                                      circular=False):
        store.add(name, codes)
    full = build_read_index(store, Config(read_type))
    assert full.num_kmers > 0
    owner = ShardedKmerIndex.shard_of(full.uniq_kmers, 3)
    seen = 0
    for s in range(3):
        z = np.load(tmp_path / f"idx_{s}.npz")
        rows = np.flatnonzero(owner == s)
        np.testing.assert_array_equal(z["uniq_kmers"],
                                      full.uniq_kmers[rows])
        np.testing.assert_array_equal(z["counts"], full.counts[rows])
        np.testing.assert_array_equal(z["repetitive"],
                                      full.repetitive[rows])
        post = np.concatenate([np.arange(full.offsets[r],
                                         full.offsets[r + 1])
                               for r in rows]).astype(np.int64)
        for name in ("post_seq", "post_pos", "post_flip"):
            np.testing.assert_array_equal(z[name],
                                          getattr(full, name)[post])
        assert float(z["repetitive_cutoff"]) == full.repetitive_cutoff
        assert float(z["sample_rate"]) == full.sample_rate
        assert 0 < len(rows) < full.num_kmers
        seen += len(rows)
    assert seen == full.num_kmers


@pytest.fixture(scope="module")
def small_stores():
    reads = simulate_reads(random_genome(12000, seed=13), coverage=8,
                           mean_length=2500, error_rate=0.05, seed=14)
    js, ts = JaxStore(), SequenceStore()
    for name, codes in reads:
        js.add(name, codes)
        ts.add(name, codes)
    return js, ts


def test_prefetch_groups_match_jax(small_stores):
    js, ts = small_stores
    for rows, bases in ((1024, 8 << 20), (5, 8 << 20), (64, 9000)):
        ref = JP._prefetch_groups(js, js.ids(), rows, bases)
        out = TP._prefetch_groups(ts, ts.ids(), rows, bases)
        assert out == ref
        assert len(ref) > 1 or rows == 1024


def test_owner_of_matches_jax(small_stores):
    _, ts = small_stores
    fwd = sorted({i & ~1 for i in ts.ids()})
    order = {f: n for n, f in enumerate(fwd)}
    ids = np.asarray(fwd[::-1] + fwd[:3], np.int64)
    for count in (2, 3, 5):
        ref = JP._owner_of(ids, order, count)
        out = TP._owner_of(ids, order, count)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


def _streams(rng, nq):
    """Random per-query match streams in _match_streams' layout, some
    queries empty."""
    mlens = rng.integers(0, 30, nq) * (rng.random(nq) < 0.8)
    flens = rng.integers(0, 6, nq) * (rng.random(nq) < 0.5)
    qb = np.concatenate([[0], np.cumsum(mlens)]).astype(np.int64)
    foff = np.concatenate([[0], np.cumsum(flens)]).astype(np.int64)
    n, f = int(qb[-1]), int(foff[-1])
    qpos = np.concatenate([np.sort(rng.integers(0, 5000, m))
                           for m in mlens]).astype(np.int32)
    return (qpos, rng.integers(0, 400, n).astype(np.int64),
            rng.integers(0, 5000, n).astype(np.int32), qb,
            rng.integers(0, 5000, f).astype(np.int64), foff)


def _assert_same_dict(ref, out):
    assert sorted(ref) == sorted(out)
    for key in ref:
        for name in ref[key]:
            a, b = ref[key][name], out[key][name]
            assert a.dtype == b.dtype, (key, name)
            np.testing.assert_array_equal(b, a, err_msg=f"{key} {name}")


def test_split_and_merge_streams_match_jax():
    rng = np.random.default_rng(3)
    nq, P = 40, 3
    owners = rng.integers(0, P, nq).astype(np.int64)
    # every shard's streams for the same queries, split by owner
    splits = []
    for _ in range(P):
        streams = _streams(rng, nq)
        ref = JP._split_streams(streams, owners)
        out = TP._split_streams(streams, owners)
        _assert_same_dict(ref, out)
        splits.append(out)
    for o in range(P):
        parts = [sp[o] for sp in splits if o in sp]
        n_query = int((owners == o).sum())
        ref = JP._merge_streams(parts, n_query)
        out = TP._merge_streams(parts, n_query)
        for a, b in zip(ref, out):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        # each query's merged matches ascend in query position
        qpos, qb = out[0], out[3]
        for q in range(n_query):
            assert np.all(np.diff(qpos[qb[q]:qb[q + 1]]) >= 0)
