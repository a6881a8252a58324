"""Trestle (`--trestle`) ported: `flye_tpu_torch.trestle` against
`flye_tpu.trestle` on the JAX package's own test inputs, with a
tolerance of 0 — equal arrays, equal pairings, equal graph bytes.

Each graph fixture is built once per package from a namespace of that
package's classes, so the same numbers reach both.  On the CPU the port
polishes with its native climber and scores with K5's plain version,
which equal the JAX CPU path bit for bit."""

import types

import numpy as np
import pytest

import flye_tpu.trestle.divergence as jdiv
import flye_tpu.trestle.trestle as jtr
import flye_tpu_torch.trestle.divergence as tdiv
import flye_tpu_torch.trestle.trestle as ttr
from flye_tpu.io import SequenceStore as JStore
from flye_tpu.overlap.structs import Overlap as JOverlap
from flye_tpu.repeat import graph as jgraph
from flye_tpu.repeat.processing import UnbranchingPath as JPath
from flye_tpu.repeat.read_aligner import EdgeAlignment as JAln
from flye_tpu_torch.io import SequenceStore as TStore
from flye_tpu_torch.overlap.structs import Overlap as TOverlap
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime
from flye_tpu_torch.repeat import graph as tgraph
from flye_tpu_torch.repeat.processing import UnbranchingPath as TPath
from flye_tpu_torch.repeat.read_aligner import EdgeAlignment as TAln
from flye_tpu_torch.utils.simulate import random_genome
from torch_threads import one_torch_thread  # noqa: F401

JAX = types.SimpleNamespace(
    SequenceStore=JStore, Overlap=JOverlap, EdgeSequence=jgraph.EdgeSequence,
    GraphEdge=jgraph.GraphEdge, RepeatGraph=jgraph.RepeatGraph,
    EdgeAlignment=JAln, UnbranchingPath=JPath, trestle=jtr, div=jdiv)
TORCH = types.SimpleNamespace(
    SequenceStore=TStore, Overlap=TOverlap, EdgeSequence=tgraph.EdgeSequence,
    GraphEdge=tgraph.GraphEdge, RepeatGraph=tgraph.RepeatGraph,
    EdgeAlignment=TAln, UnbranchingPath=TPath, trestle=ttr, div=tdiv)

L = 1500


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _noisy(seq, er, seed):
    """tests/test_trestle_divergence.py's read-error model."""
    r = np.random.default_rng(seed)
    out = []
    for c in seq:
        x = r.random()
        if x < er * 0.4:
            out.append((c + r.integers(1, 4)) % 4)
        elif x < er * 0.7:
            pass
        else:
            out.append(c)
            if x > 1 - er * 0.3:
                out.append(r.integers(0, 4))
    return np.asarray(out, np.uint8)


# ------------------------------------------------------- divergence.py

def test_banded_ops_equal():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, 500).astype(np.uint8)
    b = np.concatenate([a[:100], a[120:]])
    for x, y in ((a, a), (a, b), (b, a)):
        ref = jdiv.banded_ops(x, y)
        got = tdiv.banded_ops(x, y)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_banded_ops_without_native_aligner_raises(monkeypatch):
    """The port has no NumPy fallback: a native module lacking
    `banded_align` raises."""
    from flye_tpu_torch import native
    monkeypatch.setattr(native, "get", lambda: types.SimpleNamespace())
    a = np.zeros(10, np.uint8)
    with pytest.raises(RuntimeError, match="banded_align"):
        tdiv.banded_ops(a, a)


def _divergence_outputs(div, template, segs, side_seqs):
    pile = div.pileup_profile(template, segs)
    pos = div.call_divergent_positions(template, pile)
    sigs = div.position_signatures(pile, pos["total"])
    side = {s: div.consensus_signature(template, seq, pos["total"])
            for s, seq in enumerate(side_seqs)}
    labels = div.classify_by_positions(sigs, side)
    return pile, pos, sigs, side, labels


def _two_copies():
    template = random_genome(2500, seed=1)
    copy_b = template.copy()
    for p in (400, 1100, 1900):
        copy_b[p] = (copy_b[p] + 1) % 4
    segs = [(_noisy(template, 0.05, i), 0) for i in range(10)]
    segs += [(_noisy(copy_b, 0.05, 100 + i), 0) for i in range(10)]
    return template, segs, (template, copy_b)


def _identical():
    template = random_genome(2000, seed=2)
    return template, [(template.copy(), 0) for _ in range(12)], (template,)


@pytest.mark.parametrize("case", [_two_copies, _identical],
                         ids=["two_copies", "identical"])
def test_divergence_functions_equal(case):
    """pileup_profile, call_divergent_positions, position_signatures,
    consensus_signature and classify_by_positions on the inputs of
    tests/test_trestle_divergence.py."""
    template, segs, sides = case()
    ref = _divergence_outputs(jdiv, template, segs, sides)
    got = _divergence_outputs(tdiv, template, segs, sides)
    for field in ("matches", "insertions", "read_base"):
        np.testing.assert_array_equal(getattr(got[0], field),
                                      getattr(ref[0], field))
    assert sorted(got[1]) == sorted(ref[1])
    for key in ref[1]:
        np.testing.assert_array_equal(got[1][key], ref[1][key])
    np.testing.assert_array_equal(got[2], ref[2])
    assert sorted(got[3]) == sorted(ref[3])
    for s in ref[3]:
        np.testing.assert_array_equal(got[3][s], ref[3][s])
    assert got[4] == ref[4]
    if case is _identical:
        assert len(got[1]["total"]) == 0


def test_thresholds_and_config_equal():
    assert (tdiv.SUB_THRESH, tdiv.DEL_THRESH, tdiv.INS_THRESH) == (
        jdiv.SUB_THRESH, jdiv.DEL_THRESH, jdiv.INS_THRESH)
    assert ttr.CONFIG == jtr.CONFIG


# ------------------------------------------ tests/test_trestle.py graph

class FakeAligner:
    def __init__(self, alignments):
        self.alignments = alignments


def build_repeat_graph(ns):
    """inA/inB -> repeat (mult 2) -> outX/outY, plus complements."""
    store = ns.SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = ns.RepeatGraph(store)
    nL = g.add_node()
    nR = g.add_node()

    def mk(eid, a, b, cov, rep=False, length=(0, 5000)):
        e = ns.GraphEdge(a, b, eid)
        e.seq_segments.append(ns.EdgeSequence(0, 60000, *length))
        e.mean_coverage = cov
        e.repetitive = rep
        g.add_edge(e)
        return e

    in_a = mk(0, g.add_node(), nL, 20)
    mk(1, g.add_node(), g.add_node(), 20)
    in_b = mk(2, g.add_node(), nL, 20)
    mk(3, g.add_node(), g.add_node(), 20)
    repeat = mk(4, nL, nR, 40, rep=True, length=(10000, 14000))
    mk(5, g.add_node(), g.add_node(), 40, rep=True, length=(10000, 14000))
    out_x = mk(6, nR, g.add_node(), 20)
    mk(7, g.add_node(), g.add_node(), 20)
    out_y = mk(8, nR, g.add_node(), 20)
    mk(9, g.add_node(), g.add_node(), 20)
    return g, in_a, in_b, repeat, out_x, out_y


def make_chain(ns, edges_seq, read_id=0):
    chain = []
    for i, e in enumerate(edges_seq):
        ov = ns.Overlap(read_id, 100 + e.edge_id, i * 1000, (i + 1) * 1000,
                        10000, 0, 1000, 4000, score=500)
        chain.append(ns.EdgeAlignment(ov, e))
    return chain


def _spanning(ns, g, in_a, in_b, repeat, out_x, out_y):
    chains = []
    for i in range(6):
        chains.append(make_chain(ns, [in_a, repeat, out_x], read_id=2 * i))
        chains.append(make_chain(ns, [in_b, repeat, out_y], read_id=2 * i))
    chains.append(make_chain(ns, [in_a, repeat, out_y]))
    return chains


def _insufficient(ns, g, in_a, in_b, repeat, out_x, out_y):
    return [make_chain(ns, [in_a, repeat, out_x])] * 2


def test_get_simple_repeats_equal():
    out = {}
    for key, ns in (("jax", JAX), ("torch", TORCH)):
        g = build_repeat_graph(ns)[0]
        out[key] = [([e.edge_id for e in r.path.path],
                     [e.edge_id for e in r.in_edges],
                     [e.edge_id for e in r.out_edges])
                    for r in ns.trestle.get_simple_repeats(g, 20)]
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == 1


@pytest.mark.parametrize("chains", [_spanning, _insufficient],
                         ids=["spanning_votes", "insufficient_votes"])
def test_resolve_unbridged_repeats_equal(tmp_path, chains):
    """The count resolved and the graph dump after the edit, byte for
    byte (the bridges, their complements and the resolved flags)."""
    out = {}
    for key, ns in (("jax", JAX), ("torch", TORCH)):
        g, *edges = build_repeat_graph(ns)
        n = ns.trestle.resolve_unbridged_repeats(
            g, g.asm, FakeAligner(chains(ns, g, *edges)), mean_coverage=20)
        g.store(str(tmp_path / key))
        out[key] = (n, (tmp_path / key).read_bytes(), len(g.edges))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (1 if chains is _spanning else 0)


# ------------------- tests/test_trestle_divergence.py / _iterative.py

def _mk_edge(ns, g, nl, nr, eid, end=L, cov=30):
    e = ns.GraphEdge(nl, nr, eid)
    e.seq_segments.append(ns.EdgeSequence(0, 60000, 0, end))
    e.mean_coverage = cov
    g.add_edge(e)
    return e


def build_case(ns, copy_a, copy_b, noise=0.0, entry_hi=900, exit_lo=700,
               n_nodes=12):
    """`_build_case` of tests/test_trestle_divergence.py (n_nodes=14:
    the graph of tests/test_trestle_iterative.py); entry_hi / exit_lo
    widen the entrance reads to [0, entry_hi) and the exit reads to
    [exit_lo, L).  Returns (graph, reads, repeat, chains_by_edge)."""
    store = ns.SequenceStore()
    pad = np.zeros(60000, np.uint8)
    pad[:L] = copy_b
    store.add("asm", pad)
    g = ns.RepeatGraph(store)
    n = [g.add_node() for _ in range(n_nodes)]
    in1 = _mk_edge(ns, g, n[0], n[2], 0, end=9000)
    _mk_edge(ns, g, n[3], n[1], 1, end=9000)
    in2 = _mk_edge(ns, g, n[4], n[2], 2, end=9000)
    _mk_edge(ns, g, n[3], n[5], 3, end=9000)
    rep = _mk_edge(ns, g, n[2], n[6], 4, cov=60)
    _mk_edge(ns, g, n[7], n[3], 5, cov=60)
    out1 = _mk_edge(ns, g, n[6], n[8], 6, end=9000)
    _mk_edge(ns, g, n[9], n[7], 7, end=9000)
    out2 = _mk_edge(ns, g, n[6], n[10], 8, end=9000)
    _mk_edge(ns, g, n[11], n[7], 9, end=9000)
    rep.repetitive = True
    simple = ns.trestle.SimpleRepeat(ns.UnbranchingPath(rep.edge_id, [rep]),
                                     [in1, in2], [out1, out2])

    reads = ns.SequenceStore()
    chains = []
    seed_ctr = [0]

    def flank(edge, rid):
        return ns.EdgeAlignment(ns.Overlap(rid, -1, 0, 100, 2000, 0, 100,
                                           edge.length(), score=50), edge)

    def add_read(copy, lo, hi, entry=None, exit_e=None):
        codes = copy[lo:hi]
        if noise:
            seed_ctr[0] += 1
            codes = _noisy(codes, noise, seed_ctr[0])
        rid = int(reads.add(f"r{len(chains)}", np.ascontiguousarray(codes)))
        chain = [flank(entry, rid)] if entry is not None else []
        m = hi - lo
        chain.append(ns.EdgeAlignment(
            ns.Overlap(rid, -1, 0, m, m, lo, hi, L, score=m), rep))
        if exit_e is not None:
            chain.append(flank(exit_e, rid))
        chains.append(chain)

    for _ in range(3):
        add_read(copy_a, 0, entry_hi, entry=in1)
        add_read(copy_b, 0, entry_hi, entry=in2)
        add_read(copy_a, 200, 1300)
        add_read(copy_b, 200, 1300)
        add_read(copy_a, exit_lo, L, exit_e=out1)
        add_read(copy_b, exit_lo, L, exit_e=out2)

    chains_by_edge = {}
    for chain in chains:
        for a in chain:
            chains_by_edge.setdefault(a.edge.edge_id, []).append(chain)
    return g, reads, simple, chains_by_edge


def _snp_copies(seed, every):
    rng = np.random.default_rng(seed)
    copy_b = rng.integers(0, 4, L).astype(np.uint8)
    copy_a = copy_b.copy()
    for p in range(50, L, every):
        copy_a[p] = (copy_a[p] + 1) % 4
    return copy_a, copy_b


def _same_copy(seed):
    copy = np.random.default_rng(seed).integers(0, 4, L).astype(np.uint8)
    return copy, copy


# name -> (copies, build_case keywords): the inputs of
# tests/test_trestle_divergence.py (distinct copies with noise and
# without, identical copies with and without), the widened variant
# (entrances [0, 1100), exits [400, L)) on which _divergence_vote
# resolves, and tests/test_trestle_iterative.py's fixture
FIXTURES = {
    "distinct_noisy": (lambda: _snp_copies(11, 150), dict(noise=0.03)),
    "distinct": (lambda: _snp_copies(11, 150), {}),
    "identical": (lambda: _same_copy(12), {}),
    "identical_noisy": (lambda: _same_copy(12), dict(noise=0.04)),
    "widened": (lambda: _snp_copies(5, 60),
                dict(entry_hi=1100, exit_lo=400)),
    "iterative": (lambda: _snp_copies(11, 100), dict(n_nodes=14)),
}
STRATEGIES = ("_position_partition", "_divergence_vote",
              "_iterative_partition")


def _pairing(ns, fixture, strategy):
    copies, kw = FIXTURES[fixture]
    g, reads, simple, cbe = build_case(ns, *copies(), **kw)
    pairing = getattr(ns.trestle, strategy)(g, reads, simple, cbe)
    if pairing is None:
        return None
    return tuple((i.edge_id, o.edge_id) for i, o in pairing)


@pytest.mark.parametrize("fixture", list(FIXTURES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_pairing_equal(strategy, fixture):
    """Each device-backed strategy called directly: the pairing it
    returns (None included) equals the JAX package's."""
    ref = _pairing(JAX, fixture, strategy)
    got = _pairing(TORCH, fixture, strategy)
    assert got == ref
    if fixture.startswith("identical"):
        assert got is None
    if (strategy, fixture) in (("_position_partition", "distinct_noisy"),
                               ("_iterative_partition", "iterative"),
                               ("_divergence_vote", "widened")):
        assert got is not None and set(got) == {(0, 6), (2, 8)}
