"""Exact maximum-weight matching on a general graph.

The repeat resolver picks read-supported connections through repeats
with a maximum-weight matching on the transition graph (reference:
src/repeat_graph/repeat_resolver.cpp:22-170, lemon's matching there;
the JAX package calls `networkx.max_weight_matching`).  networkx is not
a dependency of this package, so this module carries the same
algorithm: Edmonds' blossom method with the primal-dual weight updates
(Galil, "Efficient Algorithms for Finding Maximum Matching in Graphs",
ACM Computing Surveys 1986), in the form of J. van Rantwijk's
`mwmatching`, on which networkx's implementation is built.

Ties between matchings of equal weight resolve by the order in which
vertices and edges are visited.  The graph is a dict of dicts
(`adj[u][v] = weight`, both directions) whose insertion order is the
order networkx's `Graph` keeps, and every scan below walks vertices,
neighbours and blossoms in the same order as networkx does, so the two
return the same matching.  Weights that are all Python ints keep every
dual variable an integer.
"""

from __future__ import annotations

from itertools import repeat
from typing import Dict, Hashable, Set, Tuple

Node = Hashable


class _NoNode:
    """A value that is no vertex."""


class _Blossom:
    """A non-trivial blossom: `childs` are its sub-blossoms from the base
    round the cycle; `edges[i] = (v, w)` joins childs[i] (v) to
    childs[i+1] (w); `mybestedges` caches least-slack edges to other
    S-blossoms while it is a top-level S-blossom."""

    __slots__ = ("childs", "edges", "mybestedges")

    def __init__(self):
        self.childs = []
        self.edges = []
        self.mybestedges = None

    def leaves(self):
        stack = [*self.childs]
        while stack:
            t = stack.pop()
            if isinstance(t, _Blossom):
                stack.extend(t.childs)
            else:
                yield t


def add_weighted_edge(adj: Dict[Node, Dict[Node, int]], u: Node, v: Node,
                      weight) -> None:
    """Add `weight` to edge (u, v), creating u, then v, then the edge, in
    the order `networkx.Graph.add_edge` would."""
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    w = adj[u].get(v, 0) + weight
    adj[u][v] = w
    adj[v][u] = w


def max_weight_matching(adj: Dict[Node, Dict[Node, int]]
                        ) -> Set[Tuple[Node, Node]]:
    """A maximum-weight matching of the undirected graph `adj` (not
    necessarily of maximum cardinality), as a set of (u, v) pairs, one
    per matched edge.  Self-loops are ignored."""
    gnodes = list(adj)
    if not gnodes:
        return set()

    maxweight = 0
    allinteger = True
    for u, nbrs in adj.items():
        for v, wt in nbrs.items():
            if u != v and wt > maxweight:
                maxweight = wt
            allinteger = allinteger and type(wt) is int

    mate: Dict = {}            # vertex -> partner
    label: Dict = {}           # top blossom / vertex -> 1 (S), 2 (T)
    labeledge: Dict = {}       # -> (v, w) through which it was labelled
    inblossom = dict(zip(gnodes, gnodes))
    blossomparent = dict(zip(gnodes, repeat(None)))
    blossombase = dict(zip(gnodes, gnodes))
    bestedge: Dict = {}        # least-slack edge (see networkx)
    dualvar = dict(zip(gnodes, repeat(maxweight)))   # 2 * u(v)
    blossomdual: Dict = {}     # z(b)
    allowedge: Dict = {}       # zero-slack edges, both directions
    queue: list = []           # new S-vertices

    def slack(v, w):
        return dualvar[v] + dualvar[w] - 2 * adj[v][w]

    def assign_label(w, t, v):
        # iterative over the T -> mate S hop
        while True:
            b = inblossom[w]
            label[w] = label[b] = t
            labeledge[w] = labeledge[b] = None if v is None else (v, w)
            bestedge[w] = bestedge[b] = None
            if t == 1:
                if isinstance(b, _Blossom):
                    queue.extend(b.leaves())
                else:
                    queue.append(b)
                return
            base = blossombase[b]
            w, t, v = mate[base], 1, base

    def scan_blossom(v, w):
        """Trace back from v and w; the base of a new blossom, or
        _NoNode when the paths end at two single vertices."""
        path = []
        base = _NoNode
        while v is not _NoNode:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            path.append(b)
            label[b] = 5
            if labeledge[b] is None:
                v = _NoNode
            else:
                v = labeledge[b][0]
                b = inblossom[v]
                v = labeledge[b][0]
            if w is not _NoNode:
                v, w = w, v
        for b in path:
            label[b] = 1
        return base

    def add_blossom(base, v, w):
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = _Blossom()
        blossombase[b] = base
        blossomparent[b] = None
        blossomparent[bb] = b
        path = b.childs
        edgs = b.edges
        edgs.append((v, w))
        while bv != bb:
            blossomparent[bv] = b
            path.append(bv)
            edgs.append(labeledge[bv])
            v = labeledge[bv][0]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        edgs.reverse()
        while bw != bb:
            blossomparent[bw] = b
            path.append(bw)
            edgs.append((labeledge[bw][1], labeledge[bw][0]))
            w = labeledge[bw][0]
            bw = inblossom[w]
        label[b] = 1
        labeledge[b] = labeledge[bb]
        blossomdual[b] = 0
        for x in b.leaves():
            if label[inblossom[x]] == 2:
                queue.append(x)
            inblossom[x] = b
        bestedgeto = {}
        for sub in path:
            if isinstance(sub, _Blossom):
                if sub.mybestedges is not None:
                    nblist = sub.mybestedges
                    sub.mybestedges = None
                else:
                    nblist = [(x, y) for x in sub.leaves()
                              for y in adj[x] if x != y]
            else:
                nblist = [(sub, y) for y in adj[sub] if sub != y]
            for k in nblist:
                i, j = k
                if inblossom[j] == b:
                    i, j = j, i
                bj = inblossom[j]
                if (bj != b and label.get(bj) == 1
                        and (bj not in bestedgeto
                             or slack(i, j) < slack(*bestedgeto[bj]))):
                    bestedgeto[bj] = k
            bestedge[sub] = None
        b.mybestedges = list(bestedgeto.values())
        best = None
        best_slack = None
        for k in b.mybestedges:
            ks = slack(*k)
            if best is None or ks < best_slack:
                best, best_slack = k, ks
        bestedge[b] = best

    def expand_blossom(b, endstage):
        def expand_one(b, endstage):
            for s in b.childs:
                blossomparent[s] = None
                if isinstance(s, _Blossom):
                    if endstage and blossomdual[s] == 0:
                        yield s
                    else:
                        for x in s.leaves():
                            inblossom[x] = s
                else:
                    inblossom[s] = s
            if (not endstage) and label.get(b) == 2:
                entrychild = inblossom[labeledge[b][1]]
                j = b.childs.index(entrychild)
                if j & 1:
                    j -= len(b.childs)
                    jstep = 1
                else:
                    jstep = -1
                v, w = labeledge[b]
                while j != 0:
                    if jstep == 1:
                        p, q = b.edges[j]
                    else:
                        q, p = b.edges[j - 1]
                    label[w] = None
                    label[q] = None
                    assign_label(w, 2, v)
                    allowedge[(p, q)] = allowedge[(q, p)] = True
                    j += jstep
                    if jstep == 1:
                        v, w = b.edges[j]
                    else:
                        w, v = b.edges[j - 1]
                    allowedge[(v, w)] = allowedge[(w, v)] = True
                    j += jstep
                bw = b.childs[j]
                label[w] = label[bw] = 2
                labeledge[w] = labeledge[bw] = (v, w)
                bestedge[bw] = None
                j += jstep
                while b.childs[j] != entrychild:
                    bv = b.childs[j]
                    if label.get(bv) == 1:
                        j += jstep
                        continue
                    if isinstance(bv, _Blossom):
                        for v in bv.leaves():
                            if label.get(v):
                                break
                    else:
                        v = bv
                    if label.get(v):
                        label[v] = None
                        label[mate[blossombase[bv]]] = None
                        assign_label(v, 2, labeledge[v][0])
                    j += jstep
            label.pop(b, None)
            labeledge.pop(b, None)
            bestedge.pop(b, None)
            del blossomparent[b]
            del blossombase[b]
            del blossomdual[b]

        # depth-first over sub-blossoms without recursion
        stack = [expand_one(b, endstage)]
        while stack:
            for s in stack[-1]:
                stack.append(expand_one(s, endstage))
                break
            else:
                stack.pop()

    def augment_blossom(b, v):
        def augment_one(b, v):
            t = v
            while blossomparent[t] != b:
                t = blossomparent[t]
            if isinstance(t, _Blossom):
                yield (t, v)
            i = j = b.childs.index(t)
            if i & 1:
                j -= len(b.childs)
                jstep = 1
            else:
                jstep = -1
            while j != 0:
                j += jstep
                t = b.childs[j]
                if jstep == 1:
                    w, x = b.edges[j]
                else:
                    x, w = b.edges[j - 1]
                if isinstance(t, _Blossom):
                    yield (t, w)
                j += jstep
                t = b.childs[j]
                if isinstance(t, _Blossom):
                    yield (t, x)
                mate[w] = x
                mate[x] = w
            b.childs = b.childs[i:] + b.childs[:i]
            b.edges = b.edges[i:] + b.edges[:i]
            blossombase[b] = blossombase[b.childs[0]]

        stack = [augment_one(b, v)]
        while stack:
            for args in stack[-1]:
                stack.append(augment_one(*args))
                break
            else:
                stack.pop()

    def augment_matching(v, w):
        for s, j in ((v, w), (w, v)):
            while True:
                bs = inblossom[s]
                if isinstance(bs, _Blossom):
                    augment_blossom(bs, s)
                mate[s] = j
                if labeledge[bs] is None:
                    break
                t = labeledge[bs][0]
                bt = inblossom[t]
                s, j = labeledge[bt]
                if isinstance(bt, _Blossom):
                    augment_blossom(bt, j)
                mate[j] = s

    while True:                       # one stage per augmentation
        label.clear()
        labeledge.clear()
        bestedge.clear()
        for b in blossomdual:
            b.mybestedges = None
        allowedge.clear()
        queue[:] = []
        for v in gnodes:
            if v not in mate and label.get(inblossom[v]) is None:
                assign_label(v, 1, None)

        augmented = False
        while True:                   # substages
            while queue and not augmented:
                v = queue.pop()
                for w in adj[v]:
                    if w == v:
                        continue
                    bv = inblossom[v]
                    bw = inblossom[w]
                    if bv == bw:
                        continue
                    if (v, w) not in allowedge:
                        kslack = slack(v, w)
                        if kslack <= 0:
                            allowedge[(v, w)] = allowedge[(w, v)] = True
                    if (v, w) in allowedge:
                        if label.get(bw) is None:
                            assign_label(w, 2, v)
                        elif label.get(bw) == 1:
                            base = scan_blossom(v, w)
                            if base is not _NoNode:
                                add_blossom(base, v, w)
                            else:
                                augment_matching(v, w)
                                augmented = True
                                break
                        elif label.get(w) is None:
                            label[w] = 2
                            labeledge[w] = (v, w)
                    elif label.get(bw) == 1:
                        if (bestedge.get(bv) is None
                                or kslack < slack(*bestedge[bv])):
                            bestedge[bv] = (v, w)
                    elif label.get(w) is None:
                        if (bestedge.get(w) is None
                                or kslack < slack(*bestedge[w])):
                            bestedge[w] = (v, w)
            if augmented:
                break

            # no augmenting path: the smallest dual step (delta 1-4)
            deltatype = 1
            delta = min(dualvar.values())
            deltaedge = deltablossom = None
            for v in gnodes:
                if (label.get(inblossom[v]) is None
                        and bestedge.get(v) is not None):
                    d = slack(*bestedge[v])
                    if d < delta:
                        delta, deltatype, deltaedge = d, 2, bestedge[v]
            for b in blossomparent:
                if (blossomparent[b] is None and label.get(b) == 1
                        and bestedge.get(b) is not None):
                    kslack = slack(*bestedge[b])
                    d = kslack // 2 if allinteger else kslack / 2.0
                    if d < delta:
                        delta, deltatype, deltaedge = d, 3, bestedge[b]
            for b in blossomdual:
                if (blossomparent[b] is None and label.get(b) == 2
                        and blossomdual[b] < delta):
                    delta, deltatype, deltablossom = blossomdual[b], 4, b

            for v in gnodes:
                lab = label.get(inblossom[v])
                if lab == 1:
                    dualvar[v] -= delta
                elif lab == 2:
                    dualvar[v] += delta
            for b in blossomdual:
                if blossomparent[b] is None:
                    if label.get(b) == 1:
                        blossomdual[b] += delta
                    elif label.get(b) == 2:
                        blossomdual[b] -= delta

            if deltatype == 1:
                break                 # optimum reached
            if deltatype in (2, 3):
                v, w = deltaedge
                allowedge[(v, w)] = allowedge[(w, v)] = True
                queue.append(v)
            else:
                expand_blossom(deltablossom, False)

        if not augmented:
            break
        for b in list(blossomdual.keys()):
            if b not in blossomdual:
                continue
            if (blossomparent[b] is None and label.get(b) == 1
                    and blossomdual[b] == 0):
                expand_blossom(b, True)

    out = set()
    for v, w in mate.items():
        if (w, v) not in out:
            out.add((v, w))
    return out
