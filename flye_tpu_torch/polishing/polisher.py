"""Polishing driver: map -> bubbles -> batched kernel -> compose.

Port of `flye_tpu/polishing/polisher.py` (the reference's polishing
iteration, flye/polishing/polish.py:51-139 +
src/polishing/bubble_processor.cpp): the in-memory mapper feeds the
batched polishing kernels, bucketed by bubble size so thousands of
windows hill-climb in lockstep.  In a multi-process run the coordinator
fans read-mapping chunks and packed bubble batches out over the file
task bus (`parallel/taskbus.py`) to the worker processes, which map on
their own device and polish with the native CPU climber, and claims
pending tasks itself while it waits.  On an active device mesh
(`--shards`) each bubble batch splits its lanes over the mesh's
devices (`ops.polish.polish_bubbles`).
The consensus stage (reference: flye/polishing/consensus.py) is the same
machinery — a polishing pass with the draft as candidate ("consensus is
polishing iteration zero").
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flye_tpu_torch.config.params import PIPELINE
from flye_tpu_torch.io.seqstore import SequenceStore
from flye_tpu_torch.mapping.mapper import ReadMapper, uniform_alignments
from flye_tpu_torch.ops.polish import polish_bubbles
from flye_tpu_torch.polishing.matrices import get_subs_matrix
from flye_tpu_torch.polishing.windows import Bubble, compose, make_bubbles
from flye_tpu_torch.utils import trace
from flye_tpu_torch.utils.logs import stage_timer

logger = logging.getLogger("flye_tpu_torch")

# (candidate-buffer, branch-buffer) size buckets, kept from the JAX
# package (its 31/63/127-base branch tiers were sized for the TPU's
# 128-lane rows) so both packages batch the same bubbles together
_SIZE_BUCKETS = ((32, 31), (48, 63), (64, 96), (96, 127), (160, 240),
                 (384, 576), (768, 1152), (1536, 2304))
_R_BUCKETS = (8, 16, 32, 56)
_MEM_BUDGET = 1 << 30  # ~1GB of f32 DP tensor per plain-version call
# share of the card's memory the K2 backward-row tensor may take
_CUDA_MEM_SHARE = 8
_PRE_POLISH = 5        # median-length branch prepass threshold x2
# homopolymer-pass evidence gate (see polish_homopolymers): a run
# length only changes on >= _HOPO_MIN_OBS branch observations AND a
# > _HOPO_MARGIN log-likelihood margin over keeping the current
# length.  Swept E2E on the 420 kb parity set (round 5): ungated
# (2, 0.0) = 15 exact body errors, (4, 0.0) = 12, (2-3, 2.0) = 11,
# pass disabled = 10 — the margin gate recovers nearly all of the
# regression the instrument-bias prior causes on thin/simulated data
# while keeping the pass for real instrument data (the reference
# guards the same decision with compareTopTwo re-scoring,
# homo_polisher.cpp:271-310).
_HOPO_MIN_OBS = 3
_HOPO_MARGIN = 2.0


def _bucket_for(c: int, s: int) -> Tuple[int, int]:
    for cb, sb in _SIZE_BUCKETS:
        if c + c // 4 + 8 <= cb and s <= sb:
            return cb, sb
    return _SIZE_BUCKETS[-1]


def _coalesce(items: Dict[Tuple[int, int, int], List],
              min_batch: int = 48) -> Dict[Tuple[int, int, int], List]:
    """Merge small buckets into larger shapes, within a branch tier.

    Fewer, fuller batches (the JAX package merges them because every
    bucket shape compiles its own kernel set; the port keeps the same
    grouping so both packages batch the same bubbles).  Buckets below
    min_batch are folded into the next bucket by cost,
    taking the elementwise max of the dims (always a valid superset
    shape); the wasted lanes are bounded by min_batch per merge.
    Merging only happens between buckets of the same branch count:
    promoting an 8-branch bubble into a 56-branch shape would multiply
    its scoring work 7x (branch groups of 8 run as separate lanes)."""
    out: Dict[Tuple[int, int, int], List] = {}
    tiers = sorted({k[2] for k in items})
    for rb in tiers:
        keys = sorted((k for k in items if k[2] == rb),
                      key=lambda k: (k[0] * k[1], k))
        carry_key: Optional[Tuple[int, int, int]] = None
        carry: List = []
        for pos, orig in enumerate(keys):
            key, lst = orig, items[orig]
            if carry:
                key = tuple(max(a, b) for a, b in zip(key, carry_key))
                lst = carry + lst
                carry, carry_key = [], None
            if len(lst) < min_batch and pos < len(keys) - 1:
                carry, carry_key = lst, key
            else:
                out.setdefault(key, []).extend(lst)
        if carry:
            out.setdefault(carry_key, []).extend(carry)
    return out


def _max_batch(cb: int, sb: int, rb: int) -> int:
    """Batch cap for a bucket shape.

    On a GPU the dominant allocation is the K2 backward-row tensor,
    [B*groups, cb+1, 8, sb+1] f32: the cap keeps it within
    1/_CUDA_MEM_SHARE of the card's memory, as a power of two (see
    _quantize_batch) no larger than 8192.  Elsewhere (the plain version's
    full F/B tensors) the cap is the JAX package's CPU model: ~6 f32
    copies of [cb, sb, branches] per lane within _MEM_BUDGET."""
    import torch

    from flye_tpu_torch.parallel.runtime import get_runtime
    groups = max(1, -(-rb // 8))
    dev = get_runtime().device
    if dev.type == "cuda":
        budget = (torch.cuda.get_device_properties(dev).total_memory
                  // _CUDA_MEM_SHARE)
        per_lane = (cb + 1) * groups * 8 * (sb + 1) * 4
        cap = max(1, min(8192, budget // per_lane))
        p2 = 1
        while p2 * 2 <= cap:
            p2 <<= 1
        return p2
    per_lane = cb * sb * groups * 8 * 4 * 6
    return max(1, min(512, _MEM_BUDGET // per_lane))


def _pack_chunk(chunk: List[Tuple[Bubble, List[np.ndarray]]],
                cb: int, sb: int, rb: int, B: int):
    """Pack a chunk of (bubble, branches) into padded kernel arrays."""
    cand = np.zeros((B, cb), np.uint8)
    clen = np.zeros(B, np.int32)
    branches = np.zeros((B, rb, sb), np.uint8)
    blen = np.zeros((B, rb), np.int32)
    bmask = np.zeros((B, rb), bool)
    for i in range(B):
        # pad lanes replicate item 0 so they converge like real work
        b, brs = chunk[i] if i < len(chunk) else chunk[0]
        seq = b.polished if b.polished is not None else b.candidate
        n = min(len(seq), cb)
        cand[i, :n] = seq[:n]
        clen[i] = n
        for r, br in enumerate(brs[:rb]):
            m = min(len(br), sb)
            branches[i, r, :m] = br[:m]
            blen[i, r] = m
            bmask[i, r] = True
    return cand, clen, branches, blen, bmask


def _quantize_batch(n: int, max_b: int) -> int:
    """Round the batch up to a power of two (>= 32), as the JAX package
    does; pad lanes replicate a real bubble (see _pack_chunk)."""
    q = 32
    while q < n:
        q <<= 1
    return min(q, max_b)


# stage-1 iteration cap for the device convergence loop (must be EVEN:
# the block-parity alternation in _select_apply depends on it%2, and an
# even cutoff makes a restart-at-0 continue the exact same edit
# schedule, so two-stage results are byte-identical to a single deep
# run).  The lockstep batch pays its slowest lane's iterations, so the
# few stragglers rerun in a compact batch.
_STAGE1_ITERS = 8


def _run_bucket(items: List[Tuple[Bubble, List[np.ndarray]]],
                cb: int, sb: int, rb: int, subs: np.ndarray) -> None:
    """Polish a homogeneous bucket of bubbles in device batches.

    Two-stage convergence on a GPU (the JAX package's TPU schedule):
    every chunk first runs at most _STAGE1_ITERS iterations; lanes that
    didn't converge re-batch compactly and run to full depth.  Lockstep
    batches otherwise run every lane until the SLOWEST converges.  On
    the CPU the native climber runs each chunk to full depth."""
    import time

    from flye_tpu_torch.parallel.runtime import get_runtime

    max_b = _max_batch(cb, sb, rb)
    two_stage = get_runtime().device.type == "cuda"
    stage1 = _STAGE1_ITERS if two_stage else 2 * cb
    retry: List[Tuple[Bubble, List[np.ndarray]]] = []

    def run_chunks(chunks_src, iters, collect_retry):
        for lo in range(0, len(chunks_src), max_b):
            chunk = chunks_src[lo:lo + max_b]
            B = _quantize_batch(len(chunk), max_b)
            with trace.span("bubbles: pack"):
                cand, clen, branches, blen, bmask = _pack_chunk(
                    chunk, cb, sb, rb, B)
            t0 = time.perf_counter()
            out_c, out_l, _, it_h = polish_bubbles(
                cand, clen, branches, blen, bmask, subs, max_iters=iters)
            logger.debug(
                "bucket (%d,%d,%d) x%d: %.1fs, iters med/max %d/%d",
                cb, sb, rb, B, time.perf_counter() - t0,
                int(np.median(it_h)), int(it_h.max()))
            trace.count("climb.lane_steps_used",
                        int(it_h[:len(chunk)].sum()))
            with trace.span("bubbles: write-back"):
                for i, (b, brs) in enumerate(chunk):
                    b.polished = out_c[i, :out_l[i]].copy()
                    if collect_retry and it_h[i] >= stage1:
                        retry.append((b, brs))

    run_chunks(items, stage1, two_stage)
    trace.count("climb.retry_lanes", len(retry))
    if retry:
        logger.debug("bucket (%d,%d,%d): %d/%d lanes to full depth",
                     cb, sb, rb, len(retry), len(items))
        run_chunks(retry, 2 * cb, False)


# ---- multi-process fan-out over the file bus ----

_task_seq = [0]
_mapper_cache: Dict[str, ReadMapper] = {}


def _load_bus_targets(path: str) -> SequenceStore:
    z = np.load(path, allow_pickle=False)
    codes, off = z["codes"], z["off"]
    targets = SequenceStore()
    for i in range(len(off) - 1):
        targets.add(f"t{i}", codes[off[i]:off[i + 1]])
    return targets


def _bus_mapper(path: str, k: int, w: int, min_aln: int) -> ReadMapper:
    """Per-process single-entry mapper cache keyed by the targets file
    (every chunk of one mapping phase shares it; a new phase writes a
    new file and evicts the old mapper)."""
    mapper = _mapper_cache.get(path)
    if mapper is None:
        _mapper_cache.clear()
        targets = _load_bus_targets(path)
        mapper = ReadMapper(targets, k=k, w=w, min_aln_length=min_aln)
        _mapper_cache[path] = mapper
    return mapper


def _map_task(payload, reads_provider):
    """Bus handler: map one chunk of read ids onto the shared targets.

    The reference parallelizes exactly this across processes
    (flye/utils/sam_parser.py:123-258 chunked SAM reading;
    flye/polishing/bubbles.py:96-126).  Every process already holds the
    full read set, so the payload is just the id partition plus a
    pointer to the coordinator-written targets file."""
    from flye_tpu_torch.overlap.packed import encode_overlaps
    tgt_path = bytes(payload["tgt_path"].tobytes()).decode()
    mapper = _bus_mapper(tgt_path, int(payload["k"]),
                         int(payload["w"]), int(payload["min_aln"]))
    reads = reads_provider()
    by_t = mapper.map_all(reads, ids=payload["read_ids"].tolist())
    tids = sorted(by_t)
    counts = np.asarray([len(by_t[t]) for t in tids], np.int64)
    flat = [o for t in tids for o in by_t[t]]
    recs, d16, raw = encode_overlaps(flat)
    return {"tids": np.asarray(tids, np.int64), "counts": counts,
            "recs": recs, "d16": d16, "raw": raw}


def _map_all_bus(bus, targets: SequenceStore, reads: SequenceStore,
                 k: int, w: int, min_aln: int,
                 chunk: int = 4096) -> Dict[int, List]:
    """Coordinator side of the mapping partition: write the targets
    once, fan read-id chunks out, merge and deterministically order
    (the composite sort key makes the result independent of the
    partition)."""
    from flye_tpu_torch.mapping.mapper import sort_by_target
    from flye_tpu_torch.overlap.packed import decode_overlaps
    codes = [targets.get(t) for t in targets.ids()]
    off = np.zeros(len(codes) + 1, np.int64)
    off[1:] = np.cumsum([len(c) for c in codes])
    tgt_path = os.path.join(bus.root, f"targets_{_task_seq[0]}.npz")
    _task_seq[0] += 1
    tmp = tgt_path + f".tmp{os.getpid()}"
    np.savez(tmp, codes=(np.concatenate(codes) if codes
                         else np.zeros(0, np.uint8)), off=off)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", tgt_path)
    path_arr = np.frombuffer(tgt_path.encode(), np.uint8)
    ids = reads.ids()
    tasks = []
    for lo in range(0, len(ids), chunk):
        tid = f"t{_task_seq[0]}"
        _task_seq[0] += 1
        bus.submit("map", tid, dict(
            tgt_path=path_arr, k=np.int64(k), w=np.int64(w),
            min_aln=np.int64(min_aln),
            read_ids=np.asarray(ids[lo:lo + chunk], np.int64)))
        tasks.append(tid)
    results = bus.collect("map", tasks)
    by_target: Dict[int, List] = {}
    for tid in tasks:
        r = results[tid]
        flat = decode_overlaps(r["recs"], r["d16"], r["raw"])
        pos = 0
        for t, n in zip(r["tids"], r["counts"]):
            by_target.setdefault(int(t), []).extend(
                flat[pos:pos + int(n)])
            pos += int(n)
    sort_by_target(by_target)
    try:
        os.unlink(tgt_path)
    except OSError:
        pass
    return by_target


def _polish_task(payload, prefer_native: bool):
    """Bus handler: polish one packed chunk.  Workers take the threaded
    native CPU climber (the card, if any, is the coordinator's); the
    coordinator runs its normal device path (`polish_bubbles`)."""
    from flye_tpu_torch.ops.polish import _polish_bubbles_native
    args = (payload["cand"], payload["clen"], payload["branches"],
            payload["blen"], payload["bmask"].astype(bool),
            payload["subs"])
    max_iters = int(payload["max_iters"])
    if prefer_native:
        out = _polish_bubbles_native(*args, max_iters)
    else:
        out = polish_bubbles(*args, max_iters=max_iters)
    return {"cand": np.asarray(out[0]), "clen": np.asarray(out[1])}


def register_polish_handlers(bus, prefer_native: bool,
                             reads_provider=None) -> None:
    bus.register("polish",
                 lambda p: _polish_task(p, prefer_native=prefer_native))
    if reads_provider is not None:
        bus.register("map", lambda p: _map_task(p, reads_provider))


def _run_phase_bus(bus, items: Dict[Tuple[int, int, int], List],
                   subs: np.ndarray) -> None:
    """Fan a whole phase's buckets out over the task bus: submit every
    chunk (at most 2,048 bubbles, for work-stealing balance between
    the coordinator's card and CPU workers), then collect — the
    coordinator claims and processes pending chunks itself while
    waiting.  Each chunk climbs to full depth (max_iters = 2 * cb): the
    JAX package's bus schedule, not `_run_bucket`'s two stages.

    NOTE on determinism: worker chunks run the native CPU climber whose
    edit schedule differs from the device's block-parallel one; on tie
    cases the two converge to different (equally scoring) local optima,
    so a multi-process run with the coordinator on the card is NOT
    guaranteed byte-identical to a single-process one.  Runs with every
    process on the CPU (all native) are byte-identical by
    construction."""
    tasks = []
    for (cb, sb, rb), lst in sorted(items.items()):
        max_b = min(_max_batch(cb, sb, rb), 2048)
        for lo in range(0, len(lst), max_b):
            chunk = lst[lo:lo + max_b]
            B = _quantize_batch(len(chunk), max_b)
            with trace.span("bubbles: pack"):
                cand, clen, branches, blen, bmask = _pack_chunk(
                    chunk, cb, sb, rb, B)
            tid = f"t{_task_seq[0]}"
            _task_seq[0] += 1
            bus.submit("polish", tid, dict(
                cand=cand, clen=clen, branches=branches, blen=blen,
                bmask=bmask.astype(np.uint8), subs=subs,
                max_iters=np.int32(2 * cb)))
            tasks.append((tid, chunk))
    results = bus.collect("polish", [t for t, _ in tasks])
    with trace.span("bubbles: write-back"):
        for tid, chunk in tasks:
            out_c, out_l = results[tid]["cand"], results[tid]["clen"]
            for i, (b, _) in enumerate(chunk):
                b.polished = out_c[i, :out_l[i]].copy()


def _run_phase(items: Dict[Tuple[int, int, int], List],
               subs: np.ndarray) -> None:
    from flye_tpu_torch.parallel.taskbus import get_bus
    bus = get_bus()
    if bus is not None:
        _run_phase_bus(bus, items, subs)
        return
    for (cb, sb, rb), lst in sorted(items.items()):
        _run_bucket(lst, cb, sb, rb, subs)


def polish_bubble_set(bubbles: List[Bubble], platform: str) -> None:
    """Polish all bubbles in place, with the reference's median-length
    pre-polish pass for branch-rich bubbles
    (reference: general_polisher.cpp:37-55)."""
    subs = get_subs_matrix(platform)

    # phase 1: pre-polish rich bubbles with 5 median-length branches
    rich = [b for b in bubbles if len(b.branches) > 2 * _PRE_POLISH]
    if rich:
        with trace.span("bubbles: pack"):
            items: Dict[Tuple[int, int, int], List] = {}
            for b in rich:
                srt = sorted(b.branches, key=len)
                left = len(srt) // 2 - _PRE_POLISH // 2
                sel = srt[left:left + _PRE_POLISH]
                cb, sb = _bucket_for(len(b.candidate),
                                     max(len(x) for x in sel))
                items.setdefault((cb, sb, 8), []).append((b, sel))
            items = _coalesce(items)
        _run_phase(items, subs)

    # phase 2: all branches
    with trace.span("bubbles: pack"):
        items = {}
        for b in bubbles:
            if not b.branches:
                continue
            seq = b.polished if b.polished is not None else b.candidate
            cb, sb = _bucket_for(len(seq),
                                 max(len(x) for x in b.branches))
            rb = next((r for r in _R_BUCKETS if len(b.branches) <= r),
                      _R_BUCKETS[-1])
            items.setdefault((cb, sb, rb), []).append((b, b.branches))
        items = _coalesce(items)
    trace.count("polish.bubbles", sum(len(v) for v in items.values()))
    _run_phase(items, subs)

    # phase 3: homopolymer + dinucleotide re-estimation (reference:
    # HomoPolisher / DinucleotideFixer applied per bubble after the
    # general polisher, src/polishing/bubble_processor.cpp)
    with stage_timer("polish: homopolymer/dinucleotide"):
        _run_hopo_phase(bubbles, platform)


def _run_hopo_phase(bubbles: List[Bubble], platform: str) -> None:
    """Homopolymer ML + dinucleotide vote over all bubbles, batched
    through the threaded native pass."""
    from flye_tpu_torch import native
    from flye_tpu_torch.polishing.homopolisher import get_hopo_model
    todo = [b for b in bubbles
            if b.polished is not None and b.branches]
    if not todo:
        return
    mod = native.get()
    obs_logp, genome_logp = get_hopo_model(platform)
    with trace.span("homopolymer: pack"):
        cand_off = np.zeros(len(todo) + 1, np.int64)
        bb_off = np.zeros(len(todo) + 1, np.int64)
        for i, b in enumerate(todo):
            cand_off[i + 1] = cand_off[i] + len(b.polished)
            bb_off[i + 1] = bb_off[i] + len(b.branches)
        cand_flat = np.concatenate([b.polished for b in todo]) \
            if cand_off[-1] else np.zeros(0, np.uint8)
        all_br = [br for b in todo for br in b.branches]
        br_off = np.zeros(len(all_br) + 1, np.int64)
        br_off[1:] = np.cumsum([len(x) for x in all_br])
        br_flat = np.concatenate(all_br) if len(all_br) \
            else np.zeros(0, np.uint8)
    with trace.span("homopolymer: native"):
        out_flat_b, out_off_b = mod.polish_hopo_host(
            np.ascontiguousarray(cand_flat, np.uint8),
            cand_off, np.ascontiguousarray(br_flat, np.uint8),
            br_off, bb_off,
            np.ascontiguousarray(obs_logp, np.float64),
            np.ascontiguousarray(genome_logp, np.float64),
            4, 3, _HOPO_MIN_OBS, _HOPO_MARGIN)
    out_flat = np.frombuffer(out_flat_b, np.uint8)
    out_off = np.frombuffer(out_off_b, np.int64)
    with trace.span("homopolymer: write-back"):
        for i, b in enumerate(todo):
            b.polished = out_flat[out_off[i]:out_off[i + 1]].copy()


def polish(drafts: Sequence[Tuple[str, np.ndarray]],
           reads: SequenceStore, platform: str,
           num_iters: int = 1, k: int = 15, w: int = 5,
           max_bubble: Optional[int] = None,
           return_coverage: bool = False,
           trim_ends: bool = False):
    """Iteratively polish draft sequences with reads.

    trim_ends drops sub-2-branch bubbles at contig extremities before
    composing (the pipeline's consensus/polishing stages set it; callers
    polishing circular or fragment sequences — plasmids, Trestle — keep
    the full span).  Returns [(name, polished_codes)]
    (+ {name: mean_coverage} when return_coverage).
    """
    max_bubble = max_bubble or int(PIPELINE["max_bubble_length"])
    min_aln = int(PIPELINE["min_polish_aln_len"])
    max_cov = int(PIPELINE["max_read_coverage"])
    current = [(name, codes) for name, codes in drafts]
    coverage_stats: Dict[str, float] = {}

    for it in range(num_iters):
        with stage_timer(f"polishing iteration {it + 1}/{num_iters}"):
            targets = SequenceStore()
            for name, codes in current:
                if len(codes):
                    targets.add(name, codes)
            if not len(targets):
                break
            with stage_timer("polish: read mapping"):
                from flye_tpu_torch.parallel.taskbus import get_bus
                bus = get_bus()
                mapper = None
                if bus is not None and "map" in bus.handlers:
                    by_target = _map_all_bus(bus, targets, reads,
                                             k, w, min_aln)
                else:
                    mapper = ReadMapper(targets, k=k, w=w,
                                        min_aln_length=min_aln)
                    by_target = mapper.map_all(reads)

            all_bubbles: List[Bubble] = []
            per_target: Dict[int, List[Bubble]] = {}
            with stage_timer("polish: bubble extraction"):
                for tid in list(by_target.keys()):
                    draft = targets.get(tid)
                    alns = uniform_alignments(by_target.pop(tid),
                                              len(draft), max_cov)
                    bubbles = make_bubbles(tid, draft, alns, reads,
                                           max_bubble=max_bubble,
                                           min_aln_length=min_aln)
                    per_target[tid] = bubbles
                    coverage_stats[targets.name(tid)] = (
                        sum(a.cur_range for a in alns) / max(1, len(draft)))
                    # alignments (with per-anchor traces) are only
                    # needed for extraction — dropping them here keeps
                    # the kernels phase's RSS to the bubbles themselves
                    del alns
                    all_bubbles.extend(bubbles)
                del mapper
            logger.info("%d bubbles from %d sequences",
                        len(all_bubbles), len(per_target))
            with stage_timer("polish: bubble kernels"):
                polish_bubble_set(all_bubbles, platform)

            new_current = []
            with trace.span("polish: compose"):
                for name, codes in current:
                    try:
                        tid = targets.id_by_name(name)
                    except KeyError:
                        new_current.append((name, codes))
                        continue
                    bubbles = per_target.get(tid)
                    if bubbles:
                        if trim_ends:
                            from flye_tpu_torch.polishing.windows import \
                                trim_low_coverage_ends
                            bubbles = trim_low_coverage_ends(bubbles)
                        new_current.append((name, compose(bubbles)))
                    else:
                        new_current.append((name, codes))
            current = new_current
    if return_coverage:
        return current, coverage_stats
    return current
