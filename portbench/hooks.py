"""What the benchmark notes of the program while its window runs.

`Recorder` wraps three of the port's entry points, its hooks, for the
window's jobs and restores them after:
  - "chain_dp": `ops.chain.chain_dp` (K1 on a CUDA tensor, its plain
    version on a CPU one),
  - "levenshtein": `ops.align.edit_distance_batch` (K5 likewise),
  - "climb": `ops.polish._Climb.run` (one batch's device-resident
    climb: K2+K3 in CUDA-graph replays).
For the correctness check it keeps a sample of the calls, drawn from
the seed: the inputs and the outputs of the timed path, copied to the
host (of a K1 or K5 launch, a block of its rows at an offset drawn
from the seed).  With roofline modules (`roofline/<kernel>.py`, each
naming the hook it reads as HOOK) it also notes every call's work: each
module's `note(rec, call)` keeps what its `work(note)` counts after the
job, from the call's arguments, its outputs and the launches it made
(the counts `_cuda.LAUNCHES` keeps, graph replays included).

On a CUDA device the copies are pinned host buffers filled on a stream
of the recorder's own that waits for the program's stream; nothing
here synchronises or reads the card inside a job (the census scheme of
`chip_smoke.py`).  `settle()`, after a job's synchronize, makes the
copies numpy.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

# most rows of a sampled K1 or K5 launch kept for the check
K1_ROWS = 2048
K5_ROWS = 1 << 16


class Call(NamedTuple):
    """One call of a hooked entry point, as a roofline module sees it."""
    args: tuple
    out: object
    launches: dict   # kernel name -> launches the call made


class Recorder:
    def __init__(self, seed: int, sample: dict, roofs=()):
        # sample: kernel -> [probability, most calls kept in the run]
        # roofs: {kernel: roofline module}, noted while the window runs
        self.rng = np.random.default_rng([int(seed) % 2**64, 7])
        self.sample = sample
        self.roofs = dict(roofs)
        self.samples = {"chain_dp": [], "levenshtein": [], "climb": []}
        self.notes = {k: [] for k in self.roofs}
        self.calls = {"chain_dp": 0, "levenshtein": 0, "climb": 0}
        self.captures = 0     # climb graphs first captured in the window
        self.host_s = 0.0
        self.saved = []
        self.stream = None

    # ------------------------------------------------------------ set-up
    def __enter__(self):
        from flye_tpu_torch.ops import _cuda, align, chain, polish
        self.launches = _cuda.LAUNCHES
        if torch.cuda.is_available():
            self.stream = torch.cuda.Stream()
        targets = ((chain, "chain_dp", self._wrap_chain),
                   (align, "edit_distance_batch", self._wrap_lev),
                   (polish._Climb, "run", self._wrap_climb))
        for owner, attr, wrap in targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []

    def _take(self, kernel: str) -> bool:
        p, cap = self.sample.get(kernel, (0.0, 0))
        self.calls[kernel] += 1
        return (len(self.samples[kernel]) < cap
                and self.rng.random() < p)

    def _rows(self, n: int, most: int) -> slice:
        """A block of at most `most` consecutive rows of n, at an offset
        drawn from the seed (rows are independent in K1 and K5)."""
        if n <= most:
            return slice(0, n)
        r0 = int(self.rng.integers(0, n - most + 1))
        return slice(r0, r0 + most)

    def to_host(self, tensors):
        """Host copies of tensors: pinned and queued on the recorder's
        stream for CUDA tensors, clones for CPU ones."""
        out = []
        cuda = [t for t in tensors if t.is_cuda]
        if cuda:
            self.stream.wait_stream(
                torch.cuda.current_stream(cuda[0].device))
        for t in tensors:
            if not t.is_cuda:
                out.append(t.detach().clone())
                continue
            with torch.cuda.stream(self.stream):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
            out.append(h)
        return out

    def _note(self, hook: str, args, out, before):
        """Every roofline module of `hook` notes the call's work."""
        launches = {k: v - before.get(k, 0) for k, v in
                    self.launches.items() if v != before.get(k, 0)}
        for kernel, mod in self.roofs.items():
            if mod.HOOK == hook:
                note = mod.note(self, Call(args, out, launches))
                if note is not None:
                    self.notes[kernel].append(note)

    def _hooked(self, hook: str) -> bool:
        return any(m.HOOK == hook for m in self.roofs.values())

    # ------------------------------------------------------------ wraps
    def _wrap_chain(self, fn):
        def chain_dp(cur, ext, nvalid, k, max_jump, lookback):
            noted = self._hooked("chain_dp")
            before = dict(self.launches) if noted else None
            score, parent = fn(cur, ext, nvalid, k, max_jump, lookback)
            t0 = time.perf_counter()
            if noted:
                self._note("chain_dp", (cur, ext, nvalid, k, max_jump,
                                        lookback), (score, parent), before)
            if self._take("chain_dp"):
                rows = self._rows(cur.shape[0], K1_ROWS)
                self.samples["chain_dp"].append(
                    (self.to_host([t[rows] for t in
                                    (cur, ext, nvalid, score, parent)]),
                     (int(k), int(max_jump), int(lookback))))
            self.host_s += time.perf_counter() - t0
            return score, parent
        return chain_dp

    def _wrap_lev(self, fn):
        def edit_distance_batch(a, alen, b, blen):
            noted = self._hooked("levenshtein")
            before = dict(self.launches) if noted else None
            out = fn(a, alen, b, blen)
            t0 = time.perf_counter()
            if noted:
                self._note("levenshtein", (a, alen, b, blen), out, before)
            if self._take("levenshtein"):
                rows = self._rows(a.shape[0], K5_ROWS)
                self.samples["levenshtein"].append(
                    (self.to_host([t[rows] for t in
                                    (a, alen, b, blen, out)]), ()))
            self.host_s += time.perf_counter() - t0
            return out
        return edit_distance_batch

    def _wrap_climb(self, fn):
        rec = self

        def run(climb, arrays, max_iters):
            rec.captures += climb.graph is None and climb.device.type == \
                "cuda"
            noted = rec._hooked("climb")
            before = dict(rec.launches) if noted else None
            out = fn(climb, arrays, max_iters)
            t0 = time.perf_counter()
            if noted:
                rec._note("climb", (climb, arrays, max_iters), out, before)
            if rec._take("climb"):
                rec.samples["climb"].append(
                    ([np.array(a) for a in arrays], int(max_iters),
                     climb.groups, climb.block_size, climb.steepest,
                     [np.array(o) for o in out[:3]]))
            rec.host_s += time.perf_counter() - t0
            return out
        return run

    # ------------------------------------------------------------ after
    def settle(self):
        """After a job's synchronize: every host copy as numpy."""
        if self.stream is not None:
            self.stream.synchronize()

        def host(ts):
            return [t.numpy() if isinstance(t, torch.Tensor) else t
                    for t in ts]
        for kernel in ("chain_dp", "levenshtein"):
            self.samples[kernel] = [(host(ts), sc)
                                    for ts, sc in self.samples[kernel]]
        self.notes = {k: [tuple(host(n)) for n in v]
                      for k, v in self.notes.items()}

    def take_notes(self) -> dict:
        """{kernel: its notes} since the last take, settled."""
        out, self.notes = self.notes, {k: [] for k in self.roofs}
        return out
