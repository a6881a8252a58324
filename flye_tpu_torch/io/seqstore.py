"""Sequence container: 2-bit coded sequences with strand-aware ids.

Mirrors the behavior of the reference SequenceContainer
(reference: src/sequence/sequence_container.h:29-33, 136-270) — most
importantly the even/odd id scheme where the reverse complement of id
is `id ^ 1`. That encoding is load-bearing throughout the pipeline
(overlaps store signed strand via the id, graph edges pair up as
complement ids), so we keep it.

Unlike the reference (which materializes both strands), only forward
strands are stored; reverse complements are computed on access. Device
batches are built from the forward arena + strand flags.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flye_tpu_torch.io.fasta import COMPLEMENT, read_seq_file


class SeqId(int):
    """Strand-aware sequence id: seq index i -> fwd 2i, rev-comp 2i+1."""

    __slots__ = ()

    @property
    def rc(self) -> "SeqId":
        return SeqId(self ^ 1)

    @property
    def index(self) -> int:
        return self >> 1

    @property
    def is_forward(self) -> bool:
        return (self & 1) == 0

    @property
    def fwd(self) -> "SeqId":
        return SeqId(self & ~1)

    def signed_str(self, name: str = "") -> str:
        return ("+" if self.is_forward else "-") + (name or str(self.index))

    def __repr__(self) -> str:
        return f"SeqId({int(self)}={self.signed_str()})"


NO_SEQ = SeqId(-2)  # sentinel; NO_SEQ.rc == -1


class SequenceStore:
    """Append-only store of 2-bit coded sequences."""

    def __init__(self):
        self._chunks: List[np.ndarray] = []
        self._arena: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None
        self._lengths: List[int] = []
        self.names: List[str] = []
        self._name_to_index: Dict[str, int] = {}

    # ---------------- construction ----------------

    def add(self, name: str, codes: np.ndarray) -> SeqId:
        if name in self._name_to_index:
            name = f"{name}_dup{len(self.names)}"
        idx = len(self.names)
        self.names.append(name)
        self._name_to_index[name] = idx
        self._chunks.append(np.ascontiguousarray(codes, dtype=np.uint8))
        self._lengths.append(len(codes))
        self._arena = None  # invalidate
        return SeqId(2 * idx)

    @classmethod
    def from_file(cls, path: str, min_length: int = 0) -> "SequenceStore":
        store = cls()
        for name, codes in read_seq_file(path):
            if len(codes) >= min_length:
                store.add(name, codes)
        return store

    @classmethod
    def from_files(cls, paths: Sequence[str], min_length: int = 0) -> "SequenceStore":
        store = cls()
        for path in paths:
            for name, codes in read_seq_file(path):
                if len(codes) >= min_length:
                    store.add(name, codes)
        return store

    def _ensure_arena(self):
        if self._arena is None:
            lens = np.asarray(self._lengths, dtype=np.int64)
            self._offsets = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=self._offsets[1:])
            self._arena = (
                np.concatenate(self._chunks)
                if self._chunks
                else np.zeros(0, dtype=np.uint8)
            )

    # ---------------- queries ----------------

    def __len__(self) -> int:
        return len(self.names)

    @property
    def total_length(self) -> int:
        return int(sum(self._lengths))

    def ids(self, both_strands: bool = False) -> List[SeqId]:
        if both_strands:
            return [SeqId(i) for i in range(2 * len(self.names))]
        return [SeqId(2 * i) for i in range(len(self.names))]

    def length(self, sid: int) -> int:
        return self._lengths[sid >> 1]

    def name(self, sid: int) -> str:
        return self.names[sid >> 1]

    def id_by_name(self, name: str) -> SeqId:
        return SeqId(2 * self._name_to_index[name])

    def get(self, sid: int) -> np.ndarray:
        """Codes of the given strand-aware id (rc materialized on demand)."""
        self._ensure_arena()
        idx = sid >> 1
        fwd = self._arena[self._offsets[idx]:self._offsets[idx + 1]]
        if sid & 1:
            return COMPLEMENT[fwd[::-1]]
        return fwd

    def get_sub(self, sid: int, start: int, end: int) -> np.ndarray:
        """codes[start:end] of strand-aware id, without materializing rc."""
        self._ensure_arena()
        idx = sid >> 1
        base, top = self._offsets[idx], self._offsets[idx + 1]
        if sid & 1:
            n = top - base
            # rc coords map: rc[i] = comp(fwd[n-1-i])
            fwd = self._arena[top - end:top - start]
            return COMPLEMENT[fwd[::-1]]
        return self._arena[base + start:base + end]

    @property
    def arena(self) -> np.ndarray:
        """The forward strands end to end, in id order."""
        self._ensure_arena()
        return self._arena

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray(self._lengths, dtype=np.int64)

    def n50(self) -> int:
        return compute_nx(self.lengths, 0.50)

    def n90(self) -> int:
        return compute_nx(self.lengths, 0.90)

    # ---------------- device batching ----------------

    def padded_batch(
        self, sids: Sequence[int], pad_to: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather strand-aware sequences into a [B, pad_to] uint8 batch.

        Sequences longer than pad_to are truncated; shorter are padded
        with code 0 (masked downstream via the returned lengths).
        """
        batch = np.zeros((len(sids), pad_to), dtype=np.uint8)
        lens = np.zeros(len(sids), dtype=np.int32)
        for row, sid in enumerate(sids):
            codes = self.get(sid)
            n = min(len(codes), pad_to)
            batch[row, :n] = codes[:n]
            lens[row] = n
        return batch, lens


def compute_nx(lengths: np.ndarray, frac: float, genome_size: int = 0) -> int:
    """N50-style statistic: length L such that contigs >= L cover frac of
    the total (or of genome_size for NG50)."""
    if len(lengths) == 0:
        return 0
    srt = np.sort(np.asarray(lengths))[::-1]
    total = genome_size if genome_size else int(srt.sum())
    csum = np.cumsum(srt)
    hit = np.searchsorted(csum, frac * total, side="right")
    if hit >= len(srt):
        return int(srt[-1])
    return int(srt[hit])
