"""K-mer extraction, hashing and minimizer selection over a flat read
stream, in PyTorch.

Port of `flye_tpu/ops/kmers.py`'s device functions: the w > 1
minimizer selection of the consensus read mapper's index build
(`stream_select_packed`, with its `splitmix64` hash and
`_sliding_min`), the padded-batch k-mers (`extract_kmers`,
`canonical_kmers`), the flat-stream index probe
(`stream_probe_packed`), the device solid-k-mer selection
(`solid_select_device`), and the mesh step's `kmer_hashes` and
`minimizer_mask`, with `umod`, the uint64 modulo of hash shards.  The
JAX functions are plain XLA (no Pallas), so these are plain tensor
code on whatever device their input lies on.

uint64 semantics on int64 tensors: PyTorch has no usable uint64
arithmetic, so hashes are kept as their int64 bit patterns.  Multiplies
wrap identically in two's complement; right shifts are masked after the
arithmetic shift so they are logical; and before any ordering compare
the sign bit is flipped (`_ORDER_FLIP`), which maps unsigned order onto
signed order.  Equality is unaffected by the flip.
"""

from __future__ import annotations

import torch

MAX_K = 31
# int64 bit patterns of the uint64 constants
_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MUL2 = 0x94D049BB133111EB - (1 << 64)
_ORDER_FLIP = -(1 << 63)        # xor: unsigned order -> signed order
# the JAX package's invalid-position hash is max uint64; flipped into
# signed order it becomes max int64
_INVALID_FLIPPED = (1 << 63) - 1


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer (reference: src/sequence/kmer.h:91-98);
    int64 in, the uint64 result's int64 bit pattern out."""
    x = x.to(torch.int64)
    x = (x ^ _lshr(x, 30)) * _MUL1
    x = (x ^ _lshr(x, 27)) * _MUL2
    return x ^ _lshr(x, 31)


def _sliding_min(h: torch.Tensor, width: int, pad_val: int) -> torch.Tensor:
    """out[p] = min(h[p .. p+width-1]) along the last axis, out-of-range
    treated as pad_val (sparse-table doubling: O(log width) mins).
    Signed order: pass sign-flipped hashes for uint64 order."""
    if width <= 1:
        return h
    n = h.shape[-1]
    idx = torch.arange(n, device=h.device)

    def shift(x, s):
        rolled = torch.roll(x, -s, dims=-1)
        return torch.where(idx < n - s, rolled,
                           torch.full_like(rolled, pad_val))

    g = h
    span = 1
    while span * 2 <= width:
        g = torch.minimum(g, shift(g, span))
        span *= 2
    if span == width:
        return g
    return torch.minimum(g, shift(g, width - span))


def _pack_kmers(codes: torch.Tensor, k: int):
    """Packed forward and reverse-complement k-mers at every column of
    a [B, L] uint8 code tensor (2 bits a base, the first base highest;
    columns past L - k wrap around the row and are junk)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} out of range 1..{MAX_K}")
    c = codes.to(torch.int64)
    fwd = torch.zeros_like(c)
    rc = torch.zeros_like(c)
    for j in range(k):
        # one rolled copy at a time: a [512, 16384] int64 is 64 MiB
        shifted = torch.roll(c, -j, dims=1) if j else c
        fwd |= shifted << (2 * (k - 1 - j))
        rc |= (3 - shifted) << (2 * j)
    return fwd, rc


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Packed forward and reverse-complement k-mers at every position of
    a padded batch.

    Args:
      codes: [B, L] uint8 base codes (0..3), zero-padded.
      lengths: [B] int true sequence lengths.
      k: k-mer size (<= 31).

    Returns (fwd [B, L] int64, rc [B, L] int64, valid [B, L] bool):
    valid where a complete k-mer starts (positions p > len-k are junk).
    """
    fwd, rc = _pack_kmers(codes, k)
    pos = torch.arange(codes.shape[1], device=codes.device)
    valid = pos[None, :] <= (lengths.to(torch.int64)[:, None] - k)
    return fwd, rc, valid


def canonical_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical (strand-symmetric) k-mers, min(fwd, revcomp)
    (reference: src/sequence/kmer.h:54-63 standardForm).

    Returns (canon [B, L] int64, is_fwd [B, L] bool, valid [B, L] bool).
    """
    fwd, rc, valid = extract_kmers(codes, lengths, k)
    is_fwd = fwd <= rc
    return torch.where(is_fwd, fwd, rc), is_fwd, valid


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """h mod n for the uint64 values whose int64 bit patterns h holds
    (a signed `%` differs unless n is a power of two): the high and low
    32-bit halves reduced apart, hi * 2^32 + lo = hi * (2^32 mod n) +
    lo (mod n)."""
    hi, lo = _lshr(h, 32), h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def kmer_hashes(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mers and their hashes, invalid positions forced to the
    max uint64 hash (bit pattern -1).  Returns (canon, hashes, valid)."""
    canon, _, valid = canonical_kmers(codes, lengths, k)
    h = torch.where(valid, splitmix64(canon), torch.full_like(canon, -1))
    return canon, h, valid


def minimizer_mask(hashes: torch.Tensor, valid: torch.Tensor,
                   w: int) -> torch.Tensor:
    """Minimizer positions: p is chosen iff its hash attains the minimum
    (uint64 order) of some fully in-bounds length-w window of k-mer
    positions; every tied minimum is chosen (see the JAX function)."""
    if w <= 1:
        return valid
    h = torch.where(valid, hashes ^ _ORDER_FLIP,
                    torch.full_like(hashes, _INVALID_FLIPPED))
    win_min = _sliding_min(h, w, _INVALID_FLIPPED)
    n = h.shape[-1]
    idx = torch.arange(n, device=h.device)
    # window s is fully in bounds iff its last position s+w-1 is valid
    win_ok = torch.roll(valid, -(w - 1), dims=-1) & (idx < n - (w - 1))
    selected = torch.zeros_like(valid)
    for j in range(w):
        # the window starting at s = p - j
        okj = torch.roll(win_ok, j, dims=-1) & (idx >= j)
        selected |= okj & (torch.roll(win_min, j, dims=-1) == h)
    return valid & selected


def stream_select_packed(chunks: torch.Tensor, starts: torch.Tensor,
                         row0: int, n_total: int, k: int, w: int,
                         sample: int, step: int) -> torch.Tensor:
    """Fused k-mer extraction + canonicalization + minimizer/sample
    selection over a flat read stream (see the JAX function of the same
    name for the layout).

    Args:
      chunks: [B, W] uint8; row r holds stream positions
        (row0+r)*step - (w-1) + col.
      starts: [R+1] int64 read start offsets (ascending, padded with
        n_total), on the same device as chunks.
      row0, n_total: global row index of chunks[0], stream length.
      k, w: k-mer size / minimizer window (w=1 -> sampling mode).
      sample: keep every sample-th position per read when w == 1.
      step: selectable positions per row, W - (k-1) - 2*(w-1).

    Returns [B, W] int64: the uint64 word
    (canon << 2) | (is_fwd << 1) | 1 at selected positions, 0 elsewhere.
    """
    B, W = chunks.shape
    dev = chunks.device
    fwd, rc = _pack_kmers(chunks, k)
    col = torch.arange(W, dtype=torch.int64, device=dev).expand(B, W)
    row = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    g = (row0 + row) * step + col - (w - 1)

    # a k-mer is valid iff it lies entirely within one read
    rid_a = torch.searchsorted(starts, g, right=True)
    rid_b = torch.searchsorted(starts, g + (k - 1), right=True)
    valid = ((g >= 0) & (g + k <= n_total) & (rid_a == rid_b)
             & (col <= W - k))

    is_fwd = fwd <= rc
    canon = torch.where(is_fwd, fwd, rc)

    if w > 1:
        h = torch.where(valid, splitmix64(canon) ^ _ORDER_FLIP,
                        torch.full_like(canon, _INVALID_FLIPPED))
        Wmin = _sliding_min(h, w, _INVALID_FLIPPED)

        def shiftL(x, s, fill):
            rolled = torch.roll(x, -s, dims=-1)
            return torch.where(col < W - s, rolled,
                               torch.full_like(rolled, fill))
        # window s is usable iff its first and last k-mers are valid and
        # belong to the same read (then so do all between)
        win_ok = (valid & shiftL(valid, w - 1, False)
                  & (rid_a == shiftL(rid_a, w - 1, -1)))
        selected = torch.zeros_like(valid)
        for j in range(w):
            Wj = torch.roll(Wmin, j, dims=-1)
            okj = torch.roll(win_ok, j, dims=-1) & (col >= j)
            selected |= okj & (Wj == h)
        selected &= valid
    elif sample > 1:
        # sample phase restarts at each read start
        read_start = starts[torch.clamp(rid_a - 1, min=0)]
        selected = valid & ((g - read_start) % sample == 0)
    else:
        selected = valid
    # only the interior zone belongs to this row
    selected = selected & (col >= w - 1) & (col < w - 1 + step)

    packed = (canon << 2) | (is_fwd.to(torch.int64) << 1) | 1
    return torch.where(selected, packed, torch.zeros_like(packed))


def stream_probe_packed(chunks: torch.Tensor, starts: torch.Tensor,
                        row0: int, n_total: int, uniq: torch.Tensor,
                        repet: torch.Tensor, rmax: int, k: int, step: int,
                        narrow: bool) -> torch.Tensor:
    """Fused canonicalize + index probe over a flat query stream (see
    the JAX function of the same name for the layout).

    Args:
      chunks: [B, W] uint8; row r holds stream positions
        (row0+r)*step + col (no left pad).
      starts: [R+1] int64 read offsets (ascending, padded with n_total).
      uniq: [Up] int64 sorted table of the index's k-mers (any tail
        past row rmax must sort after every k-mer); repet: [Up] bool.
      rmax: the last real row of uniq; k-mer size k; step = W - (k-1).
      narrow: pack into int32 (rows < 2^28), else int64.

    Returns [B, W] words of `probe_words`; hit and rep only at valid
    positions whose k-mer is in the table.
    """
    B, W = chunks.shape
    dev = chunks.device
    fwd, rc = _pack_kmers(chunks, k)
    is_fwd = fwd <= rc
    canon = torch.where(is_fwd, fwd, rc)
    del fwd, rc
    col = torch.arange(W, dtype=torch.int64, device=dev)
    row = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    g = (row0 + row) * step + col
    # no left pad here, so no g >= 0 term (unlike stream_select_packed)
    valid = ((g + k <= n_total)
             & (torch.searchsorted(starts, g, right=True)
                == torch.searchsorted(starts, g + (k - 1), right=True))
             & (col < step))
    del g
    return probe_words(canon, is_fwd, valid, uniq, repet, rmax, narrow)


def probe_words(canon: torch.Tensor, is_fwd: torch.Tensor,
                valid: torch.Tensor, uniq: torch.Tensor,
                repet: torch.Tensor, rmax: int,
                narrow: bool) -> torch.Tensor:
    """Look canonical k-mers up in the sorted table `uniq` and pack one
    word a position: row | hit << 28 | rep << 29 | is_fwd << 30 (int32)
    when narrow, else int64 with shifts 32/33/34."""
    # clamped as the JAX gather clamps: every index below is in range
    r = torch.searchsorted(uniq, canon).clamp_(0, rmax)
    found = (uniq[r] == canon) & valid
    rep = repet[r] & found
    hit = found & ~rep
    dtype, shift = (torch.int32, 28) if narrow else (torch.int64, 32)
    return (r.to(dtype) | (hit.to(dtype) << shift)
            | (rep.to(dtype) << (shift + 1))
            | (is_fwd.to(dtype) << (shift + 2)))


def _run_lengths(keys: torch.Tensor) -> torch.Tensor:
    """Per-element count of the elements equal to it (int64)."""
    _, inverse, counts = torch.unique(keys, return_inverse=True,
                                      return_counts=True)
    return counts[inverse]


def solid_select_device(packed: torch.Tensor, starts: torch.Tensor,
                        idx90: torch.Tensor, select_rate: float, k: int,
                        W: int, step: int, tandem_freq: int,
                        global_min: int):
    """Solid-k-mer selection on the device: global k-mer counts, the
    per-read frequency threshold and the within-read tandem filter,
    returning the selected postings compacted (the port of the JAX
    function of the same name; reference: src/sequence/
    vertex_index.cpp:25-125 buildIndexUnevenCoverage with the
    KmerCounter of :499-633, and the tandem filter of :440-480).

    Args:
      packed: [N] int64, stream_select_packed's w = 1 words
        (canon << 2 | is_fwd << 1 | selected), rows of W flattened.
      starts: [Rp] int64 read offsets (padded with n_total).
      idx90: [Rp] int64: per read, the rank of its p90 frequency in the
        (read, freq)-sorted valid positions (nearest rank).
      select_rate: meta_read_top_kmer_rate; the threshold is
        max(global_min, min(4, int32(float32(rate) * float32(p90)))).
      k, W, step: k-mer size, row width, selectable columns a row.
      tandem_freq, global_min: the filters' limits.

    Returns (pk [n] int64 selected words, pg [n] int64 their stream
    positions, both in stream order, n).  Equal to the JAX function's
    pk[:n], pg[:n], n_sel.
    """
    dev = packed.device
    rows = packed.numel() // W
    # the JAX function works over all N positions with sentinel keys;
    # only the valid ones matter, so they are compacted first
    sel0 = (packed.view(rows, W) & 1) != 0
    sel0 &= torch.arange(W, device=dev) < step
    vi = torch.nonzero(sel0.view(-1)).squeeze(1)
    del sel0
    pv = packed[vi]
    g = (vi // W) * step + vi % W
    del vi
    kmer = _lshr(pv, 2)
    freq = _run_lengths(kmer)
    rid = torch.searchsorted(starts, g, right=True) - 1
    # p90 by nearest rank over the (read, freq)-sorted positions; the
    # JAX sort keeps its sentinels after them, hence the one appended
    skey = torch.sort((rid << 32) | freq).values
    skey = torch.cat([skey, torch.full((1,), torch.iinfo(torch.int64).max,
                                       dtype=torch.int64, device=dev)])
    p90 = (skey[idx90.clamp(0, len(skey) - 1)]
           & 0xFFFFFFFF).to(torch.float32)
    del skey
    # float32 product, truncated: min(4, trunc(x)) == trunc(min(x, 4))
    # for an integer 4, and the clamp keeps the cast in int32's range
    x = torch.tensor(select_rate, dtype=torch.float32, device=dev) * p90
    thr = x.clamp_(max=4.0).to(torch.int32).clamp_(min=global_min)
    tcount = _run_lengths((rid << (2 * k)) | kmer)
    sel = (freq >= thr[rid]) & (tcount <= tandem_freq)
    pk, pg = pv[sel], g[sel]
    return pk, pg, int(pk.numel())
