"""Device mesh and its collectives for the assembly pipeline.

Port of `flye_tpu/parallel/mesh.py`.  The JAX package's mesh is the
local devices of one process, and its collectives (`psum`,
`all_to_all`) run between those devices under `shard_map`.  Here one
process drives the devices of its `Mesh` (an ordered list of
`torch.device`s), and each collective is a tensor operation across
them:

  psum        — the sum of the shards' tensors, on the first device;
  all_to_all  — shard d receives row d of every sender's [n_dev, cap]
                send buffer, concatenated in sender order (a
                `Tensor.to(device)` of each row).

A mesh may name one device more than once: that is how a mesh of
several shards is built on one card or on the CPU, and the shards'
work then runs one after the other on it.  Results do not depend on
the number of shards: integer sums, and a fixed routing and sort.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from flye_tpu_torch.ops.chain import chain_dp
from flye_tpu_torch.ops.kmers import (_ORDER_FLIP, kmer_hashes,
                                      minimizer_mask, splitmix64, umod)
from flye_tpu_torch.parallel.runtime import _tensor, device_scope

HIST_BUCKETS = 1 << 16  # hash-bucketed k-mer histogram size
# empty padding of the posting exchange: max uint64, as an int64 bit
# pattern
SENTINEL = -1


class Mesh:
    """An ordered list of devices on the one axis "data", with the
    `shape["data"]` and `size` of a 1-D `jax.sharding.Mesh` (the only
    kind the pipeline builds)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of the first `n_devices` of `devices` (default: the
    visible devices of `device_type`, default the runtime's type), as
    the JAX package's `make_mesh` cuts `jax.devices()`.  `devices` may
    repeat a device (a mesh of several shards on one card or on the
    CPU)."""
    if devices is None:
        from flye_tpu_torch.parallel.runtime import (get_runtime,
                                                     visible_devices)
        devices = visible_devices(device_type or
                                  get_runtime().device.type)
    return Mesh(list(devices)[:n_devices or len(devices)])


def _shards(mesh: Mesh, x):
    """A global array as its mesh shards: a list of per-device tensors
    stays as it is; a tensor or numpy array splits into equal
    contiguous row blocks, one on each device (its rows must divide
    the mesh size, as under `shard_map`)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    n = mesh.size
    if len(x) % n:
        raise ValueError(f"{len(x)} rows do not split over {n} devices")
    per = len(x) // n
    return [_tensor(x[i * per:(i + 1) * per], d)
            for i, d in enumerate(mesh.devices)]


def _psum(parts, device):
    """The collective sum of the shards' tensors, on `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _local_step(codes, lengths, cur, ext, nmatch, k: int, w: int,
                max_jump: int, lookback: int):
    """Per-shard compute: minimizer selection + bucketed k-mer histogram
    + chain DP, the device-plane inner loop of the assembly pipeline
    (index build + overlap chaining).  Returns the shard's (hist,
    score, parent, n_sel) before the psum."""
    _, h, valid = kmer_hashes(codes, lengths, k)
    sel = minimizer_mask(h, valid, w)
    buckets = umod(h, HIST_BUCKETS).reshape(-1)
    hist = torch.zeros(HIST_BUCKETS, dtype=torch.int32, device=h.device)
    hist.index_add_(0, buckets, sel.to(torch.int32).reshape(-1))
    score, parent = chain_dp(cur, ext, nmatch, k, max_jump, lookback)
    return hist, score, parent, sel.sum()


def posting_exchange_step(mesh: Mesh, n_per_dev: int, cap: int):
    """The all-to-all posting exchange of the hash-sharded index: each
    device routes the (kmer, payload) postings of its read partition to
    the device owning splitmix64(kmer) % n_dev (uint64 modulo), then
    sorts what it received by (kmer as uint64, payload), the padding
    last.  The deterministic analog of the reference's concurrent-map
    index insert (reference: vertex_index.cpp:389-483).

    Returns (fn, prepare).  prepare(kmers, payload) pads host arrays to
    n_dev * n_per_dev (SENTINEL kmers) and splits them over the mesh;
    fn(kmers, payload) returns, on the first device:
      sorted received kmers   [n_dev, n_dev * cap] int64,
      sorted received payload [n_dev, n_dev * cap] int64,
      n_dropped [n_dev] int32 (postings beyond `cap` in a (sender,
        owner) pair: dropped and counted, as in the JAX package),
      n_recv [n_dev] int32.
    """
    n_dev = mesh.shape["data"]
    first = mesh.devices[0]

    def route(kmers, payload):
        """One sender: its [n_dev, cap] send buffers and drop count."""
        dev = kmers.device
        valid = kmers != SENTINEL
        dest = torch.where(valid, umod(splitmix64(kmers), n_dev),
                           torch.full_like(kmers, n_dev))
        # slot = rank of each posting within its destination group, in
        # input order
        order = torch.argsort(dest, stable=True)
        counts = torch.bincount(dest, minlength=n_dev + 1)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.empty_like(dest)
        slot[order] = (torch.arange(len(dest), device=dev)
                       - starts[dest[order]])
        keep = (dest < n_dev) & (slot < cap)
        send_k = torch.full((n_dev, cap), SENTINEL, dtype=torch.int64,
                            device=dev)
        send_p = torch.zeros((n_dev, cap), dtype=torch.int64, device=dev)
        send_k[dest[keep], slot[keep]] = kmers[keep]
        send_p[dest[keep], slot[keep]] = payload[keep]
        return send_k, send_p, valid.sum() - keep.sum()

    def fn(kmers, payload):
        sends = [route(k_, p_) for k_, p_ in
                 zip(_shards(mesh, kmers), _shards(mesh, payload))]
        out_k, out_p, n_recv = [], [], []
        for d, dev in enumerate(mesh.devices):
            rk = torch.cat([s[0][d].to(dev) for s in sends])
            rp = torch.cat([s[1][d].to(dev) for s in sends])
            # (kmer as uint64, payload) order by two stable sorts: the
            # sign flip puts the max-uint64 padding last
            o = torch.argsort(rp, stable=True)
            rk, rp = rk[o], rp[o]
            o = torch.argsort(rk ^ _ORDER_FLIP, stable=True)
            rk, rp = rk[o], rp[o]
            out_k.append(rk.to(first))
            out_p.append(rp.to(first))
            n_recv.append((rk != SENTINEL).sum().to(first))
        n_dropped = torch.stack([s[2].to(first) for s in sends])
        return (torch.stack(out_k), torch.stack(out_p),
                n_dropped.to(torch.int32),
                torch.stack(n_recv).to(torch.int32))

    def prepare(kmers: np.ndarray, payload: np.ndarray):
        """Pad host posting arrays to the global shape, split over the
        mesh."""
        n = len(kmers)
        total = n_dev * n_per_dev
        if n > total:
            raise ValueError(f"{n} postings > capacity {total}")
        pk = np.full(total, SENTINEL, dtype=np.int64)
        pp = np.zeros(total, dtype=np.int64)
        pk[:n] = kmers
        pp[:n] = payload
        return _shards(mesh, pk), _shards(mesh, pp)

    return fn, prepare


def sharded_pipeline_step(mesh: Mesh, k: int = 15, w: int = 5,
                          max_jump: int = 1500, lookback: int = 64):
    """A mesh-sharded pipeline step.

    Returns (fn, make_example_args(batch_per_shard, read_len, n_matches,
    seed)).  fn(codes, lengths, cur, ext, nmatch) splits the rows over
    the mesh's 'data' axis (their count must divide it) and returns, on
    the first device, the k-mer histogram and the selected count summed
    over the shards (psum) and the score and parent rows in order."""
    n_data = mesh.shape["data"]
    first = mesh.devices[0]
    local = functools.partial(_local_step, k=k, w=w, max_jump=max_jump,
                              lookback=lookback)

    def on_shard(*args):
        with device_scope(args[0].device):
            return local(*args)

    def fn(codes, lengths, cur, ext, nmatch):
        outs = [on_shard(*args) for args in zip(
            *(_shards(mesh, x) for x in (codes, lengths, cur, ext,
                                         nmatch)))]
        hist = _psum([o[0] for o in outs], first)
        score = torch.cat([o[1].to(first) for o in outs])
        parent = torch.cat([o[2].to(first) for o in outs])
        n_sel = _psum([o[3] for o in outs], first)
        return hist, score, parent, n_sel

    def make_example_args(batch_per_shard: int = 2, read_len: int = 256,
                          n_matches: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        B = batch_per_shard * n_data
        codes = rng.integers(0, 4, size=(B, read_len)).astype(np.uint8)
        lengths = np.full(B, read_len, dtype=np.int32)
        cur = np.sort(rng.integers(0, 4000, size=(B, n_matches)),
                      axis=1).astype(np.int32)
        ext = (cur + 100).astype(np.int32)
        nmatch = np.full(B, n_matches, dtype=np.int32)
        return codes, lengths, cur, ext, nmatch

    return fn, make_example_args
