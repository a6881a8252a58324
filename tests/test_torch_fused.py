"""K4, the fused polish scoring, against the JAX package's fused Pallas
kernel, and the port's choice between K4 and K2+K3.

The same seeded numpy inputs go through `flye_tpu.ops.polish_pallas.
_score_edits_fused` in interpret mode (called directly, with the tables
of `_prepare_branches`: `_score_edits_pallas` is jitted and reads
FLYE_TPU_FUSED at trace time, so a cached trace could hand back the
two-phase kernels) and through the port's CPU scoring path with
`fused=True`, which is K4's plain version.  Tolerance: raw and finished
scores within 1e-3 where finite with the same finiteness, chars exact
(tests/test_polish_pallas.py holds the JAX kernels to the same)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flye_tpu.ops.polish as P
import flye_tpu.ops.polish_pallas as PP
import flye_tpu.polishing.polisher as POLISHER
import flye_tpu_torch.ops.polish as TP
from flye_tpu_torch.ops import _cuda
from flye_tpu_torch.parallel.runtime import ParallelContext, set_runtime


@pytest.fixture(autouse=True)
def cpu_runtime():
    set_runtime(ParallelContext("cpu"))
    yield
    set_runtime(None)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(10, Cb + 1, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(8, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)
    return cand, clen, branches, blen, bmask, subs


def _jax_fused_raw(cand, clen, branches, blen, bmask, subs):
    """The JAX package's K4 in interpret mode, with n_shifts and the
    batch tile computed as `_score_edits_pallas` computes them."""
    Cb = cand.shape[1]
    _, R, S = branches.shape
    with jax.enable_x64(False), P._deep_recursion():
        prep = PP._prepare_branches(
            jnp.asarray(branches, jnp.int32), jnp.asarray(blen, jnp.int32),
            jnp.asarray(bmask), jnp.asarray(subs, jnp.float32))
        pack, Wseg, Rp, W = PP._kernel_dims(R, S)
        if pack == 1:
            Wseg = W
        n_shifts = (Wseg - 1).bit_length()
        Bp = prep[0].shape[1]
        tile = PP._pick_tile_fused(Rp, W, Cb + 1)
        assert tile is not None
        while tile > 8 and Bp % tile:
            tile //= 2
        raw = PP._score_edits_fused(
            jnp.asarray(cand, jnp.int32), jnp.asarray(clen, jnp.int32),
            *prep, pack, Wseg, n_shifts, tile, True)
        fin = P._finish_scores(jnp.asarray(cand, jnp.int32),
                               jnp.asarray(clen, jnp.int32), *raw,
                               groups=1)
    return [np.asarray(a) for a in raw], [np.asarray(a) for a in fin]


def _assert_close(name, r, o):
    assert r.shape == o.shape, name
    finite = r > -1e29
    assert np.array_equal(finite, o > -1e29), name
    if finite.any():
        diff = np.abs(np.where(finite, r - o, 0)).max()
        assert diff < 1e-3, (name, diff)


@pytest.mark.parametrize("seed,shape", [
    (0, (5, 24, 3, 40)),
    (3, (5, 24, 3, 40)),
    (1, (4, 20, 12, 28)),
    (2, (4, 20, 18, 60)),
    (5, (3, 16, 5, 130)),
    (6, (3, 16, 40, 30)),
])
def test_fused_matches_jax_fused_kernel(seed, shape):
    args = _inputs(seed, shape)
    ref_raw, ref_fin = _jax_fused_raw(*args)
    t = [torch.from_numpy(a) for a in args]
    raw = TP.score_edits_raw(*t, fused=True)
    fin = TP._finish_scores(t[0], t[1], *raw, groups=1)
    for name, r, o in zip(["total", "del_raw", "ins4", "sub4"], ref_raw,
                          raw):
        _assert_close(name, r, o.numpy())
    names = ["total", "del", "ins", "ins_chr", "sub", "sub_chr"]
    for name, r, o in zip(names, ref_fin, fin):
        if name.endswith("chr"):
            np.testing.assert_array_equal(r, o.numpy(), err_msg=name)
        else:
            _assert_close(name, r, o.numpy())


# every (Cb, S) of the polisher's buckets at each of its branch counts
@pytest.mark.parametrize("R", POLISHER._R_BUCKETS)
@pytest.mark.parametrize("Cb,S", POLISHER._SIZE_BUCKETS)
def test_fits_fused(Cb, S, R):
    """K4 takes a bucket exactly where the JAX package routes it to its
    fused kernel, and its block then fits a block's shared memory."""
    _, _, Rp, W = PP._kernel_dims(R, S)
    jax_fuses = PP._pick_tile_fused(Rp, W, Cb + 1) is not None
    assert TP.fits_fused(Cb, R, S) is jax_fuses
    if jax_fuses:
        assert TP._fused_smem_bytes(Cb, R, S) <= 232448


@pytest.mark.parametrize("fused,Cb,S,R,route", [
    (True, 64, 96, 8, "polish_fused"),
    (True, 32, 31, 8, "polish_fused"),
    (True, 96, 127, 8, "polish_fused"),
    (True, 160, 240, 8, "polish_fused"),
    (True, 1536, 2304, 8, "polish_score"),
    (False, 64, 96, 8, "polish_score"),
    (False, 32, 31, 3, "polish_score")])
def test_cuda_route(fused, Cb, S, R, route):
    assert TP.cuda_route(fused, Cb, R, S) == route


def _meta_inputs(B, Cb, R, S):
    m = dict(device="meta")
    return [torch.empty((B, Cb), dtype=torch.uint8, **m),
            torch.empty(B, dtype=torch.int32, **m),
            torch.empty((B, R, S), dtype=torch.uint8, **m),
            torch.empty((B, R), dtype=torch.int32, **m),
            torch.empty((B, R), dtype=torch.bool, **m),
            torch.empty((5, 5), dtype=torch.float32, **m)]


@pytest.mark.parametrize("fused,Cb,S,route", [
    (True, 64, 96, "polish_fused"), (True, 384, 576, "polish_score"),
    (False, 64, 96, "polish_score")])
def test_device_tensor_takes_its_kernel_route(monkeypatch, fused, Cb, S,
                                              route):
    """A tensor that is not on the CPU launches the routed kernel and
    raises when it cannot be built: it never reaches the plain version
    (meta tensors stand in for a device here)."""
    def no_lib(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}")

    def no_plain(*args):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(_cuda, "lib", no_lib)
    monkeypatch.setattr(TP, "_score_edits_raw", no_plain)
    with pytest.raises(RuntimeError, match=f"cannot build {route}$"):
        TP.score_edits_raw(*_meta_inputs(4, Cb, 8, S), fused=fused)


def test_fused_wrapper_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="outside K4's domain"):
        TP._score_edits_raw_fused_cuda(*_meta_inputs(2, 384, 8, 576))


def test_polish_bubbles_reads_flye_tpu_fused(monkeypatch):
    """`fused` defaults to whether FLYE_TPU_FUSED is set, as in the JAX
    package; the CPU climb gives the same result either way."""
    seen = []

    def spy(*args, fused=False):
        seen.append(fused)
        return TP._score_edits_raw(*args)
    monkeypatch.setattr(TP, "score_edits_raw", spy)
    args = _inputs(4, (4, 24, 3, 30))
    outs = []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("FLYE_TPU_FUSED", raising=False)
        else:
            monkeypatch.setenv("FLYE_TPU_FUSED", env)
        outs.append(TP.polish_bubbles(*args, max_iters=6, use_kernel=True,
                                      device="cpu"))
    assert seen and set(seen[:len(seen) // 2]) == {False}
    assert set(seen[len(seen) // 2:]) == {True}
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
