"""Helpers of the tests that hold the PyTorch port (rrrmc_tpu_torch) against
the JAX package: carrying models across, and the random bits the JAX Pallas
kernels draw in interpret mode, so both sides run on identical bits."""

from __future__ import annotations

import importlib
import os
from contextlib import contextmanager

import numpy as np
import torch

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import prng

#: rrrmc_tpu/ops/prng.py's GOLD and per-kernel salt multiplier
_GOLD = -1640531527
_SALT_MUL = 1000003
#: the port's builders and samplers run on the card unless asked: the CPU
#: tests ask for the host
CPU = {"device": "cpu"}


def host(mod) -> dict:
    """Keywords that put a builder of `mod` on the CPU: device="cpu" for
    the port, none for the JAX package."""
    return CPU if mod is pt else {}


def port_model(jm):
    """The port's Pairwise with the JAX model's exact tables."""
    return pt.pairwise_from_arrays(
        np.asarray(jm.neigh), np.asarray(jm.J), np.asarray(jm.h),
        np.asarray(jm.offset), N=jm.N, K=jm.K, scale=jm.scale,
        classes=jm.classes, device="cpu")


def port_lattice(jm):
    """The port's LatticeEA with the JAX LatticeEA's couplings and fields."""
    return pt.lattice_from_arrays(np.asarray(jm.Jd), np.asarray(jm.h), jm.L,
                                  jm.D, jm.scale, jm.classes, device="cpu")


def port_pspin(jm):
    """The port's PSpin3 with the JAX model's partner table."""
    return pt.pspin_from_arrays(np.asarray(jm.A), jm.N, jm.K, device="cpu")


def port_sat(jm):
    """The port's SATModel with the JAX model's clauses."""
    return pt.sat_from_arrays(jm.N, np.asarray(jm.A), np.asarray(jm.L),
                              device="cpu")


def port_perceptron(jm):
    """The port's Perceptron with the JAX model's patterns and loss table
    (a float64 table of an x64 run is stored as float32)."""
    return pt.perceptron_from_arrays(np.asarray(jm.xi),
                                     np.asarray(jm.loss_table), N=jm.N,
                                     P=jm.P, scale=jm.scale, device="cpu")


def port_composite(jm):
    """The port's composite over the JAX base's exact tables."""
    jb = jm.resid_m.base
    if hasattr(jb, "neigh"):
        base = port_model(jb)
    else:
        base = pt.fully_connected_from_arrays(np.asarray(jm.resid_m.base.J),
                                              np.asarray(jb.h),
                                              scale=jb.scale, **CPU)
    if type(jm).__name__ == "QuantModel":
        return pt.replica_from_arrays("quant", base, M=jm.M,
                                      coupling=jm.Gamma, beta=jm.beta)
    return pt.replica_from_arrays("re", base, M=jm.M,
                                  coupling=jm.inner_m.gamma,
                                  beta=jm.inner_m.beta_p)


def random_sigma(rng: np.random.Generator, B: int, N: int) -> np.ndarray:
    return (rng.integers(0, 2, (B, N)) * 2 - 1).astype(np.int8)


def _fmix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def interpret_bits(shape, salt: int) -> np.ndarray:
    """numpy copy of rrrmc_tpu/ops/prng.py::random_bits in interpret mode:
    int32 bits of a 2-D `shape` for an int32 `salt`."""
    with np.errstate(over="ignore"):
        i0 = np.arange(shape[0], dtype=np.uint32)[:, None]
        i1 = np.arange(shape[1], dtype=np.uint32)[None, :]
        s = np.uint32(np.int64(salt) & 0xFFFFFFFF)
        x = (i0 * np.uint32(0x9E3779B1) + i1 * np.uint32(0x85EBCA77)
             + _fmix(s * np.uint32(0xC2B2AE3D) + np.uint32(0x27D4EB2F)))
        return _fmix(x).view(np.int32)


def _salt0(seed: int) -> int:
    """seed_p * 1000003 in int32 arithmetic, seed_p = program_seed(seed, 0)."""
    wrap = lambda v: (v + 2 ** 31) % 2 ** 32 - 2 ** 31  # noqa: E731
    return wrap(wrap(seed * _GOLD) * _SALT_MUL)


def site_bits(seed: int, B: int):
    """bits(m, draw) of the JAX site kernel (one block of B chains): salt
    salt0 + m, row 0 of a [1, B] draw."""
    s0 = _salt0(seed)
    return lambda m, d: torch.from_numpy(
        interpret_bits((1, B), s0 + m)[0].copy())


def race_bits(seed: int, B: int, N: int, NP: int, skip_salt: int = 2):
    """bits(m, draw) of the JAX sparse race kernel (one block of B chains):
    salts 3m (race, [NP, B] sliced to the N physical rows and transposed to
    the port's [B, N]), 3m + 1 (rrr accept) and 3m + skip_salt (bkl skip)."""
    s0 = _salt0(seed)

    def bits(m, d):
        if d == 0:
            b = interpret_bits((NP, B), s0 + 3 * m)[:N].T
        else:
            off = skip_salt if d == prng.DRAW_SKIP else d
            b = interpret_bits((1, B), s0 + 3 * m + off)[0]
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def lattice_race_bits(seed: int, B: int, N: int):
    """bits(m, draw) of the JAX lattice race kernel (`_rejfree_kernel`): as
    the sparse kernel's with NP = N, but its bkl skip is drawn at salt
    3m + 1, the rrr acceptance's salt (the two modes never share a move)."""
    return race_bits(seed, B, N, N, skip_salt=1)


def sweep_bits(seed: int, B: int, N: int):
    """bits(sweep, colour) of the JAX checkerboard sweep kernel (one block
    of B chains): salt salt0 + 2 * sweep + colour, one [N, B] draw per
    colour step, transposed to the port's [B, N]."""
    s0 = _salt0(seed)
    return lambda sw, c: torch.from_numpy(np.ascontiguousarray(
        interpret_bits((N, B), s0 + 2 * sw + c).T))


def sk_bits(seed: int, B: int, N: int, W: int = 128):
    """bits(sweep, window) of the JAX dense sweep kernel (one block of B
    chains, both its variants): salt salt0 + sweep * n_win + w, one [W, B]
    draw per window (rows past N belong to padding spins), transposed to the
    port's [B, W]."""
    s0 = _salt0(seed)
    n_win = -(-N // W)
    return lambda sw, w: torch.from_numpy(np.ascontiguousarray(
        interpret_bits((W, B), s0 + sw * n_win + w).T))


def dense_race_bits(seed: int, B: int, N: int, NP: int):
    """bits(m, draw) of the JAX dense race kernel (`_rejfree_dense_kernel`):
    the race at salt 3m, a [NP, B] draw sliced to the N physical rows; the
    rrr acceptance and the bkl skip both at salt 3m + 1."""
    return race_bits(seed, B, N, NP, skip_salt=1)


def stream_race_bits(seed: int, B: int, N: int, NP: int, W: int):
    """bits(m, draw) of the JAX streamed race kernel
    (`_rejfree_stream_kernel`): move m draws from msalt = salt0 +
    m * (n_blk + 2), n_blk = NP // W; race block w at msalt + w, one [W, B]
    draw each, stacked and sliced to the N physical rows; the rrr acceptance
    and the bkl skip both at msalt + n_blk."""
    s0 = _salt0(seed)
    n_blk = NP // W

    def bits(m, d):
        msalt = s0 + m * (n_blk + 2)
        if d == prng.DRAW_RACE:
            b = np.concatenate([interpret_bits((W, B), msalt + w)
                                for w in range(n_blk)])[:N].T
        else:
            b = interpret_bits((1, B), msalt + n_blk)[0]
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def eo_bits(seed: int, B: int, N: int):
    """bits(m, draw) of the JAX EO kernels (one block of B chains; the
    lattice, dense, streamed and sparse variants draw alike): the rank at
    salt salt0 + 2m, a [1, B] draw, and the tie race at salt0 + 2m + 1, an
    [NP, B] draw whose N physical rows are transposed to the port's
    [B, N] (a row's bits do not depend on NP)."""
    s0 = _salt0(seed)

    def bits(m, d):
        if d == prng.DRAW_EO_RANK:
            b = interpret_bits((1, B), s0 + 2 * m)[0]
        else:
            b = interpret_bits((N, B), s0 + 2 * m + 1).T
        return torch.from_numpy(np.ascontiguousarray(b))

    return bits


def jax_random_bits(jprng, shape, salt: int) -> np.ndarray:
    """rrrmc_tpu/ops/prng.py::random_bits(shape, salt) drawn inside a
    one-step Pallas kernel, `jprng` that module reloaded in interpret mode
    (`pallas_interpret`): what a JAX kernel draws at that salt."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    s32 = int(np.array(salt & 0xFFFFFFFF, np.uint32).view(np.int32))

    def kernel(o_ref):
        o_ref[...] = jprng.random_bits(shape, jnp.int32(s32))

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        interpret=jprng.interpret_params())())


@contextmanager
def pallas_interpret(*modules):
    """RRRMC_PALLAS_INTERPRET=1 with the given JAX modules reloaded (as the
    JAX package's own kernel tests do), restored afterwards."""
    old = os.environ.get("RRRMC_PALLAS_INTERPRET")
    os.environ["RRRMC_PALLAS_INTERPRET"] = "1"
    mods = [importlib.reload(importlib.import_module(m)) for m in modules]
    try:
        yield mods
    finally:
        if old is None:
            os.environ.pop("RRRMC_PALLAS_INTERPRET")
        else:
            os.environ["RRRMC_PALLAS_INTERPRET"] = old
        for m in modules:
            importlib.reload(importlib.import_module(m))
