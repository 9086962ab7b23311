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


def port_model(jm):
    """The port's Pairwise with the JAX model's exact tables."""
    return pt.pairwise_from_arrays(
        np.asarray(jm.neigh), np.asarray(jm.J), np.asarray(jm.h),
        np.asarray(jm.offset), N=jm.N, K=jm.K, scale=jm.scale,
        classes=jm.classes)


def port_lattice(jm):
    """The port's LatticeEA with the JAX LatticeEA's couplings and fields."""
    return pt.lattice_from_arrays(np.asarray(jm.Jd), np.asarray(jm.h), jm.L,
                                  jm.D, jm.scale, jm.classes)


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
