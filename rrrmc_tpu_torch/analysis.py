"""Exact-enumeration validation and mixing-time tools (the JAX package's
`rrrmc_tpu/analysis.py`, after RRRMC.jl's truep, second_eigenvalue_*, tm
and ravg): the exact 2^N Boltzmann distribution and the dense transition
matrices of the Metropolis, BKL and rrr kernels, for stationarity checks and
mixing-time comparisons at small N. Everything derives from one batched
energy pass over all 2^N states; the rest is numpy on the host.

State encoding matches observables.pack_config: bit j of the state id is
(sigma_j + 1) / 2.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .observables import unpack_config

#: states per batched energy pass of energy_table
_BLOCK = 1 << 16


def energy_table(model, max_N: int = 24) -> np.ndarray:
    """[2^N] physical energies of every configuration."""
    n = model.N
    if n > max_N:
        raise ValueError(f"N={n} too large for exact enumeration")
    out = np.empty(1 << n, dtype=np.float64)
    for lo in range(0, 1 << n, _BLOCK):
        hi = min(lo + _BLOCK, 1 << n)
        ids = torch.arange(lo, hi, dtype=torch.int64, device=model.device)
        E = model.to_physical(model.energy(unpack_config(ids, n)))
        out[lo:hi] = E.double().cpu().numpy()
    return out


def truep(model, beta: float) -> np.ndarray:
    """Exact Boltzmann distribution."""
    E = energy_table(model)
    w = np.exp(-beta * (E - E.min()))
    return w / w.sum()


def _flip_ids(n: int) -> np.ndarray:
    """[S, N] state id after flipping each spin."""
    s = np.arange(1 << n, dtype=np.int64)[:, None]
    return s ^ (np.int64(1) << np.arange(n, dtype=np.int64))[None, :]


def transition_matrix_standard(model, beta: float) -> np.ndarray:
    """Dense single-spin Metropolis kernel Q[to, from]."""
    n = model.N
    E = energy_table(model)
    flips = _flip_ids(n)
    dE = E[flips] - E[:, None]                      # [S, N]
    p = np.minimum(1.0, np.exp(-beta * dE)) / n
    S = 1 << n
    Q = np.zeros((S, S))
    np.add.at(Q, (flips.ravel(), np.repeat(np.arange(S), n)), p.ravel())
    Q[np.arange(S), np.arange(S)] = 1.0 - p.sum(axis=1)
    return Q


def transition_matrix_bkl(Q: np.ndarray) -> np.ndarray:
    """Rejection-free chain embedded in Q: strip the diagonal, renormalise
    the columns."""
    pr = np.diag(Q).copy()
    return (Q - np.diag(pr)) / (1.0 - pr[None, :])


def transition_matrix_rrr(model, beta: float) -> np.ndarray:
    """rrr kernel: move j proposed with probability w_j / z and accepted
    with min(1, z / z'); combined pp = w_j / max(z, z')."""
    n = model.N
    E = energy_table(model)
    flips = _flip_ids(n)
    dE = E[flips] - E[:, None]
    w = np.minimum(1.0, np.exp(-beta * dE))         # [S, N]
    z = w.sum(axis=1)                               # [S]
    pp = w / np.maximum(z[:, None], z[flips])       # z[flips]: flipped z'
    S = 1 << n
    Q = np.zeros((S, S))
    np.add.at(Q, (flips.ravel(), np.repeat(np.arange(S), n)), pp.ravel())
    Q[np.arange(S), np.arange(S)] = np.clip(1.0 - pp.sum(axis=1), 0.0, 1.0)
    return Q


def second_eigenvalue(Q: np.ndarray) -> float:
    """Mixing time tau = -1 / log(lambda_2)."""
    ev = np.linalg.eigvals(Q)
    if np.any(np.abs(ev.imag) > 1e-8):
        raise ValueError("non-real eigenvalue")
    lam2 = np.sort(ev.real)[-2]
    return -1.0 / np.log(lam2)


def stationarity_error(Q: np.ndarray, p: np.ndarray) -> float:
    """max |p - Qp|: ~1e-13 for a correct kernel."""
    return float(np.max(np.abs(p - Q @ p)))


def rejection_rate(Q: np.ndarray, p: np.ndarray) -> float:
    """Equilibrium rejection probability sum_x p(x) Q[x, x]."""
    return float(np.sum(np.diag(Q) * p))


def spectral_stats(graph_builder, betas: Sequence[float], n_seeds: int = 10,
                   seed: int = 86823, quiet: bool = True):
    """Mixing times of the standard / bkl / rrr kernels over disorder
    samples. Returns (taus [n_seeds, n_betas, 3], rrs [n_seeds, n_betas,
    3]); the bkl chain never rejects, so its rejection rate stays 0."""
    taus = np.zeros((n_seeds, len(betas), 3))
    rrs = np.zeros((n_seeds, len(betas), 3))
    for j in range(n_seeds):
        X = graph_builder(seed=seed + j)
        for l, beta in enumerate(betas):
            p = truep(X, beta)
            Q = transition_matrix_standard(X, beta)
            if stationarity_error(Q, p) >= 1e-12:
                raise AssertionError("Metropolis kernel is not stationary")
            taus[j, l, 0] = second_eigenvalue(Q)
            rrs[j, l, 0] = rejection_rate(Q, p)
            taus[j, l, 1] = second_eigenvalue(transition_matrix_bkl(Q))
            Qr = transition_matrix_rrr(X, beta)
            if stationarity_error(Qr, p) >= 1e-12:
                raise AssertionError("rrr kernel is not stationary")
            taus[j, l, 2] = second_eigenvalue(Qr)
            rrs[j, l, 2] = rejection_rate(Qr, p)
            if not quiet:
                print(f"seed={seed + j} beta={beta}: tau={taus[j, l]}, "
                      f"rr={rrs[j, l]}")
    return taus, rrs


def tm(Es: np.ndarray, step: int = 1, skip0: float = 0.1,
       skip1: float = 0.05) -> np.ndarray:
    """Cumulative running mean of an energy series after a skip0 burn-in,
    dropping the first skip1 fraction of points."""
    Es = np.asarray(Es, dtype=np.float64)
    i0 = int(np.floor(len(Es) * skip0))
    n = (len(Es) - i0) // step
    blocks = Es[i0:i0 + n * step].reshape(n, step).mean(axis=1)
    m = np.cumsum(blocks) / np.arange(1, n + 1)
    return m[int(np.floor(skip1 * n)):]


def ravg(Es: np.ndarray, step: int = 1000, skip0: float = 0.0) -> np.ndarray:
    """Non-overlapping block means."""
    Es = np.asarray(Es, dtype=np.float64)
    i0 = int(np.floor(len(Es) * skip0))
    n = (len(Es) - i0) // step
    return Es[i0:i0 + n * step].reshape(n, step).mean(axis=1)
