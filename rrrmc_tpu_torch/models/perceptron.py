"""Single-layer binary perceptrons (Step / Linear / XEntr losses),
batch-explicit: the JAX package's rrrmc_tpu/models/perceptron.py (the
reference's graphs/PercStep.jl, PercLinear.jl and PercXEntr.jl).

Patterns xi [P, N] are +-1 (they absorb the labels); N is odd, so every
stability Delta_a = xi_a . sigma is odd and never 0. The loss of a pattern is
a function of its stability, read from a table of the N + 1 values
Delta = -N, -N + 2, ..., N:

* Step:   E = #(Delta < 0)                         [int32, scale 1]
* Linear: E = sum_{Delta < 0} ((-Delta - 1) / 2 + 1) [int32, scale 2/sqrt(N)]
* XEntr:  E = sum_a log(1 + exp(-2 lam Delta / sqrt(N)))          [float32]

aux = the stabilities [B, P] int32. A flip of spin i moves every stability by
-2 sigma_i xi[:, i] (`flip`), so the energy change of each flip comes from one
product (`delta_all`):

    dE_i = (tot + sigma_i (xi^T g)_i) / 2,
    g_a = gm_a - gp_a,  tot = sum_a (gm_a + gp_a),

gm_a = loss(Delta_a - 2) - loss(Delta_a) and gp_a the +2 shift. The race and
EO kernels (ops/perc.py, ops/eo_perc.py) compute gm and gp elementwise
instead of from the table.

CUDA has no int32 matrix product, so the stabilities and the product of
`delta_all` are float64 products cast back: every operand is +-1 or a small
integer and every sum stays far below 2^53, so they are exact, whatever
torch's TF32 setting (which touches float32 products only).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dtypes import is_integer, itype
from ..core.model import Model, default_device, flip_spin


def gen_xi(N: int, P: int, rng) -> np.ndarray:
    """P random +-1 patterns (gen_xi, PercStep.jl:18-28): the JAX package's
    draw, so one seed gives the same patterns in both packages."""
    return rng.choice([-1, 1], size=(P, N)).astype(np.int8)


@dataclasses.dataclass(frozen=True, eq=False)
class Perceptron(Model):
    """Shared machinery; `loss_table[(Delta + N) // 2]` gives the per-pattern
    loss in internal units (int32 for step and linear, float32 for
    xentr)."""
    xi: torch.Tensor          # [P, N] int8 +-1 patterns
    loss_table: torch.Tensor  # [N + 1] loss at Delta = -N, -N + 2, ..., N
    N: int
    P: int
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.xi.device

    def _loss(self, delta):
        """The table at the stabilities `delta`, indexed as the JAX package
        indexes it: an index below 0 counts from the end, one above N is
        clamped to N (only the +-2 shifts of delta_all reach them, and
        there they cancel)."""
        idx = (delta + self.N) >> 1
        idx = torch.where(idx < 0, idx + (self.N + 1), idx).clamp(
            0, self.N)
        return self.loss_table[idx.long()]

    def stabilities(self, sigma) -> torch.Tensor:
        """[B, P] int32 stabilities xi . sigma of the spins sigma [B, N]."""
        return (sigma.to(torch.float64) @ self.xi.to(torch.float64).t()
                ).to(itype())

    def energy_of(self, delta) -> torch.Tensor:
        """[B] energies from the stabilities delta [B, P]."""
        loss = self._loss(delta)
        return loss.sum(-1, dtype=loss.dtype)

    def energy(self, sigma):
        return self.energy_of(self.stabilities(sigma))

    def init_aux(self, sigma):
        return self.stabilities(sigma)

    def delta_all(self, sigma, aux):
        lo = self._loss(aux)
        gm = self._loss(aux - 2) - lo    # pattern loses alignment
        gp = self._loss(aux + 2) - lo    # pattern gains alignment
        tot = (gm + gp).sum(-1, dtype=lo.dtype)
        proj = ((gm - gp).to(torch.float64) @ self.xi.to(torch.float64)
                ).to(lo.dtype)
        half = sigma.to(lo.dtype) * proj
        if is_integer(lo):
            return torch.div(tot[:, None] + half, 2, rounding_mode="floor")
        return (tot[:, None] + half) / 2

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        step = (-2 * sigma[rows, i].to(itype()))[:, None] \
            * self.xi[:, i].t().to(itype())
        d = self._loss(aux + step) - self._loss(aux)
        return d.sum(-1, dtype=d.dtype)

    def flip(self, sigma, aux, i, do):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        upd = torch.where(do, -2 * sigma[rows, i].to(itype()), 0)
        aux += upd[:, None] * self.xi[:, i].t().to(itype())
        return flip_spin(sigma, i, do), aux


def _delta_grid(N: int) -> np.ndarray:
    return np.arange(-N, N + 1, 2)


def _build(N: int, P: int, seed, xi, table, scale: float,
           device) -> Perceptron:
    if N % 2 != 1:
        raise ValueError(f"N must be odd, given: {N}")
    if xi is None:
        xi = gen_xi(N, P, np.random.default_rng(seed))
    xi = np.asarray(xi, dtype=np.int8)
    if xi.shape != (P, N):
        raise ValueError(f"xi must be [P, N] = {(P, N)}, got {xi.shape}")
    device = default_device(device)
    return Perceptron(xi=torch.tensor(xi, device=device),
                      loss_table=torch.tensor(table, device=device), N=N,
                      P=P, scale=float(scale))


def GraphPercStep(N: int, P: int, *, seed=None, xi=None,
                  device=None) -> Perceptron:
    """E = number of misclassified patterns (PercStep.jl:62-72). The tables
    go to `device`, CUDA when none is given."""
    table = (_delta_grid(N) < 0).astype(np.int32)
    return _build(N, P, seed, xi, table, 1.0, device)


def GraphPercLinear(N: int, P: int, *, seed=None, xi=None,
                    device=None) -> Perceptron:
    """E = sum over violated patterns of the number of weight flips needed
    to satisfy them, times 2/sqrt(N) (PercLinear.jl:62-72); exact int32
    internally."""
    d = _delta_grid(N)
    table = np.where(d < 0, (-d - 1) // 2 + 1, 0).astype(np.int32)
    return _build(N, P, seed, xi, table, 2.0 / np.sqrt(N), device)


def GraphPercXEntr(N: int, P: int, lam: float, *, seed=None, xi=None,
                   device=None) -> Perceptron:
    """Cross-entropy loss log(1 + exp(-2 lam Delta / sqrt(N))) through the
    table (PercXEntr.jl:66, 97-119), computed in float64 and stored as
    float32, as the JAX package stores it without x64."""
    d = _delta_grid(N).astype(np.float64)
    table = np.log1p(np.exp(-2.0 * lam * d / np.sqrt(N))).astype(np.float32)
    return _build(N, P, seed, xi, table, 1.0, device)


# --- replica-ensemble aliases ----------------------------------------------

def GraphQPercStepT(N, P, M, Gamma, beta, *, seed=None, device=None):
    from .replicas import GraphQuant
    return GraphQuant(N, M, Gamma, beta,
                      GraphPercStep(N, P, seed=seed, device=device))


def GraphQPercLinearT(N, P, M, Gamma, beta, *, seed=None, device=None):
    from .replicas import GraphQuant
    return GraphQuant(N, M, Gamma, beta,
                      GraphPercLinear(N, P, seed=seed, device=device))


def GraphPercStepRE(N, P, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(N, M, gamma, beta,
                               GraphPercStep(N, P, seed=seed, device=device))


def GraphPercLinearRE(N, P, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(
        N, M, gamma, beta, GraphPercLinear(N, P, seed=seed, device=device))


def GraphPercStepLE(N, P, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(N, M, gamma, beta,
                             GraphPercStep(N, P, seed=seed, device=device))


def GraphPercLinearLE(N, P, M, gamma, beta, *, seed=None, device=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(
        N, M, gamma, beta, GraphPercLinear(N, P, seed=seed, device=device))
