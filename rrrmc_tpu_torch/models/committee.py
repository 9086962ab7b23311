"""Two-layer binary committee machines with step, ReLU or quadratic hidden
units (the JAX package's rrrmc_tpu/models/committee.py; the reference's
CommStep.jl, CommReLU.jl and CommQu.jl), batch-explicit.

N = K1 K2 weights in K2 blocks of K1 (a hidden unit each) and P patterns:

    Delta1[k, a] = xi[a, block k] . sigma[block k]    (the aux, [B, K2, P])
    Delta2[a]    = sum_k c_k g(Delta1[k, a])          (g the activation)
    E            = #misclassified = sum_a loss(Delta2[a])

A flip of spin i in block k moves Delta1[k, a] by -2 sigma_i xi[a, i], so

    dE_i = (sum_a (Dm + Dp)[k(i), a] + sigma_i (xi^T (Dm - Dp))_i) / 2

with Dm / Dp[k, a] the loss change when Delta1[k, a] moves by -2 / +2:
two elementwise tables and one product give every flip cost.

* step: g = sign, loss = (Delta2 < 0), K1 and K2 odd, all labels +1;
* ReLU: g = max(., 0), loss = (y Delta2 <= 0), K1 and K2 even, c = +1 for
  the first half of the units and -1 for the rest, random labels y;
* quadratic: g = x^2, otherwise as ReLU.

CUDA has no int32 matrix product, so Delta1 and the product of `delta_all`
are float64 products cast back, as the perceptron's: every operand is +-1
or a small integer and every sum stays far below 2^53, so they are exact,
whatever torch's TF32 setting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dtypes import itype
from ..core.model import Model, default_device, flip_spin


@dataclasses.dataclass(frozen=True, eq=False)
class Committee(Model):
    xi: torch.Tensor   # [P, N] int8 +-1 patterns
    y: torch.Tensor    # [P] int8 +-1 labels (all +1 for step)
    c: torch.Tensor    # [K2] int8 +-1 output weights of the units
    N: int
    K1: int
    K2: int
    P: int
    kind: str = "step"
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.xi.device

    def _xi_blocks(self) -> torch.Tensor:
        """[P, K2, K1] float64 patterns."""
        return self.xi.to(torch.float64).view(self.P, self.K2, self.K1)

    def _g(self, d1):
        if self.kind == "step":
            return torch.sign(d1)
        if self.kind == "relu":
            return d1.clamp(min=0)
        return d1 * d1

    def _loss(self, d2):
        if self.kind == "step":
            return (d2 < 0).to(itype())
        return (self.y.to(itype()) * d2 <= 0).to(itype())

    def _d2(self, aux):
        """[B, P] output fields from Delta1 [B, K2, P]."""
        return (self.c.to(itype())[:, None] * self._g(aux)).sum(
            1, dtype=itype())

    def init_aux(self, sigma):
        """Delta1 [B, K2, P] int32."""
        s = sigma.to(torch.float64).view(-1, self.K2, self.K1)
        return torch.einsum("pkj,bkj->bkp", self._xi_blocks(), s).to(itype())

    def energy(self, sigma):
        return self._loss(self._d2(self.init_aux(sigma))).sum(
            -1, dtype=itype())

    def delta_all(self, sigma, aux):
        d2 = self._d2(aux)                                    # [B, P]
        l0 = self._loss(d2)[:, None]                          # [B, 1, P]
        ci = self.c.to(itype())[:, None]                      # [K2, 1]
        base = d2[:, None] - ci * self._g(aux)                # [B, K2, P]
        Dm = self._loss(base + ci * self._g(aux - 2)) - l0
        Dp = self._loss(base + ci * self._g(aux + 2)) - l0
        tot = (Dm + Dp).sum(-1, dtype=itype())                # [B, K2]
        proj = torch.einsum("pkj,bkp->bkj", self._xi_blocks(),
                            (Dm - Dp).to(torch.float64)).to(itype())
        s = sigma.to(itype()).view(-1, self.K2, self.K1)
        return torch.div(tot[..., None] + s * proj, 2,
                         rounding_mode="floor").reshape(-1, self.N)

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        k = torch.div(i, self.K1, rounding_mode="floor")
        d2 = self._d2(aux)
        ck = self.c[k].to(itype())[:, None]
        d1k = aux[rows, k]                                    # [B, P]
        step = (-2 * sigma[rows, i].to(itype()))[:, None] \
            * self.xi[:, i].t().to(itype())
        d2_new = d2 - ck * self._g(d1k) + ck * self._g(d1k + step)
        return (self._loss(d2_new) - self._loss(d2)).sum(-1, dtype=itype())

    def flip(self, sigma, aux, i, do):
        """Delta1's row k(i) of each chain with do moves by -2 sigma_i
        xi[:, i]: one indexed add over [B, K2, P]."""
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        k = torch.div(i, self.K1, rounding_mode="floor")
        upd = torch.where(do, -2 * sigma[rows, i].to(itype()), 0)
        aux.index_put_((rows, k), upd[:, None]
                       * self.xi[:, i].t().to(itype()), accumulate=True)
        return flip_spin(sigma, i, do), aux


def _gen_patterns(K1: int, K2: int, P: int, fc: bool, rng, labels: bool):
    """The JAX package's draw: P patterns of K1 K2 inputs (fc: K1 inputs
    every unit sees), then the labels (all +1 without `labels`)."""
    Kin = K1 if fc else K1 * K2
    xi = rng.choice([-1, 1], size=(P, Kin)).astype(np.int8)
    if fc:
        xi = np.tile(xi, (1, K2))
    y = (rng.choice([-1, 1], size=P).astype(np.int8) if labels
         else np.ones(P, dtype=np.int8))
    return xi, y


def _half_weights(K2: int) -> np.ndarray:
    """+1 for the first half of the units, -1 for the rest."""
    c = np.ones(K2, dtype=np.int8)
    c[K2 // 2:] = -1
    return c


def _build(kind, K1, K2, P, fc, seed, xi, y, device) -> Committee:
    odd = kind == "step"
    if (K1 % 2, K2 % 2) != ((1, 1) if odd else (0, 0)):
        raise ValueError(f"K1 and K2 must be {'odd' if odd else 'even'}, "
                         f"given: {K1}, {K2}")
    if xi is None:
        xi, y = _gen_patterns(K1, K2, P, fc, np.random.default_rng(seed),
                              not odd)
    if y is None:
        if not odd:
            raise ValueError("y is required with xi")
        y = np.ones(P, dtype=np.int8)
    xi, y = np.asarray(xi, dtype=np.int8), np.asarray(y, dtype=np.int8)
    if xi.shape != (P, K1 * K2) or y.shape != (P,):
        raise ValueError(f"expected xi {(P, K1 * K2)} and y {(P,)}, got "
                         f"{xi.shape}, {y.shape}")
    c = np.ones(K2, dtype=np.int8) if odd else _half_weights(K2)
    device = default_device(device)
    return Committee(xi=torch.tensor(xi, device=device),
                     y=torch.tensor(y, device=device),
                     c=torch.tensor(c, device=device), N=K1 * K2, K1=K1,
                     K2=K2, P=P, kind=kind)


def GraphCommStep(K1: int, K2: int, P: int, *, fc: bool = False, seed=None,
                  xi=None, y=None, device=None) -> Committee:
    """Committee of sign units (CommStep.jl), K1 and K2 odd, on `device`
    (CUDA when none is given)."""
    return _build("step", K1, K2, P, fc, seed, xi, y, device)


def GraphCommReLU(K1: int, K2: int, P: int, *, fc: bool = False, seed=None,
                  xi=None, y=None, device=None) -> Committee:
    """Committee of ReLU units with +-1 output weights and random labels
    (CommReLU.jl), K1 and K2 even."""
    return _build("relu", K1, K2, P, fc, seed, xi, y, device)


def GraphCommQu(K1: int, K2: int, P: int, *, fc: bool = False, seed=None,
                xi=None, y=None, device=None) -> Committee:
    """Committee of quadratic units (CommQu.jl), K1 and K2 even."""
    return _build("qu", K1, K2, P, fc, seed, xi, y, device)


# --- replica-ensemble aliases -----------------------------------------------

def _wrap(builder, wrapper_name, wargs, K1, K2, P, fc, seed, device):
    from . import replicas
    base = builder(K1, K2, P, fc=fc, seed=seed, device=device)
    return getattr(replicas, wrapper_name)(base.N, *wargs, base)


def GraphQCommStepT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommStep, "GraphQuant", (M, Gamma, beta), K1, K2, P,
                 fc, seed, device)


def GraphQCommReLUT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommReLU, "GraphQuant", (M, Gamma, beta), K1, K2, P,
                 fc, seed, device)


def GraphQCommQuT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None,
                  device=None):
    return _wrap(GraphCommQu, "GraphQuant", (M, Gamma, beta), K1, K2, P, fc,
                 seed, device)


def GraphCommStepRE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommStep, "GraphRobustEnsemble", (M, gamma, beta), K1,
                 K2, P, fc, seed, device)


def GraphCommReLURE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommReLU, "GraphRobustEnsemble", (M, gamma, beta), K1,
                 K2, P, fc, seed, device)


def GraphCommQuRE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                  device=None):
    return _wrap(GraphCommQu, "GraphRobustEnsemble", (M, gamma, beta), K1,
                 K2, P, fc, seed, device)


def GraphCommStepLE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommStep, "GraphLocalEntropy", (M, gamma, beta), K1,
                 K2, P, fc, seed, device)


def GraphCommReLULE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                    device=None):
    return _wrap(GraphCommReLU, "GraphLocalEntropy", (M, gamma, beta), K1,
                 K2, P, fc, seed, device)


def GraphCommQuLE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None,
                  device=None):
    return _wrap(GraphCommQu, "GraphLocalEntropy", (M, gamma, beta), K1, K2,
                 P, fc, seed, device)
