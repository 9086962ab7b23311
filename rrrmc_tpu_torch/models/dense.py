"""Dense fully-connected models: Sherrington-Kirkpatrick and friends (the JAX
package's rrrmc_tpu/models/dense.py), batch-explicit.

    E = -1/2 sigma^T J sigma - h . sigma,   J symmetric with a zero diagonal

The local fields lf = sigma J + h of a [B, N] batch are one matrix product,
and a flip of spin i adds -2 sigma_i J[i] to its chain's row of lf (an O(N)
in-place update).

Integer J (int8 or int32, the +-1 SK case) keeps exact int32 local fields and
energies with a static `scale` to physical units. CUDA has no integer matrix
product, so the integer product is taken in float64 and cast back, exact
while every |lf| stays below 2^53. The JAX package's `mm_bf16` flag, a TPU
matmul choice, is not carried over. Float J is float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.dtypes import ftype, is_integer, itype
from ..core.model import Model, default_device, flip_spin


@dataclasses.dataclass(frozen=True, eq=False)
class FullyConnected(Model):
    J: torch.Tensor  # [N, N] symmetric, zero diagonal: int8, int32 or float32
    h: torch.Tensor  # [N] int32 (integer J) or float32
    N: int
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.J.device

    @property
    def acc_dtype(self) -> torch.dtype:
        """int32 for integer J (int8 storage widens), else J's float."""
        return itype() if is_integer(self.J) else self.J.dtype

    def local_fields(self, sigma: torch.Tensor) -> torch.Tensor:
        """[B, N] local fields sigma J + h (J is symmetric)."""
        if is_integer(self.J):
            lf = (sigma.to(torch.float64) @ self.J.to(torch.float64)).to(
                itype())
        else:
            lf = sigma.to(self.J.dtype) @ self.J
        return lf + self.h

    def energy(self, sigma: torch.Tensor) -> torch.Tensor:
        acc = self.acc_dtype
        s = sigma.to(acc)
        quad = (s * (self.local_fields(sigma) - self.h)).sum(-1, dtype=acc)
        if is_integer(self.J):
            # exact: J symmetric with a zero diagonal, so quad is even
            quad = torch.div(quad, 2, rounding_mode="floor")
        else:
            quad = quad / 2
        return -(quad + (s * self.h).sum(-1, dtype=acc))

    def init_aux(self, sigma):
        return self.local_fields(sigma)

    def delta_all(self, sigma, aux):
        return 2 * sigma.to(self.acc_dtype) * aux

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        return 2 * sigma[rows, i].to(self.acc_dtype) * aux[rows, i]

    def flip(self, sigma, aux, i, do):
        acc = self.acc_dtype
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        s_i = sigma[rows, i].to(acc)
        d = torch.where(do, -2 * s_i, torch.zeros_like(s_i))
        aux.add_(d[:, None] * self.J[i].to(acc))
        flip_spin(sigma, i, do)
        return sigma, aux

    # host-side properties of the couplings, computed once per model (the
    # kernels' eligibility and tables need them)

    @functools.cached_property
    def j_max(self) -> float:
        """max |J| (in float64, so int8's -128 counts as 128)."""
        return max(float(self.J.max()), -float(self.J.min()))

    @functools.cached_property
    def half_max(self) -> float:
        """The largest |sigma_i lf_i| any configuration can reach: the
        largest row sum of |J| plus |h| (summed in float64, 1024 rows at a
        time)."""
        rows = torch.cat([self.J[lo:lo + 1024].to(torch.float64).abs().sum(1)
                          for lo in range(0, self.N, 1024)])
        return float((rows + self.h.to(torch.float64).abs()).max())

    @functools.cached_property
    def max_degree(self) -> int:
        """The most non-zero couplings of any spin."""
        return int((self.J != 0).sum(dim=1).max())


def _sym_zero_diag(J: np.ndarray) -> np.ndarray:
    J = np.triu(J, 1)
    return J + J.T


def dense_tensors(J: np.ndarray, h: np.ndarray, *, scale: float,
                  device=None) -> FullyConnected:
    """FullyConnected from J [N, N] and h [N] already in internal units:
    int8 J stays int8, other integer J is stored as int32 (h as int32), float
    J and h as float32; on `device`, CUDA when none is given."""
    J, h = np.asarray(J), np.asarray(h)
    n = J.shape[0]
    if J.shape != (n, n) or h.shape != (n,):
        raise ValueError(f"expected J {(n, n)} and h {(n,)}, got {J.shape} "
                         f"and {h.shape}")
    integer = np.issubdtype(J.dtype, np.integer)
    if integer != np.issubdtype(h.dtype, np.integer):
        raise ValueError("J and h must both be integer or both be float")
    device = default_device(device)
    if integer:
        jt = torch.int8 if J.dtype == np.int8 else itype()
        return FullyConnected(J=torch.tensor(J, device=device).to(jt),
                              h=torch.tensor(h, device=device).to(itype()),
                              N=n, scale=float(scale))
    return FullyConnected(J=torch.tensor(J, device=device).to(ftype()),
                          h=torch.tensor(h, device=device).to(ftype()),
                          N=n, scale=float(scale))


def GraphSK(N: int, *, seed=None, device=None) -> FullyConnected:
    """SK with binary couplings +-1/sqrt(N): int32 J with scale 1/sqrt(N),
    the JAX package's draw (the same seed gives the same J)."""
    rng = np.random.default_rng(seed)
    J = _sym_zero_diag(rng.choice([-1, 1], size=(N, N)).astype(np.int32))
    return dense_tensors(J, np.zeros(N, np.int32), scale=1.0 / np.sqrt(N),
                         device=device)


def GraphSKNormal(N: int, *, seed=None, device=None) -> FullyConnected:
    """SK with Gaussian couplings N(0, 1/N), float32, the JAX package's
    draw."""
    rng = np.random.default_rng(seed)
    J = _sym_zero_diag(rng.standard_normal((N, N)) / np.sqrt(N))
    return dense_tensors(J, np.zeros(N), scale=1.0, device=device)


def densify(model, *, device=None) -> FullyConnected:
    """Sparse Pairwise -> FullyConnected with the same physical energies: J
    as a symmetric [N, N] matrix, int8 when the integer couplings fit (the
    scale is kept, so energies stay exact), else int32; float couplings are
    float32 in physical units. The result lies on the model's device unless
    `device` is given. Memory is O(N^2)."""
    from .pairwise import Pairwise

    if not isinstance(model, Pairwise):
        raise ValueError(f"densify needs a Pairwise model, got "
                         f"{type(model).__name__}")
    if float(model.offset) != 0.0:
        raise ValueError("a constant energy offset has no place in "
                         "FullyConnected")
    n = model.N
    neigh = model.neigh.cpu().numpy().astype(np.int64)
    Jt = model.J.cpu().numpy().astype(np.float64)
    rows = np.repeat(np.arange(n), neigh.shape[1])
    cols = neigh.reshape(-1)
    keep = cols < n
    dense = np.zeros((n, n), dtype=np.float64)
    np.add.at(dense, (rows[keep], cols[keep]), Jt.reshape(-1)[keep])
    if not np.allclose(dense, dense.T):
        raise ValueError("the adjacency must be symmetric")
    np.fill_diagonal(dense, 0.0)
    h = model.h.cpu().numpy()
    device = model.device if device is None else device
    if is_integer(model.J):
        di = np.round(dense).astype(np.int64)
        dt = np.int8 if np.abs(di).max(initial=0) <= 127 else np.int32
        return dense_tensors(di.astype(dt), h.astype(np.int32),
                             scale=model.scale, device=device)
    return dense_tensors(dense * model.scale,
                         h.astype(np.float64) * model.scale, scale=1.0,
                         device=device)


def make_fully_connected(J, h=None, *, scale: Optional[float] = None,
                         device=None) -> FullyConnected:
    """FullyConnected from an explicit symmetric coupling matrix (its
    diagonal is zeroed); `scale` marks J and h as exact integer multiples of
    it, stored as int32 (exact energies); None stores float32."""
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[0]
    if J.shape != (n, n) or not np.allclose(J, J.T):
        raise ValueError("J must be a symmetric square matrix")
    J = J - np.diag(np.diag(J))
    hv = np.zeros(n) if h is None else np.asarray(h, dtype=np.float64)
    if scale is None:
        return dense_tensors(J, hv, scale=1.0, device=device)
    Ji = np.round(J / scale).astype(np.int32)
    hi = np.round(hv / scale).astype(np.int32)
    if not (np.allclose(Ji * scale, J, atol=1e-12)
            and np.allclose(hi * scale, hv, atol=1e-12)):
        raise ValueError("couplings or fields not on the integer grid")
    return dense_tensors(Ji, hi, scale=scale, device=device)
