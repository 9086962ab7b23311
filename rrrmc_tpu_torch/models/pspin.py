"""3-spin regular hypergraph model (p-spin, p = 3), batch-explicit.

E = -sum over hyperedges (triangles) of sigma_x sigma_y sigma_z, every spin
in exactly K triangles (all couplings 1): the JAX package's
rrrmc_tpu/models/pspin.py (the reference's graphs/PSpin3.jl). A [N, K, 2]
holds the two partners of spin x in each of its triangles.

Auxiliary state: the cavity sum c_x = sum_k sigma_y sigma_z over x's K
triangles ([B, N] int32, `local_fields`), so that dE_x = 2 sigma_x c_x. A flip
of x changes c only at its 2K partners: the partner y of triangle (x, y, z)
gains -2 sigma_x sigma_z, an O(K) masked scatter-add (`flip_cavity`, which
the race and EO kernels' plain versions share). The JAX model recomputes the
cavity from the spins instead (aux-free); the values are the same. Energies
are exact int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.model import Model, default_device, flip_spin


def flip_cavity(A: torch.Tensor, sig: torch.Tensor, c: torch.Tensor,
                i: torch.Tensor, d: torch.Tensor, do: torch.Tensor):
    """Add the flip of spin i[b] (d[b] = -2 sigma_i) to the cavity sums c
    [B, N] in place, in the chains where do: for each triangle (i, y, z),
    c_y += d sigma_z and c_z += d sigma_y. sig [B, N] holds the spins (in c's
    dtype); a pair sharing two triangles gets both terms."""
    B = sig.shape[0]
    K = A.shape[1]
    part = A[i].long()                                  # [B, K, 2]
    other = sig.gather(1, part.flip(-1).reshape(B, 2 * K))
    upd = torch.where(do[:, None], d[:, None] * other, torch.zeros_like(other))
    c.scatter_add_(1, part.reshape(B, 2 * K), upd)
    return c


@dataclasses.dataclass(frozen=True, eq=False)
class PSpin3(Model):
    A: torch.Tensor   # [N, K, 2] int32, the two partners in each triangle
    N: int
    K: int
    scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.A.device

    def local_fields(self, sigma: torch.Tensor) -> torch.Tensor:
        """[B, N] cavity sums sum_k sigma_y sigma_z of `sigma` [B, N]."""
        s = sigma.to(torch.int32)
        A = self.A.long()
        c = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        for k in range(self.K):
            c += s[:, A[:, k, 0]] * s[:, A[:, k, 1]]
        return c

    def energy(self, sigma: torch.Tensor) -> torch.Tensor:
        s = sigma.to(torch.int32)
        tot = (s * self.local_fields(sigma)).sum(-1, dtype=torch.int32)
        return torch.div(-tot, 3, rounding_mode="floor")  # 3x each triangle

    def init_aux(self, sigma):
        return self.local_fields(sigma)

    def delta_all(self, sigma, aux):
        return 2 * sigma.to(torch.int32) * aux

    def delta_one(self, sigma, aux, i):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        return 2 * sigma[rows, i].to(torch.int32) * aux[rows, i]

    def flip(self, sigma, aux, i, do):
        rows = torch.arange(sigma.shape[0], device=sigma.device)
        d = -2 * sigma[rows, i].to(torch.int32)
        flip_cavity(self.A, sigma.to(torch.int32), aux, i, d, do)
        flip_spin(sigma, i, do)
        return sigma, aux

    def delta_classes(self):
        K = self.K
        if K % 2 == 0:
            return tuple(float(4 * d) for d in range(K // 2 + 1))
        return tuple(float(2 * (2 * d - 1))
                     for d in range(1, (K + 1) // 2 + 1))


def pspin_tables(N: int, K: int, seed=None) -> np.ndarray:
    """[N, K, 2] int32 partner table of K random perfect triangle partitions
    (PSpin3.jl:21-53): the JAX builder's permutations, in its order."""
    rng = np.random.default_rng(seed)
    A = np.zeros((N, K, 2), dtype=np.int32)
    for k in range(K):
        v1, v2, v3 = rng.permutation(N).reshape(-1, 3).T
        A[v1, k] = np.stack([v2, v3], axis=1)
        A[v2, k] = np.stack([v1, v3], axis=1)
        A[v3, k] = np.stack([v1, v2], axis=1)
    return A


def GraphPSpin3(N: int, K: int, *, seed=None, device=None) -> PSpin3:
    """Random 3-spin regular hypergraph: K random perfect triangle partitions.
    N must be divisible by 3. The table goes to `device`, CUDA when none is
    given."""
    assert K >= 1
    if N % 3 != 0:
        raise ValueError(f"N must be divisible by 3, given: {N}")
    A = torch.as_tensor(pspin_tables(N, K, seed), device=default_device(device))
    return PSpin3(A=A, N=N, K=K)
