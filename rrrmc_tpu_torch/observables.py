"""Observable helpers over spin batches (the JAX package's
`rrrmc_tpu/observables.py`): magnetization, the packed state ids of exact
enumeration, and overlaps."""

from __future__ import annotations

import torch


def magnetization(sigma: torch.Tensor) -> torch.Tensor:
    """Mean magnetization per spin; sigma [..., N]."""
    return sigma.to(torch.float32).mean(dim=-1)


def pack_config(sigma: torch.Tensor) -> torch.Tensor:
    """Pack an N <= 30 spin vector into one int32 state id: bit j is
    (sigma_j + 1) / 2 (used by exact enumeration)."""
    n = sigma.shape[-1]
    bits = (sigma > 0).to(torch.int32)
    shifts = torch.arange(n, dtype=torch.int32, device=sigma.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32)


def unpack_config(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_config: int state ids [...] -> +-1 int8 [..., n]."""
    shifts = torch.arange(n, dtype=idx.dtype, device=idx.device)
    bits = (idx[..., None] >> shifts) & 1
    return (2 * bits - 1).to(torch.int8)


def overlap(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Normalised overlap q = <s1 s2> over the last axis."""
    n = sigma1.shape[-1]
    prod = sigma1.to(torch.int32) * sigma2.to(torch.int32)
    return prod.sum(dim=-1, dtype=torch.int32) / n
