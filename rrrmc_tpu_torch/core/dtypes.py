"""Dtype policy.

* Integer-valued models (discrete couplings) keep an exact int32 internal
  energy domain, converted to physical units by a static per-model `scale`
  (the fixed-point idea of the reference's DFloat64: discrete delta-E
  identities never suffer float roundoff).
* Continuous models use float32 throughout: energies, local fields and the
  kernels' arithmetic.
"""

from __future__ import annotations

import torch

#: fixed-point scale used when discretizing Float64 coupling levels
FIXED_POINT_DIGITS = 5
FIXED_POINT_SCALE = 10 ** FIXED_POINT_DIGITS


def ftype() -> torch.dtype:
    """Floating dtype of continuous models and physical energies."""
    return torch.float32


def itype() -> torch.dtype:
    """Integer dtype of exact discrete energies."""
    return torch.int32


def is_integer(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)
