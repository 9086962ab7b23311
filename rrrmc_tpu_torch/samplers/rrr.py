"""rrrMC: reduced-rejection-rate Monte Carlo (the package's namesake).

Per move, for single models (the reference's SingleGraph path):

1. pick spin i proportionally to w_i = min(1, e^{-beta dE_i}), z = sum w;
2. compute z' = the same sum as if i were flipped (the staged reverse
   probability);
3. accept with probability min(1, z / z').

The race kernel of the model's family (samplers/families.py: ops/rejfree.py
for Pairwise models, ops/perc.py for the perceptrons, ..., mode "rrr")
picks i by an exponential race and evaluates the test in a shifted log
domain, exact when every weight underflows float32. The reference's adaptive direct/staged switch
(`staged_thr`) selects between two implementations of this same Markov
kernel; the race kernel needs neither, so the option is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

from ..core.model import Model
from .bkl import MAX_ITERS, rejfree_mc, require_kernel_route
from .common import DEFAULT_SEED, MCState, init_state


def rrrMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          observer=None, hook=None, state: Optional[MCState] = None,
          backend: str = "auto", chunk_moves: int = 1024, device=None):
    """Reduced-rejection-rate MC, called as bklMC (`iters` counts moves).
    Returns (Es [chains, iters // step], final MCState). Kernel route only,
    as bklMC. On a GraphQuant / GraphRobustEnsemble composite the kernel
    runs the SingleGraph rrr law on the flat composite (ops/replica.py); any
    other Double model raises NotImplementedError."""
    if not math.isfinite(beta):
        raise ValueError(f"beta must be finite, given: {beta}")
    require_kernel_route("rrrMC", model, backend=backend, hook=hook,
                         observer=observer)
    if iters > MAX_ITERS:
        raise ValueError(f"rrrMC: iters must be <= {MAX_ITERS}")
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    return rejfree_mc(model, float(beta), "rrr", int(iters), int(step),
                      state, iters // step, chunk_moves)
