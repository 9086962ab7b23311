"""wtmMC: rejection-free waiting-time method (Dall & Sibani).

Every spin carries an exponential firing time with mean
tau_i = max(1, e^{beta dE_i}); the earliest clock fires, that spin flips,
and the clocks are redrawn. Global time replaces the iteration counter;
`step` is measured in global time scaled by 1/N (the reference's
convention).

The race kernel of the model's family (samplers/families.py: ops/rejfree.py
for Pairwise models, ops/perc.py for the perceptrons, ...) redraws ALL
clocks each move, which by
exponential memorylessness is distributionally identical to the
reference's neighbour-only redraw: the race scores are the redraw, and the
clock advances by the winning time exp(min score).
"""

from __future__ import annotations

from typing import Optional

from ..core.model import Model
from .bkl import rejfree_mc, require_kernel_route
from .common import DEFAULT_SEED, MCState, init_state


def wtmMC(model: Model, beta: float, samples: int, *, step: float = 1.0,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 1024, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto",
          device=None):
    """Waiting-time method; collects `samples` checkpoints spaced `step`
    (scaled by 1/N) in global time. Returns (Es [chains, samples], final
    MCState). Kernel route only, as bklMC."""
    require_kernel_route("wtmMC", model, backend=backend, hook=hook,
                         observer=observer)
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    step_t = float(step) / model.N
    tmax = step_t * samples
    return rejfree_mc(model, float(beta), "wtm", tmax, step_t, state,
                      samples, chunk_moves)
