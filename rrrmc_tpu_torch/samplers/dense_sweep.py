"""sweepMC_dense: sequential single-site Metropolis sweeps on a dense
FullyConnected model (the JAX package's rrrmc_tpu/samplers/dense_sweep.py).

Two backends, each N attempted flips per chain and sweep:

* "kernel": the dense sweep kernel (ops/sk.py; the CUDA kernel for a CUDA
  state, its plain version on the CPU): sites in order in windows of 128,
  one launch per checkpoint, integer couplings |J| <= 127 and integer
  fields; exact int32 energies. `accepted` is left as it was, as on the
  JAX package's Pallas route.
* "torch": the JAX package's "xla" route in plain torch. Each sweep visits
  the sites of one random permutation shared by the batch, in windows of W
  sites decided one after another against the window's stale fields plus
  the corrections of its own accepted flips ([W, W] block of J); then one
  rank-W product commits lf += delta J[window, :] (torch.matmul: float64
  cast back for integer J, exact; float32 for float J, which then
  refreshes lf and E from scratch after every sweep, as the JAX route does,
  so rounding drift stays bounded by one sweep). Counts accepted flips.

"auto" takes "kernel" when the model is eligible.

`sweepMC_quant` (alias `sweepMC_replica`) runs the same sequential sweeps on
the replica composites over a dense base, on their own kernel
(ops/replica_sweep.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import ftype, is_integer
from ..models.dense import FullyConnected
from ..ops.sk import SKSweeper, sk_sweep_eligible
from .common import (DEFAULT_SEED, MCState, cached, init_state, kernel_seed,
                     physical_series, set_route, working_copy)

#: SKSweepers keyed on the identity of J and h, the scale and beta
_SWEEPERS: dict = {}


def _sweeper(model, beta: float) -> SKSweeper:
    return cached(_SWEEPERS, (model.J, model.h), (model.scale, beta),
                  lambda: SKSweeper(model, beta))


def _run_sweeps(model, sweeper, tensors, sweeps, step, seed, route,
                chain0=0):
    """Advances `tensors` (sigma, lf, E, then what else the sweeper takes)
    in place by `sweeps` sweeps: one launch per checkpoint (and one for a
    remainder of sweeps), continuing one Philox stream across launches.
    Returns the checkpoints' physical energies [chains, sweeps // step]."""
    sigma, E = tensors[0], tensors[2]
    n_ckpt = sweeps // step
    Es = []
    for k in range(n_ckpt):
        sweeper(*tensors, seed=seed, n_sweeps=step, sweep0=k * step,
                chain0=chain0)
        Es.append(model.to_physical(E).clone())
    if sweeps % step:
        sweeper(*tensors, seed=seed, n_sweeps=sweeps % step,
                sweep0=n_ckpt * step, chain0=chain0)
    set_route(route, impl="cuda" if sigma.device.type == "cuda" else "plain")
    return physical_series(Es, sigma.shape[0], sigma.device)


def _run_kernel(model, beta, sweeps, step, state):
    """The dense sweep kernel from `state`; `accepted` is left as it was."""
    sigma, E = state.sigma.clone(), state.E.clone()
    lf = model.local_fields(sigma).contiguous()
    Es = _run_sweeps(model, _sweeper(model, beta), (sigma, lf, E), sweeps,
                     step, kernel_seed(state.generator), "kernel-sk-sweep",
                     state.chain0)
    state = MCState(sigma=sigma, aux=lf, E=E,
                    accepted=state.accepted.clone(),
                    generator=state.generator, chain0=state.chain0)
    return Es, state


def _commit(J, rows, delta):
    """delta [B, W] @ J[rows] [W, N]: exact in float64 for integer J."""
    if is_integer(J):
        return (delta.to(torch.float64) @ J[rows].to(torch.float64)).to(
            delta.dtype)
    return delta @ J[rows]


def _run_delayed(model, beta, sweeps, step, state, window):
    """The delayed-update torch route on a random permutation per sweep;
    uniforms and permutations from the state's generator."""
    N = model.N
    W = min(window, N)
    if N % W:  # the largest divisor of N that fits the requested window
        W = max(d for d in range(1, W + 1) if N % d == 0)
    st = working_copy(state)
    gen, dev = st.generator, st.sigma.device
    integer = is_integer(model.J)
    lt = model.acc_dtype
    s = st.sigma.to(lt)
    lf = model.local_fields(st.sigma)
    E, accepted = st.E.to(lt), st.accepted
    beta_s = float(beta) * model.scale
    B = s.shape[0]
    n_ckpt = sweeps // step
    Es = []
    for sw in range(sweeps):
        perm = torch.randperm(N, generator=gen, device=dev).view(-1, W)
        for rows in perm:
            Jw = model.J[rows][:, rows].to(lt)
            sw_ = s[:, rows]
            lfw = lf[:, rows]
            u = torch.rand((B, W), generator=gen, device=dev)
            delta = torch.zeros_like(sw_)
            for k in range(W):
                dE = 2 * sw_[:, k] * lfw[:, k]
                acc = (dE <= 0) | (u[:, k] < torch.exp(
                    -beta_s * dE.to(ftype())))
                d = torch.where(acc, -2 * sw_[:, k], 0)
                delta[:, k] = d
                lfw = lfw + d[:, None] * Jw[k][None, :]
                E += torch.where(acc, dE, 0)
                accepted += acc.to(torch.int32)
            s[:, rows] = sw_ + delta
            lf += _commit(model.J, rows, delta)
        if not integer:   # drift refresh
            sig8 = s.to(torch.int8)
            lf, E = model.local_fields(sig8), model.energy(sig8)
        if (sw + 1) % step == 0 and len(Es) < n_ckpt:
            Es.append(model.to_physical(E))
    set_route("torch", impl="torch", window=W)
    state = MCState(sigma=s.to(torch.int8), aux=lf, E=E, accepted=accepted,
                    generator=gen, chain0=st.chain0)
    return physical_series(Es, B, dev), state


def sweepMC_dense(model: FullyConnected, beta: float, sweeps: int, *,
                  step: int = 1, chains: int = 1, seed: int = DEFAULT_SEED,
                  C0=None, window: int = 128, backend: str = "auto",
                  state: Optional[MCState] = None, device=None):
    """Sequential single-site Metropolis sweeps on a dense model: `sweeps`
    sweeps of N attempted flips per chain. Returns (Es [chains,
    sweeps // step] physical energies, final MCState).

    backend "kernel": the dense sweep kernel (sites in order, integer
    |J| <= 127 and integer fields; raises otherwise). "torch": random-
    permutation windows of `window` sites (the largest divisor of N that
    fits) with delayed updates, integer or float J. "auto": "kernel" when
    the model is eligible, else "torch"."""
    if not isinstance(model, FullyConnected):
        raise ValueError(f"sweepMC_dense needs a FullyConnected model, got "
                         f"{type(model).__name__}")
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        backend = "kernel" if sk_sweep_eligible(model) else "torch"
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    if backend == "kernel":
        return _run_kernel(model, float(beta), sweeps, step, state)
    return _run_delayed(model, float(beta), sweeps, step, state, window)


def sweepMC_quant(model, beta: float, sweeps: int, *, step: int = 1,
                  chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
                  state: Optional[MCState] = None, device=None):
    """Sequential Metropolis sweeps on a GraphQuant / GraphRobustEnsemble
    composite over a FullyConnected base (integer |J| <= 127 or float
    couplings): the Metropolis engine of the paper's QIsing / REIsing
    runs. One sweep is N = Nk * M attempted flips per chain, in order.
    Returns (Es [chains, sweeps // step] physical energies, final MCState);
    `accepted` gains the accepted flips.

    Runs on the replica sweep kernel only (ops/replica_sweep.py: the CUDA
    kernel for a CUDA state, its plain version on the CPU), one launch per
    checkpoint (and one for a remainder of sweeps), the base fields carried
    across launches and one Philox stream continued; an ineligible model
    raises ValueError."""
    from ..ops.replica import replica_state
    from ..ops.replica_sweep import ReplicaSweeper

    # the tables are built anew on each call: nothing is keyed on the
    # identity of the base's tensors
    sweeper = ReplicaSweeper(model, float(beta))
    if state is None:
        state = init_state(model, chains, seed, C0, device=device)
    sigma = state.sigma.clone()
    lf, E = replica_state(model, sigma, state.E)
    acc = state.accepted.clone()
    Es = _run_sweeps(model, sweeper, (sigma, lf, E, acc), sweeps, step,
                     kernel_seed(state.generator), "kernel-replica-sweep",
                     state.chain0)
    state = MCState(sigma=sigma, aux=model.init_aux(sigma), E=E,
                    accepted=acc, generator=state.generator,
                    chain0=state.chain0)
    return Es, state


#: the same entry point covers GraphRobustEnsemble composites
sweepMC_replica = sweepMC_quant
