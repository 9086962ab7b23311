"""Race moves (bkl / wtm / rrr) on the replica composites: GraphQuant (the
Trotter ring) and GraphRobustEnsemble (the star) over a dense
(FullyConnected) or a sparse (Pairwise) base. The kernel tables, the
eligibility rules, the CUDA race kernel's wrapper (csrc/rejfree_replica.cu)
and its plain torch version; the composite sweep is ops/replica_sweep.py.

Source note. The kernel replaces
rrrmc_tpu/ops/quant_pallas.py::_ring_rejfree_kernel (dense base) and
::_sparse_comp_kernel (sparse base). Both rest on one identity for the
physical cost of flipping composite spin j = (i, k), replica-major
j = i + k * Nk:

    dE_j = 2 s_j (sb * lf_j + c4 (s_{i,k-1} + s_{i,k+1}))      (ring)
    dE_j = 2 s_j (sb * lf_j) + s_j fk[(mu_i - s_j + M - 1) >> 1]  (star)

with lf_j the BASE local field of spin i in replica k (J_base s_k + h, in
the base's internal units: exact int32 for an integer base), sb = base.scale
* the replicas' weight, c4 = fourK / 4, mu_i = sum_k s_{i,k} and fk the
star's M-entry table. The TPU dense kernel recomputed lf with M matmuls
every move and the sparse one compared composite-indexed inverse columns,
since Mosaic has no gather. Here, as in the port's other race kernels, a
chain keeps its spins, its base fields (and the star's mu) resident in
shared memory, and a flip of (i, k) adds d * J_base[i, :] (dense: Nk
fields) or the K entries of i's neighbour row (sparse) into replica block k
only: O(Nk) or O(K) per applied flip. The extra term is derived per site
from the spins (ring) or mu (star) as the race reads it, once per site and
state in race.cuh's fused pass, which walks the sites by (k, i) without a
division. It is bound by the arithmetic of that pass over the N = Nk * M
resident sites per move (two for rrr), as the sparse race is. The launch
rule is ops/rejfree.py's (`fused_plan`): the base fields stay resident as
int8, int16 or int32 by the bound samplers/families.py hands it (the base's
largest row sum of |J| plus |h|: int16 for the SK base at Nk = 1024), and
the block size follows the chains. The TPU caps
(Nk % 128, chains % 128, the composite and star size caps) are not carried
over: the only limit is shared memory, checked at launch.

Kernel rrr runs the SingleGraph rrr law on the flat composite (the JAX
package's kernel route does the same): a different chain from the
inner + residual split of the reference's Double rrr, with the same
stationary law. Energies are float32 physical; E gains the float32 dE of
each applied move. The race, the shifted log-sum-exp z, the Philox streams
and the coordinate rules are ops/rejfree.py's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import check_args, launch
from .rejfree import (BitsFn, FIELD_CODES, MODES, THREADS, coord_dtype,
                      race_chunk_reference, race_plan, resident_dtype,
                      sparse_rejfree_ok)
from .rejfree_dense import dense_rejfree_ok, kernel_couplings
from ..core.dtypes import is_integer
from ..utils.profiling import spanned


class ReplicaTables(NamedTuple):
    """What the composite kernels read: the wrapper term ("ring" or
    "star"), M and Nk, params [2 + M] float32 = (sb, c4, fk[0..M-1]) (c4 is
    0 for the star, fk 0 for the ring), the base couplings J (dense: the
    [Nk, Nk] matrix, int8 for an integer base, else float32; sparse: the
    [Nk, K] table, int32 or float32) and, for a sparse base, its neighbour
    table neigh [Nk, K] int32 (padding == Nk)."""
    term: str
    M: int
    Nk: int
    params: torch.Tensor
    J: torch.Tensor
    neigh: Optional[torch.Tensor]


def replica_base(model):
    """The base model of a GraphQuant / GraphRobustEnsemble composite whose
    replicas fill the whole composite (no centre blocks), else None."""
    from ..models.replicas import QuantModel, Replicated, REModel

    if not isinstance(model, (QuantModel, REModel)):
        return None
    resid = model.resid_m
    if not isinstance(resid, Replicated) or resid.offset != 0:
        return None
    return resid.base


def replica_dense_ok(model) -> bool:
    """A Quant / RE composite over a base the dense race kernel takes (a
    FullyConnected model: integer |J| <= 127 or finite float J)."""
    base = replica_base(model)
    return base is not None and dense_rejfree_ok(base)


def replica_sparse_ok(model) -> bool:
    """A Quant / RE composite over a base the sparse race kernel takes (a
    Pairwise model with integer or finite float couplings, lattices
    included)."""
    base = replica_base(model)
    return base is not None and sparse_rejfree_ok(base)


def replica_params(model) -> torch.Tensor:
    """[2 + M] float32 on the model's device: sb, c4 and the star's fk."""
    from ..models.replicas import QuantModel

    base = replica_base(model)
    M = model.M
    sb = float(base.scale) * float(model.resid_m.weight)
    if isinstance(model, QuantModel):
        vals = [sb, float(model.inner_m.scale)] + [0.0] * M
    else:
        vals = [sb, 0.0] + model.inner_m.fk.double().cpu().tolist()
    return torch.tensor(vals, dtype=torch.float32, device=base.J.device)


def replica_tables(model) -> tuple:
    """(ReplicaTables,) of an eligible composite, built anew on each call
    (nothing is keyed on the identity of the base's tensors): the dense
    form for a FullyConnected base, the sparse one for a Pairwise base."""
    from ..models.dense import FullyConnected
    from ..models.replicas import QuantModel

    base = replica_base(model)
    term = "ring" if isinstance(model, QuantModel) else "star"
    if isinstance(base, FullyConnected):
        J, neigh = kernel_couplings(base), None
    else:
        J, neigh = base.J.contiguous(), base.neigh.contiguous()
    return (ReplicaTables(term, model.M, model.Nk, replica_params(model), J,
                          neigh),)


def replica_state(model, sigma, E):
    """The race kernel's resident state of a composite batch: the base
    local fields of every replica, [B, N] in the composite layout (int32
    for an integer base, float32 otherwise), and E as float32 physical
    energies (copies)."""
    base = replica_base(model)
    lf = base.init_aux(model.resid_m.to_replicas(sigma))
    return (lf.reshape(sigma.shape[0], model.N).contiguous(),
            E.to(torch.float32).clone())


def replica_de(tab: ReplicaTables, sig, lf):
    """[B, N] float32 physical dE of flipping each composite spin (the
    module docstring's identity), in the kernel's float32 operations and
    order; sig [B, N] in any integer or float dtype, lf the base fields."""
    M, Nk = tab.M, tab.Nk
    sb, c4, fk = tab.params[0], tab.params[1], tab.params[2:]
    s = sig.to(torch.float32)
    t = sb * lf.to(torch.float32)
    if tab.term == "ring":
        r = torch.roll(s, -Nk, dims=1) + torch.roll(s, Nk, dims=1)
        return 2 * s * (t + c4 * r)
    si = sig.to(torch.int32)
    mu = si.view(-1, M, Nk).sum(dim=1, dtype=torch.int32).repeat(1, M)
    return 2 * s * t + s * fk[((mu - si + M - 1) >> 1).long()]


def flip_base_fields(tab: ReplicaTables, lf, win, d, do):
    """A copy of the base fields lf [B, N] with the winner win [B] flipped
    (d = -2 s_win in lf's dtype) where `do`: d * J_base[i] added to replica
    block k of win = (i, k), over the dense row or, in order, over the K
    entries of the sparse row."""
    Nk = tab.Nk
    lf = lf.clone()
    k = torch.div(win, Nk, rounding_mode="floor")
    i = win % Nk
    if tab.neigh is None:
        cols = k[:, None] * Nk + torch.arange(Nk, device=lf.device)
        old = lf.gather(1, cols)
        new = old + d[:, None] * tab.J[i].to(lf.dtype)
        lf.scatter_(1, cols, torch.where(do[:, None], new, old))
        return lf
    rows = torch.arange(lf.shape[0], device=lf.device)
    nb = tab.neigh[i].long()
    jr = tab.J[i].to(lf.dtype)
    for kk in range(nb.shape[1]):
        sel = do & (nb[:, kk] < Nk)
        cols = k[sel] * Nk + nb[sel, kk]
        lf[rows[sel], cols] += jr[sel, kk] * d[sel]
    return lf


def _check_args(sigma, lf, E, coord, acc, zacc, tab, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if tab.term not in ("ring", "star"):
        raise ValueError(f"term must be 'ring' or 'star', got {tab.term!r}")
    B, N = sigma.shape
    Nk, M = tab.Nk, tab.M
    if N != Nk * M:
        raise ValueError(f"sigma has {N} spins, the composite {Nk} x {M}")
    integer = is_integer(lf)
    dt = torch.int32 if integer else torch.float32
    want = {"sigma": (sigma, (B, N), torch.int8), "lf": (lf, (B, N), dt),
            "E": (E, (B,), torch.float32),
            "coord": (coord, (B,), coord_dtype(mode)),
            "acc": (acc, (B,), torch.int32),
            "zacc": (zacc, (B,), torch.float32),
            "params": (tab.params, (2 + M,), torch.float32)}
    if tab.neigh is None:
        want["J"] = (tab.J, (Nk, Nk), torch.int8 if integer else torch.float32)
    else:
        K = tab.neigh.shape[1]
        want["J"] = (tab.J, (Nk, K), dt)
        want["neigh"] = (tab.neigh, (Nk, K), torch.int32)
    check_args(want, sigma.device)


@spanned("rrrmc.op.rejfree_replica")
def rejfree_replica_chunk(sigma, lf, E, coord, acc, zacc, tab: ReplicaTables,
                          *, mode: str, n_moves: int, beta_s: float, target,
                          seed: int, move0: int = 0, chain0: int = 0,
                          bits: Optional[BitsFn] = None,
                          field_bound: Optional[int] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk on the composite. sigma [B, N]
    int8 (N = Nk * M, replica-major), lf [B, N] the base fields
    (`replica_state`: int32 for an integer base, float32 otherwise), E [B]
    float32 physical, coord / acc / zacc as there; `tab` the
    `replica_tables`, `field_bound` a bound on |lf| (the family's; None:
    int32 resident fields for an integer base). beta_s is the physical
    beta (a composite's scale is 1). Returns the per-move (coordinate, E)
    streams, each [n_moves, B].

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the
    plain version. `bits` (move, draw) replaces the generator and is taken
    by the plain version only."""
    _check_args(sigma, lf, E, coord, acc, zacc, tab, mode)
    if sigma.device.type == "cpu":
        return rejfree_replica_chunk_reference(
            sigma, lf, E, coord, acc, zacc, tab, mode=mode, n_moves=n_moves,
            beta_s=beta_s, target=target, seed=seed, move0=move0,
            chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import library

    lib = library()
    B = sigma.shape[0]
    dev = sigma.device
    sparse = tab.neigh is not None
    K = tab.neigh.shape[1] if sparse else 0
    star = tab.term == "star"
    ct = coord_dtype(mode)
    field = resident_dtype(is_integer(lf), field_bound)
    kernel = "rejfree_replica" + ("_sparse" if sparse else "")
    T = race_plan(kernel, "rrrmc_rejfree_replica_info",
                  (FIELD_CODES[field], int(star), int(mode == "wtm")), B,
                  sigma.shape[1],
                  lib.rrrmc_rejfree_replica_smem(tab.Nk, tab.M, K, sparse,
                                                 star, field.itemsize),
                  field, dev.index or 0)["threads"]
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_replica(
            sigma.data_ptr(), lf.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            tab.J.data_ptr(), tab.neigh.data_ptr() if sparse else None,
            tab.params.data_ptr(), tab.Nk, tab.M, K, B, n_moves,
            seed & 0xFFFFFFFF, move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF,
            float(beta_s), int(target) if ct == torch.int32 else 0,
            float(target), MODES[mode], int(sparse), int(star), T,
            FIELD_CODES[field], torch.cuda.current_stream().cuda_stream)
    launch.launched(kernel, err)
    return cs, es


def rejfree_replica_chunk_reference(sigma, lf, E, coord, acc, zacc,
                                    tab: ReplicaTables, *, mode: str,
                                    n_moves: int, beta_s: float, target,
                                    seed: int, move0: int = 0,
                                    chain0: int = 0,
                                    bits: Optional[BitsFn] = None,
                                    threads: int = THREADS):
    """Plain torch version of the composite race kernel (same arguments,
    in-place contract and streams as `rejfree_replica_chunk`): the race
    moves of ops/rejfree.py with `replica_de` and `flip_base_fields`, z
    summed as the kernel's fused pass sums it with `threads` threads."""

    def lf_flipped(sig, lf, win, d, do):
        return flip_base_fields(tab, lf, win, d, do)

    return race_chunk_reference(
        sigma, lf, E, coord, acc, zacc, lf_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits,
        de_of=lambda sig, lf: replica_de(tab, sig, lf), threads=threads)
