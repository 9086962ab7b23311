"""Race moves (bkl / wtm / rrr) on PSpin3 hypergraphs: the CUDA kernel's
wrapper, its plain torch version, and the eligibility rule of the PSpin3
race and EO kernels (the EO kernel's wrapper is ops/eo_pspin.py).

Source note. The race kernel replaces
rrrmc_tpu/ops/rejfree_pallas.py::_rejfree_pspin_kernel and the EO kernel
rrrmc_tpu/ops/eo_pallas.py::_eo_pspin_kernel. To both, a PSpin3 is the
sparse pairwise model with the cavity sum c in the place of the local field
(half = sigma * c, dE = 2 half): the race and the EO select are the sparse
kernels' (csrc/rejfree_sparse.cu, csrc/eo_sparse.cu), instantiated with the
hypergraph flip. A chain keeps its spins and cavity sums resident in shared
memory (5 bytes a site, 37.5 KB at N = 7500; the EO kernel adds the best
spins). The flip of winner w walks w's own row of the partner table A
[N, K, 2], read as [N, 2K]: for each triangle (w, a, b), c_a += d sigma_b
and c_b += d sigma_a with d = -2 sigma_w, 2K updates. The TPU kernels kept
K product tables q_k beside c and negated the products holding the winner by
comparing every site's partner columns, because Mosaic has no gather; the
H100 gathers the two partner spins instead. The rrr undo restores the 2K
saved sums in reverse order, so a site that shares two triangles with w
comes back exactly. Both kernels are bound by their passes over the
resident sites, as the sparse ones are.

The JAX run re-derives c and q from the spins at each chunk, with the seed
stepped by 7919; the port keeps c in place across chunks and counts moves by
`move0`, as the sparse race does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check_args, require_smem
from .rejfree import BitsFn, MODES, coord_dtype, race_chunk_reference
from ..models.pspin import flip_cavity

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0


def pspin_rejfree_ok(model) -> bool:
    """Eligibility of a model for the PSpin3 race and EO kernels (the JAX
    package's `_pspin_rejfree_ok` without its VMEM caps N <= 8192, K <= 8:
    the shared-memory limit is checked at launch): a PSpin3 with N >= 9."""
    from ..models.pspin import PSpin3

    return isinstance(model, PSpin3) and model.N >= 9


def _check_race(sigma, c, E, coord, acc, zacc, A, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    B, N = sigma.shape
    K = A.shape[1]
    i32 = torch.int32
    check_args({"sigma": (sigma, (B, N), torch.int8), "c": (c, (B, N), i32),
                "E": (E, (B,), i32),
                "coord": (coord, (B,), coord_dtype(mode)),
                "acc": (acc, (B,), i32),
                "zacc": (zacc, (B,), torch.float32),
                "A": (A, (N, K, 2), i32)}, sigma.device)


def rejfree_pspin_chunk(sigma, c, E, coord, acc, zacc, A, *, mode: str,
                        n_moves: int, beta_s: float, target, seed: int,
                        move0: int = 0, chain0: int = 0,
                        bits: Optional[BitsFn] = None):
    """Advance every chain by `n_moves` race moves, in place: the contract
    of ops/rejfree.py::rejfree_sparse_chunk, with the cavity sums c [B, N]
    int32 in the place of lf, int32 E and the partner table A [N, K, 2]
    int32 in the place of neigh/J. beta_s = beta * model.scale. Returns
    the per-move (coordinate, E) streams, each [n_moves, B]."""
    global LAUNCHES
    _check_race(sigma, c, E, coord, acc, zacc, A, mode)
    if sigma.device.type == "cpu":
        return rejfree_pspin_chunk_reference(
            sigma, c, E, coord, acc, zacc, A, mode=mode, n_moves=n_moves,
            beta_s=beta_s, target=target, seed=seed, move0=move0,
            chain0=chain0, bits=bits)
    if sigma.device.type != "cuda":
        raise ValueError(f"no race kernel for device {sigma.device}")
    if bits is not None:
        raise ValueError("injected bits are taken by the plain version only")
    from .cuda_build import check, library

    lib = library()
    B, N = sigma.shape
    K2 = 2 * A.shape[1]
    dev = sigma.device
    require_smem(lib.rrrmc_rejfree_sparse_smem(N, K2),
                 lib.rrrmc_rejfree_sparse_max_smem(dev.index or 0), N,
                 "PSpin3 race")
    ct = coord_dtype(mode)
    cs = torch.empty((n_moves, B), dtype=ct, device=dev)
    es = torch.empty((n_moves, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rrrmc_rejfree_pspin(
            sigma.data_ptr(), c.data_ptr(), E.data_ptr(), coord.data_ptr(),
            acc.data_ptr(), zacc.data_ptr(), cs.data_ptr(), es.data_ptr(),
            A.data_ptr(), N, K2, B, n_moves, seed & 0xFFFFFFFF,
            move0 & 0xFFFFFFFF, chain0 & 0xFFFFFFFF, 2.0 * beta_s,
            int(target) if ct == torch.int32 else 0, float(target),
            MODES[mode], torch.cuda.current_stream().cuda_stream)
    check(err, "rejfree_pspin launch")
    LAUNCHES += 1
    return cs, es


def rejfree_pspin_chunk_reference(sigma, c, E, coord, acc, zacc, A, *,
                                  mode: str, n_moves: int, beta_s: float,
                                  target, seed: int, move0: int = 0,
                                  chain0: int = 0,
                                  bits: Optional[BitsFn] = None):
    """Plain torch version of the PSpin3 race kernel (same arguments,
    in-place contract and streams as `rejfree_pspin_chunk`)."""

    def c_flipped(sig, c, win, d, do):
        return flip_cavity(A, sig, c.clone(), win, d, do)

    return race_chunk_reference(
        sigma, c, E, coord, acc, zacc, c_flipped, mode=mode,
        n_moves=n_moves, beta_s=beta_s, target=target, seed=seed,
        move0=move0, chain0=chain0, bits=bits)
