"""Graph constructors: EA lattices (the roll-based LatticeEA for L > 2, the
generic Pairwise with doubled edges for L = 2), random regular graphs,
Ising1D, non-interacting fields, the Gaussian models split into a
discretized inner part and a residual (`Double`), and trivial debug models.

Disorder is generated on the host in numpy with the JAX package's exact
generators (rrrmc_tpu/models/graphs.py), so the same seed gives identical
neighbor and coupling tables; the resulting tables are placed on `device`,
CUDA when none is given (pass device="cpu" for the host).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .composite import Double
from .lattice import lattice_ea_from_levels, lattice_ea_normal
from .pairwise import (Pairwise, make_pairwise, infer_integer_scale,
                       enumerate_pair_classes)


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# adjacency generators (identical to the JAX package's)
# ---------------------------------------------------------------------------

def gen_ea_adjacency(L: int, D: int) -> list:
    """Periodic L^D lattice; each site lists its 2D neighbors (with the
    duplicate parallel-edge convention for L=2, like the reference's gen_EA)."""
    n = L ** D
    coords = np.indices((L,) * D).reshape(D, n)
    adj = []
    for x in range(n):
        c = coords[:, x]
        nbrs = []
        for d in range(D):
            for s in (+1, -1):
                cc = c.copy()
                cc[d] = (cc[d] + s) % L
                y = int(np.ravel_multi_index(cc, (L,) * D))
                nbrs.append(y)
        adj.append(sorted(nbrs))
    return adj


def gen_rrg_adjacency(N: int, K: int, rng: np.random.Generator) -> list:
    """Random K-regular simple graph via the pairing model with restarts
    (the reference's gen_RRG)."""
    if (N * K) % 2 != 0:
        raise ValueError("N*K must be even")
    for _ in range(100_000):
        stubs = rng.permutation(np.repeat(np.arange(N), K))
        a, b = stubs[0::2], stubs[1::2]
        if np.any(a == b):
            continue
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        edges = lo.astype(np.int64) * N + hi
        if len(np.unique(edges)) != len(edges):
            continue
        adj = [[] for _ in range(N)]
        for x, y in zip(a, b):
            adj[int(x)].append(int(y))
            adj[int(y)].append(int(x))
        return adj
    raise RuntimeError("RRG generation failed (K too large?)")


def assign_edge_couplings(adj: list, draw) -> list:
    """Symmetric per-edge couplings: one draw per undirected edge, stored in
    both endpoint rows (the reference's gen_J). Duplicate parallel edges
    (EA L=2) get independent draws per slot."""
    n = len(adj)
    used = [0] * n
    J = [[None] * len(a) for a in adj]
    for x in range(n):
        for k, y in enumerate(adj[x]):
            if J[x][k] is not None:
                continue
            if y >= x:
                v = draw()
                J[x][k] = v
                if y != x:
                    # fill y's first unassigned slot pointing back at x
                    for l in range(used[y], len(adj[y])):
                        if adj[y][l] == x and J[y][l] is None:
                            J[y][l] = v
                            break
    for x in range(n):
        assert all(v is not None for v in J[x])
    return J


# ---------------------------------------------------------------------------
# model constructors
# ---------------------------------------------------------------------------

def _pairwise_from_levels(adj, J, n, lev, degree, device) -> Pairwise:
    scale = infer_integer_scale(np.asarray(lev, dtype=np.float64))
    classes = enumerate_pair_classes([float(l) for l in lev], degree)
    return make_pairwise(adj, J, n, integer_scale=scale, classes=classes,
                         device=device)


def _discretize(x: np.ndarray, lev: Sequence[float]):
    """Nearest-level split into (discrete, residual) (the reference's
    discretize)."""
    lev = np.asarray(lev, dtype=np.float64)
    idx = np.argmin(np.abs(x[..., None] - lev), axis=-1)
    d = lev[idx]
    return d, x - d


def _normal_discretized(adj, n, lev, degree, rng, device) -> Double:
    """Gaussian couplings split into an inner Pairwise on the levels `lev`
    (exact, integer when the levels allow) and a float residual Pairwise."""
    Jc = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    dJ, rJ = zip(*(_discretize(np.asarray(row, dtype=np.float64), lev)
                   for row in Jc))
    inner = _pairwise_from_levels(adj, [list(d) for d in dJ], n, lev, degree,
                                  device)
    resid = make_pairwise(adj, [list(r) for r in rJ], n, device=device)
    return Double(inner_m=inner, resid_m=resid, N=n)


def GraphEA(L: int, D: int, LEV: Tuple[float, ...] = (-1, 1), *, seed=None,
            device=None) -> Pairwise:
    """Edwards-Anderson lattice (the reference's GraphEA). For L > 2 the
    roll-based LatticeEA (the checkerboard sweep kernel's model); L = 2 keeps
    the generic Pairwise path with doubled parallel edges."""
    rng = _rng(seed)
    if L > 2:
        return lattice_ea_from_levels(L, D, LEV, rng, device=device)
    adj = gen_ea_adjacency(L, D)
    lev = [float(l) for l in LEV]
    J = assign_edge_couplings(adj, lambda: float(rng.choice(lev)))
    return _pairwise_from_levels(adj, J, L ** D, lev, 2 * D, device)


def GraphEANormal(L: int, D: int, *, seed=None, device=None) -> Pairwise:
    """EA with unit-variance Gaussian J (the reference's GraphEANormal),
    float32; a LatticeEA for L > 2, as GraphEA."""
    rng = _rng(seed)
    if L > 2:
        return lattice_ea_normal(L, D, rng, device=device)
    adj = gen_ea_adjacency(L, D)
    J = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    return make_pairwise(adj, J, L ** D, device=device)


def GraphRRG(N: int, K: int, LEV: Tuple[float, ...] = (-1, 1), *, seed=None,
             device=None) -> Pairwise:
    """Random regular graph with level couplings (the reference's GraphRRG)."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    lev = [float(l) for l in LEV]
    J = assign_edge_couplings(adj, lambda: float(rng.choice(lev)))
    return _pairwise_from_levels(adj, J, N, lev, K, device)


def GraphRRGNormal(N: int, K: int, *, seed=None, device=None) -> Pairwise:
    """RRG with Gaussian J (the reference's GraphRRGNormal), float32."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    J = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    return make_pairwise(adj, J, N, device=device)


def GraphRRGNormalDiscretized(N: int, K: int, LEV: Sequence[float], *,
                              seed=None, device=None) -> Double:
    """Gaussian-J RRG split into a discretized inner part and a residual
    (the reference's GraphRRGNormalDiscretized), the JAX package's draw."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    return _normal_discretized(adj, N, [float(l) for l in LEV], K, rng,
                               device)


def GraphEANormalDiscretized(L: int, D: int, LEV: Sequence[float], *,
                             seed=None, device=None) -> Double:
    """Gaussian-J EA lattice split as GraphRRGNormalDiscretized (the
    reference's GraphEANormalDiscretized): generic Pairwise parts, as in the
    JAX package."""
    rng = _rng(seed)
    adj = gen_ea_adjacency(L, D)
    return _normal_discretized(adj, L ** D, [float(l) for l in LEV], 2 * D,
                               rng, device)


def GraphFieldsNormalDiscretized(N: int, LEV: Sequence[float], *, seed=None,
                                 device=None) -> Double:
    """Gaussian fields split into discretized and residual fields (the
    reference's GraphFieldsNormalDiscretized)."""
    rng = _rng(seed)
    lev = [float(l) for l in LEV]
    hd, hr = _discretize(rng.standard_normal(N), lev)
    scale = infer_integer_scale(np.asarray(lev))
    classes = tuple(sorted({abs(2.0 * l) for l in lev}))
    adj = [[] for _ in range(N)]
    inner = make_pairwise(adj, adj, N, h=hd, integer_scale=scale,
                          classes=classes, device=device)
    resid = make_pairwise(adj, adj, N, h=hr, device=device)
    return Double(inner_m=inner, resid_m=resid, N=N)


def load_ea_instance(fname: str):
    """Parse a 2-D EA instance file (the reference's gen_AJ): header lines
    `type:`, `size: L`, `name:`, then `x y Jxy` edges with 1-based site
    indices on the L x L periodic lattice. Returns (L, adj, J)."""
    with open(fname) as f:
        line = f.readline().strip()
        if not line.startswith("type:"):
            raise ValueError(f"bad header line: {line!r}")
        ls = f.readline().split()
        if not (len(ls) == 2 and ls[0] == "size:"):
            raise ValueError(f"bad size line: {ls!r}")
        L = int(ls[1])
        if not f.readline().strip().startswith("name:"):
            raise ValueError("missing name line")
        adj = gen_ea_adjacency(L, 2)
        J = [[None] * len(a) for a in adj]
        for raw in f:
            ls = raw.split()
            if not ls:
                continue
            if len(ls) != 3:
                raise ValueError(f"bad edge line: {raw!r}")
            x, y, Jxy = int(ls[0]) - 1, int(ls[1]) - 1, float(ls[2])
            for a, b in ((x, y), (y, x)):
                k = adj[a].index(b)
                if J[a][k] is not None:  # doubled edge (L=2): next free slot
                    k = adj[a].index(b, k + 1)
                if J[a][k] is not None:
                    raise ValueError(f"edge {x + 1} {y + 1} given twice")
                J[a][k] = Jxy
        if not all(v is not None for row in J for v in row):
            raise ValueError("incomplete file")
    return L, adj, J


def GraphEAFromFile(fname: str, *, device=None) -> Pairwise:
    """EA 2-D model from an instance file (the reference's GraphEANormal file
    constructor), float32 couplings."""
    L, adj, J = load_ea_instance(fname)
    return make_pairwise(adj, J, L * L, device=device)


def GraphIsing1D(N: int, *, device=None) -> Pairwise:
    """Antiferromagnetic ring with constant fields h=1 (the reference's
    GraphIsing1D); allDeltaE = (2, 6)."""
    if N <= 2:
        raise ValueError("GraphIsing1D needs N > 2")
    adj = [[(i - 1) % N, (i + 1) % N] for i in range(N)]
    J = [[-1.0, -1.0] for _ in range(N)]
    return make_pairwise(adj, J, N, h=np.ones(N), integer_scale=1.0,
                         classes=(2.0, 6.0), device=device)


def GraphFields(N: int, LEV: Tuple[float, ...] = (1,), *, seed=None,
                device=None) -> Pairwise:
    """Non-interacting spins in random fields from LEV (the reference's
    GraphFields)."""
    rng = _rng(seed)
    lev = [float(l) for l in LEV]
    h = rng.choice(lev, size=N)
    scale = infer_integer_scale(np.asarray(lev))
    classes = tuple(sorted({abs(2.0 * l) for l in lev}))
    adj = [[] for _ in range(N)]
    J = [[] for _ in range(N)]
    return make_pairwise(adj, J, N, h=h, integer_scale=scale,
                         classes=classes, device=device)


def GraphEmpty(N: int, *, device=None) -> Pairwise:
    """Free spins, energy always 0 (the reference's GraphEmpty)."""
    adj = [[] for _ in range(N)]
    return make_pairwise(adj, adj, N, integer_scale=1.0, device=device)


def GraphTwoSpin(*, device=None) -> Pairwise:
    """(the reference's GraphTwoSpin)"""
    return make_pairwise([[1], [0]], [[1.0], [1.0]], 2, integer_scale=1.0,
                         classes=(2.0,), device=device)


def GraphThreeSpin(*, device=None) -> Pairwise:
    """(the reference's GraphThreeSpin)"""
    adj = [[1, 2], [0, 2], [0, 1]]
    J = [[1.0, 1.0]] * 3
    return make_pairwise(adj, J, 3, integer_scale=1.0, classes=(0.0, 4.0),
                         device=device)
