"""The port's checkerboard sweep (rrrmc_tpu_torch/ops/sweep.py) against the
JAX Pallas sweep kernel run in interpret mode, on identical couplings, spins
and random bits, on its three code paths (threshold table, field column,
exp); and sweepMC's three routes through the public API, held against exact
enumeration and against the JAX sampler."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.ops import prng, sweep
from rrrmc_tpu_torch.ops.sweep import Sweeper, sweep_chunk

from torch_port_helpers import (CPU, host, pallas_interpret, port_lattice,
                                random_sigma, sweep_bits)

torch.set_num_threads(1)

B = 128
SEED = 17
N_SWEEPS = 40


@pytest.fixture(scope="module")
def sweep_pallas():
    with pallas_interpret("rrrmc_tpu.ops.sweep_pallas") as (sp,):
        yield sp


def _field_lattice(mod):
    """EA-2D L=4 (N=16) with integer fields in -2..2."""
    m = mod.GraphEA(4, 2, (-1, 1), seed=11, **host(mod))
    h = np.random.RandomState(3).randint(-2, 3, size=m.N)
    if mod is rt:
        return dataclasses.replace(m, h=jnp.asarray(h, m.h.dtype))
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


#: (JAX model, beta, code path): +-J EA-3D on the threshold table
#: (max_half 6), EA-2D with fields on the h column, and fixed-point
#: couplings (scale 1e-5, max_half far above 64) on the exp path
CASES = {
    "table": (lambda: rt.GraphEA(4, 3, (-1, 1), seed=5), 2.0),
    "field": (lambda: _field_lattice(rt), 1.0),
    "exp": (lambda: rt.GraphEA(4, 3, (-1.5, 0.5), seed=6), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_jax_interpret(sweep_pallas, case):
    """Spins and energies EQUAL after 40 sweeps: the integer arithmetic is
    exact, and on the exp path float32 exp and the threshold rounding agree
    between XLA and torch."""
    build, beta = CASES[case]
    jm = build()
    sigma = random_sigma(np.random.default_rng(3), B, jm.N)
    sig_j = jnp.asarray(sigma)
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j)).astype(np.int32)
    jsw = sweep_pallas.PallasSweeper(jm, beta, block_chains=B)
    sig_o, E_o = jsw(sig_j, jnp.asarray(E0), seed=SEED, n_sweeps=N_SWEEPS)

    pm = port_lattice(jm)
    psw = Sweeper(pm, beta)
    assert psw.table == (case != "exp")
    assert psw.th.shape[0] == jsw.max_half    # 0: the exp path
    np.testing.assert_array_equal(psw.Jp.numpy(), np.asarray(jsw.Jp))
    np.testing.assert_array_equal(psw.Jm.numpy(), np.asarray(jsw.Jm))
    if psw.table:
        np.testing.assert_array_equal(psw.th.numpy(), np.asarray(jsw.th))
    assert psw.Jp.shape[1] == pm.D + (case == "field")
    sig = torch.from_numpy(sigma.copy())
    E = torch.from_numpy(E0.copy())
    psw(sig, E, seed=SEED, n_sweeps=N_SWEEPS,
        bits=sweep_bits(SEED, B, pm.N))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_o))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
    assert torch.equal(pm.energy(sig), E)
    assert not torch.equal(sig, torch.from_numpy(sigma))


def test_split_runs_equal_one_launch():
    """Sweeps numbered from sweep0 continue one Philox stream: four
    launches of 5 sweeps equal one of 20. Keys follow the global chain id:
    the two halves of a batch, run with chain0, equal the whole batch."""
    pm = pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU)
    psw = Sweeper(pm, 2.0)
    st = pt.init_state(pm, 16, seed=4, **CPU)

    def run(sigma, E, parts, chain0=0):
        sigma, E = sigma.clone(), E.clone()
        done = 0
        for n in parts:
            psw(sigma, E, seed=SEED, n_sweeps=n, sweep0=done, chain0=chain0)
            done += n
        return sigma, E

    whole = run(st.sigma, st.E, [20])
    split = run(st.sigma, st.E, [5, 5, 5, 5])
    lo = run(st.sigma[:8], st.E[:8], [20])
    hi = run(st.sigma[8:], st.E[8:], [20], chain0=8)
    for i in range(2):
        assert torch.equal(whole[i], split[i])
        assert torch.equal(whole[i], torch.cat([lo[i], hi[i]]))
    assert torch.equal(pm.energy(whole[0]), whole[1])


def test_wrapper_checks_arguments():
    pm = pt.GraphEA(4, 2, seed=1, **CPU)
    psw = Sweeper(pm, 1.0)
    st = pt.init_state(pm, 4, seed=2, **CPU)
    kw = dict(L=4, D=2, n_sweeps=1, beta2s=2.0, seed=1)
    with pytest.raises(ValueError, match="E"):
        sweep_chunk(st.sigma, st.E.float(), psw.Jp, psw.Jm, psw.th, **kw)
    with pytest.raises(ValueError, match="L="):
        sweep_chunk(st.sigma, st.E, psw.Jp, psw.Jm, psw.th,
                    **dict(kw, L=3))
    with pytest.raises(ValueError, match="contiguous"):
        sweep_chunk(st.sigma.t().contiguous().t(), st.E, psw.Jp, psw.Jm,
                    psw.th, **kw)
    for bad in (pt.GraphEA(3, 2, seed=1, **CPU),
                pt.GraphEANormal(4, 2, seed=1, **CPU),
                pt.GraphRRG(16, 3, seed=1, **CPU)):
        assert not sweep.sweep_eligible(bad)
        with pytest.raises(ValueError, match="LatticeEA"):
            Sweeper(bad, 1.0)


#: (model builder, backend, expected route) of sweepMC
ROUTES = {
    "lattice-auto": (lambda: pt.GraphEA(4, 3, seed=2, **CPU), "auto",
                     "kernel-sweep"),
    "lattice-kernel": (lambda: _field_lattice(pt), "kernel", "kernel-sweep"),
    "rrg": (lambda: pt.GraphRRG(32, 3, seed=2, **CPU), "auto",
            "kernel-site-sweep"),
    "odd-L": (lambda: pt.GraphEA(3, 2, seed=2, **CPU), "kernel",
              "kernel-site-sweep"),
    "float-lattice": (lambda: pt.GraphEANormal(4, 2, seed=2, **CPU), "auto",
                      "kernel-site-sweep"),
    "EA-L2": (lambda: pt.GraphEA(2, 3, seed=2, **CPU), "auto",
              "kernel-site-sweep"),
    "lattice-torch": (lambda: pt.GraphEA(4, 2, seed=2, **CPU), "torch",
                      "torch"),
    "odd-L-torch": (lambda: pt.GraphEA(3, 2, seed=2, **CPU), "torch", "torch"),
    "small-N": (lambda: pt.GraphThreeSpin(**CPU), "auto", "torch"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_sweepmc_routes(name):
    """Each route names itself in LAST_ROUTE, keeps the running energy equal
    to energy(sigma) (exact for integer couplings) and returns one physical
    energy per checkpoint; only the site-sweep route counts accepted
    flips, as in the JAX package."""
    build, backend, route = ROUTES[name]
    m = build()
    Es, st = pt.sweepMC(m, 1.0, 7, step=3, chains=16, seed=3,
                        backend=backend, **CPU)
    assert pt.LAST_ROUTE["backend"] == route
    assert pt.LAST_ROUTE["impl"] == ("torch" if route == "torch"
                                     else "plain")
    assert Es.shape == (16, 2) and Es.dtype == torch.float32
    assert torch.equal(Es[:, -1], m.to_physical(st.E))
    if m.J.dtype.is_floating_point:
        err = (m.energy(st.sigma).double() - st.E.double()).abs().max()
        assert float(err) < 1e-5 * m.N
        torch.testing.assert_close(st.aux, m.local_fields(st.sigma),
                                   rtol=0, atol=1e-5)
    else:
        assert torch.equal(m.energy(st.sigma), st.E)
        assert torch.equal(st.aux, m.local_fields(st.sigma))
    if route == "kernel-site-sweep":
        assert torch.equal(st.accepted, pt.LAST_ROUTE["acc"])
        assert int(st.accepted.min()) > 0
    else:
        assert int(st.accepted.abs().max()) == 0


def test_sweepmc_reuses_sweeper():
    """Route (a) builds one Sweeper per (couplings, fields, scale, beta):
    a second call and a continuation reuse it; a field variant sharing Jd,
    or another beta, gets its own."""
    from rrrmc_tpu_torch.samplers import common, sweep as sweep_sampler

    m = pt.GraphEA(4, 2, seed=4, **CPU)
    _, st = pt.sweepMC(m, 1.0, 2, chains=4, seed=1, **CPU)
    first = sweep_sampler._sweeper(m, 1.0)
    _, st = pt.sweepMC(m, 1.0, 2, state=st, **CPU)
    assert sweep_sampler._sweeper(m, 1.0) is first
    assert torch.equal(m.energy(st.sigma), st.E)
    field = _field_lattice(pt)
    base = pt.GraphEA(4, 2, seed=11, **CPU)
    assert sweep_sampler._sweeper(base, 1.0).Jp.shape[1] == 2
    assert sweep_sampler._sweeper(
        dataclasses.replace(base, h=field.h), 1.0).Jp.shape[1] == 3
    assert sweep_sampler._sweeper(m, 2.0) is not first
    assert len(sweep_sampler._SWEEPERS) <= common._CACHE_MAX


def test_sweepmc_rejects():
    with pytest.raises(NotImplementedError, match="N >= 8"):
        pt.sweepMC(pt.GraphThreeSpin(**CPU), 1.0, 2, backend="kernel", **CPU)
    with pytest.raises(ValueError, match="backend"):
        pt.sweepMC(pt.GraphEA(4, 2, **CPU), 1.0, 2, backend="pallas", **CPU)
    with pytest.raises(NotImplementedError, match="requires a Pairwise"):
        pt.sweepMC(object(), 1.0, 2, **CPU)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_sweepmc_samples_boltzmann(backend):
    """EA-2D L=4 with integer fields: the checkerboard kernel route and the
    torch colour-mask route reach the exact 2^16 Boltzmann mean energy
    (the port's analysis.truep) within max(5 sigma, 0.05), sigma the
    standard error of the chain means."""
    m = _field_lattice(pt)
    beta = 1.0
    Es, _ = pt.sweepMC(m, beta, 240, step=2, chains=256, seed=7,
                       backend=backend, **CPU)
    assert pt.LAST_ROUTE["backend"] == ("kernel-sweep" if backend == "kernel"
                                        else "torch")
    Es = Es.double().numpy()[:, Es.shape[1] // 4:]
    got = Es.mean()
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    want = float((pt.analysis.truep(m, beta)
                  * pt.analysis.energy_table(m)).sum())
    assert abs(got - want) < max(5 * sem, 0.05), (got, want, sem)


def test_sweepmc_matches_jax_xla():
    """EA-3D L=4 +-J at beta=2 from the same starting spins: after 60
    sweeps the port's kernel route and the JAX colour-mask route
    (backend="xla") give E/N within max(5 sigma, 0.02)."""
    jm = rt.GraphEA(4, 3, (-1, 1), seed=5)
    pm = port_lattice(jm)
    C0 = random_sigma(np.random.default_rng(6), 128, jm.N)
    Ej, _ = rt.sweepMC(jm, 2.0, sweeps=60, step=6, chains=64, seed=2,
                       C0=C0[:64], backend="xla")
    Ep, st = pt.sweepMC(pm, 2.0, 60, step=6, chains=128, seed=2, C0=C0, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-sweep"

    def tail(Es):
        e = np.asarray(Es, np.float64)[:, 5:].mean(axis=1) / jm.N
        return e.mean(), e.std() / np.sqrt(len(e))

    (a, sa), (b, sb) = tail(Ep.numpy()), tail(Ej)
    assert abs(a - b) < max(5 * np.hypot(sa, sb), 0.02), (a, b)


# ---- the redesigned kernel's rows and launch plan (ops/sweep.py) ----


def _coords_table(L, D):
    """neighbour_table from coordinates: site of colour c in pair k, then
    x + e_d and x - e_d (periodic) for d = 0..D-1, row-major sites."""
    n = L ** D
    out = np.empty((2, n // 2, 1 + 2 * D), dtype=np.int64)
    for c in (0, 1):
        for k in range(n // 2):
            i = next(j for j in (2 * k, 2 * k + 1)
                     if sum(np.unravel_index(j, (L,) * D)) % 2 == c)
            x = np.array(np.unravel_index(i, (L,) * D))
            row = [i]
            for d in range(D):
                for sh in (1, -1):
                    y = x.copy()
                    y[d] = (y[d] + sh) % L
                    row.append(int(np.ravel_multi_index(tuple(y), (L,) * D)))
            out[c, k] = row
    return out


@pytest.mark.parametrize("L,D", [(L, D) for D in (2, 3) for L in (4, 6, 16)]
                         + [(4, 1), (16, 1), (4, 4), (6, 4)])
def test_neighbour_table_is_periodic(L, D):
    """The precomputed rows' sites and neighbours equal the periodic
    indexing of the lattice (coordinates mod L), each site once."""
    tab = sweep.neighbour_table(L, D)
    np.testing.assert_array_equal(tab, _coords_table(L, D))
    np.testing.assert_array_equal(np.sort(tab[:, :, 0].reshape(-1)),
                                  np.arange(L ** D))


def _fields_lattice(L, D, seed):
    m = pt.GraphEA(L, D, (-1, 1), seed=seed, **CPU)
    h = np.random.default_rng(seed).integers(-2, 3, m.N)
    return dataclasses.replace(m, h=torch.as_tensor(h, dtype=m.h.dtype))


def _row_fields(rows, D, s, swar):
    """The kernel's field of each row's site for spins s [B, N] (+-1 int8),
    as it computes it: h + sum J s, or from the packed sum of four chains'
    bits, A - 2 * byte_c(K * 0x01010101 + sum J * word) (mod 2^32)."""
    r = rows.long()    # rows [..., row_len(D)] of a SiteRows' data
    site, nb = r[..., 0], r[..., 1:1 + 2 * D]
    J, A, K4 = r[..., 1 + 2 * D:1 + 4 * D], r[..., 1 + 4 * D], r[..., 2 + 4 * D]
    if not swar:
        return (A[None] + (J[None] * s.long()[:, nb]).sum(-1)), site
    B = s.shape[0]
    b = torch.cat([(s < 0).long(), torch.zeros((-B % 4, s.shape[1]),
                                               dtype=torch.long)])
    word = sum(b[c::4] << (8 * c) for c in range(4))        # [B/4, N]
    acc = ((K4 & 0xFFFFFFFF)[None] + (J[None] * word[:, nb]).sum(-1)) \
        % 2 ** 32
    lf = torch.stack([A[None] - 2 * ((acc >> (8 * c)) & 0xFF)
                      for c in range(4)], dim=1).reshape(-1, *site.shape)
    return lf[:B], site


@pytest.mark.parametrize("L,D", [(4, 2), (6, 2), (6, 3), (16, 3), (8, 1),
                                 (4, 4)])
@pytest.mark.parametrize("swar", [False, True])
def test_site_rows_give_local_fields(L, D, swar):
    """site_rows (one chain a lane, and the packed sum of four chains a
    lane) give every site's local field, integer fields included."""
    m = _fields_lattice(L, D, 3)
    Jp, Jm = sweep.dir_tables(m)
    assert sweep.swar_ok(Jp, Jm, D)
    rows = sweep.site_rows(torch.as_tensor(Jp), torch.as_tensor(Jm), L, D,
                           swar)
    assert rows.swar == swar
    assert rows.data.shape == (2, m.N // 2, sweep.row_len(D))
    s = torch.as_tensor(random_sigma(np.random.default_rng(L + D), 11, m.N))
    lf, site = _row_fields(rows.data, D, s, swar)
    want = m.local_fields(s)
    for c in (0, 1):
        assert torch.equal(lf[:, c], want[:, site[c]].long())


def _epilogue(rows, D, s, swar):
    """The kernel's fields epilogue in torch: site i takes the row of pair
    i // 2 of colour 0 when that row's site is i, else colour 1's; its
    field from the row (`_row_fields`), written in [B, N] order."""
    i = torch.arange(s.shape[1])
    first = rows[0, i >> 1]
    row = torch.where((first[:, 0] == i)[:, None], first, rows[1, i >> 1])
    lf, site = _row_fields(row, D, s, swar)
    assert torch.equal(site.long(), i)
    return lf


def _emulate(rows, D, swar, sigma, E, th, n_sweeps, beta2s, seed):
    """The kernel's loop in torch: per colour every row's site at once,
    its field from the rows (`_row_fields`), its bits the word of its pair,
    the acceptance of the table or exp path; then the fields epilogue of a
    call's last launch (`_epilogue`). Returns spins, E and the fields."""
    s = sigma.clone()
    dE = torch.zeros(s.shape[0], dtype=torch.int64)
    n_th = th.shape[0]
    beta = torch.tensor(beta2s, dtype=torch.float32)
    for sw in range(n_sweeps):
        for c in (0, 1):
            lf, site = _row_fields(rows[c:c + 1], D, s, swar)
            site = site[0]
            half = s[:, site].long() * lf[:, 0]
            if n_th:
                thr = th[(half.clamp(1, n_th) - 1)].long()
            else:
                p = torch.exp(-beta * half.float())
                thr = (p * 4294967296.0 - 2147483648.0).clamp(
                    -2147483648.0, 2147483520.0).to(torch.int32).long()
            bits = prng.sweep_bits(seed, 0, s.shape[0], s.shape[1], sw, c,
                                   "cpu")[:, site].long()
            acc = (half <= 0) | (bits < thr)
            s[:, site] = torch.where(acc, -s[:, site], s[:, site])
            dE += torch.where(acc, half, 0).sum(1)
    return s, (E.long() + 2 * dE).to(torch.int32), _epilogue(rows, D, s,
                                                             swar)


#: the kernel's code paths (threshold table, field column, exp) at D = 1-4
LOOP_CASES = {
    "table-3d": lambda: pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU),
    "field-2d": lambda: _fields_lattice(6, 2, 4),
    "exp-3d": lambda: pt.GraphEA(4, 3, (-1.5, 0.5), seed=6, **CPU),
    "table-4d": lambda: pt.GraphEA(4, 4, (-1, 1), seed=5, **CPU),
    "field-1d": lambda: _fields_lattice(16, 1, 4),
    "exp-4d": lambda: pt.GraphEA(4, 4, (-1.5, 0.5), seed=6, **CPU)}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_kernel_loop_equals_plain(case):
    """The kernel's arithmetic, emulated from its rows on both lane layouts
    where the couplings allow four chains a lane, gives the plain version's
    spins and energies bit for bit over 6 sweeps (5 chains: a ragged group
    of four), and its fields epilogue the final spins' local_fields; D = 1
    and 4 take the kernel's run-time-D instantiation."""
    m = LOOP_CASES[case]()
    sw = Sweeper(m, 1.5)
    exp = case.startswith("exp")
    assert sw.table == (not exp) and sw.rows.swar == (not exp)
    st = pt.init_state(m, 5, seed=2, **CPU)
    s, E = st.sigma.clone(), st.E.clone()
    sweep.sweep_chunk_reference(s, E, sw.Jp, sw.Jm, sw.th, L=sw.L, D=sw.D,
                                n_sweeps=6, beta2s=sw.beta2s, seed=SEED)
    for swar in ({False, sw.rows.swar}):
        rows = sweep.site_rows(sw.Jp, sw.Jm, sw.L, sw.D, swar).data
        es, eE, ea = _emulate(rows, sw.D, swar, st.sigma, st.E, sw.th, 6,
                              sw.beta2s, SEED)
        assert torch.equal(es, s) and torch.equal(eE, E)
        assert torch.equal(ea, m.local_fields(s).long())
    assert not torch.equal(s, st.sigma)


@pytest.mark.parametrize("L,D", [(4, 2), (6, 2), (6, 3), (16, 3), (8, 1),
                                 (4, 4)])
@pytest.mark.parametrize("swar", [False, True])
def test_epilogue_gives_local_fields(L, D, swar):
    """The fields epilogue's site-to-row lookup and arithmetic give every
    site's local field on random spins, integer fields included, for 11
    chains (a ragged group of four)."""
    m = _fields_lattice(L, D, 5)
    Jp, Jm = sweep.dir_tables(m)
    rows = sweep.site_rows(torch.as_tensor(Jp), torch.as_tensor(Jm), L, D,
                           swar)
    s = torch.as_tensor(random_sigma(np.random.default_rng(L * D), 11, m.N))
    assert torch.equal(_epilogue(rows.data, D, s, swar),
                       m.local_fields(s).long())


@pytest.mark.parametrize("case", ["table-3d", "field-2d", "exp-3d"])
def test_plain_version_writes_the_fields(case):
    """sweep_chunk_reference (and the CPU wrapper, through the Sweeper)
    with `aux` fills it with the final spins' local_fields, and leaves
    their spins and energies as a call without it gives them."""
    m = LOOP_CASES[case]()
    sw = Sweeper(m, 1.5)
    st = pt.init_state(m, 5, seed=2, **CPU)
    kw = dict(L=sw.L, D=sw.D, n_sweeps=3, beta2s=sw.beta2s, seed=SEED)
    s0, E0 = st.sigma.clone(), st.E.clone()
    sweep.sweep_chunk_reference(s0, E0, sw.Jp, sw.Jm, sw.th, **kw)
    s1, E1 = st.sigma.clone(), st.E.clone()
    a1 = torch.full(s1.shape, 7, dtype=torch.int32)
    sweep.sweep_chunk_reference(s1, E1, sw.Jp, sw.Jm, sw.th, aux=a1, **kw)
    s2, E2 = st.sigma.clone(), st.E.clone()
    a2 = torch.zeros_like(a1)
    sw(s2, E2, seed=SEED, n_sweeps=3, aux=a2)
    for s, E in ((s1, E1), (s2, E2)):
        assert torch.equal(s, s0) and torch.equal(E, E0)
    assert torch.equal(a1, m.local_fields(s0)) and torch.equal(a2, a1)
    assert not torch.equal(s0, st.sigma)


@pytest.mark.parametrize("sweeps,source", [(7, "kernel"), (2, "torch")])
def test_sweepmc_names_the_fields_source(sweeps, source):
    """Route (a) takes the final fields from its last launch
    (LAST_ROUTE["aux"] "kernel"); a call with no checkpoint (sweeps <
    step) launches nothing and takes them from init_aux ("torch"). Either
    way they are the model's local_fields of the final spins."""
    m = _field_lattice(pt)
    Es, st = pt.sweepMC(m, 1.0, sweeps, step=3, chains=5, seed=3, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-sweep"
    assert pt.LAST_ROUTE["aux"] == source
    assert Es.shape == (5, sweeps // 3)
    assert st.aux.dtype == m.Jd.dtype == torch.int32
    assert torch.equal(st.aux, m.local_fields(st.sigma))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "strides"])
def test_wrapper_checks_aux(bad):
    """sweep_chunk refuses an `aux` of another shape, dtype or device, or
    not contiguous, before it touches the state."""
    pm = pt.GraphEA(4, 2, seed=1, **CPU)
    psw = Sweeper(pm, 1.0)
    st = pt.init_state(pm, 4, seed=2, **CPU)
    B, N = st.sigma.shape
    aux, match = {
        "shape": (torch.zeros(B, N + 1, dtype=torch.int32), "aux"),
        "dtype": (torch.zeros(B, N, dtype=torch.int64), "aux"),
        "device": (torch.zeros(B, N, dtype=torch.int32, device="meta"),
                   "meta"),
        "strides": (torch.zeros(N, B, dtype=torch.int32).t(),
                    "contiguous")}[bad]
    sigma, E = st.sigma.clone(), st.E.clone()
    with pytest.raises(ValueError, match=match):
        sweep_chunk(sigma, E, psw.Jp, psw.Jm, psw.th, L=4, D=2, n_sweeps=1,
                    beta2s=2.0, seed=1, aux=aux)
    assert torch.equal(sigma, st.sigma) and torch.equal(E, st.E)


def test_swar_bound():
    """Four chains a lane only where every site's sum of |J| is at most
    127: +-J lattices yes, the fixed-point couplings (scale 1e-5) no."""
    for m, want in ((pt.GraphEA(4, 3, (-1, 1), seed=5, **CPU), True),
                    (pt.GraphEA(4, 3, (-1.5, 0.5), seed=6, **CPU), False)):
        Jp, Jm = sweep.dir_tables(m)
        assert sweep.swar_ok(Jp, Jm, m.D) == want
    Jp = np.full((8, 2), 32, dtype=np.int32)
    assert sweep.swar_ok(Jp, -np.full((8, 2), 31, dtype=np.int32), 2)
    assert not sweep.swar_ok(Jp, np.full((8, 2), 32, dtype=np.int32), 2)


#: the H100's shared memory a SM and a block may have (opt-in), its SMs
SM_SMEM, BLOCK_SMEM, N_SM = 233472, 232448, 132


def _sweep_info(T, smem, swar):
    """sweep_plan's info(T, smem) of a card like the H100: blocks per SM
    by threads and shared memory (4 KB static, 1 KB reserved a block)."""
    dyn = BLOCK_SMEM - 4096
    fits = smem <= dyn
    return [min(2048 // T, SM_SMEM // (smem + 4096 + 1024)) if fits else 0,
            64, 0, 4096, dyn]


@pytest.mark.parametrize("N,B,swar,chains", [
    (4096, 8192, True, 32),    # the bench: 256 blocks, 2 a SM at most
    (4096, 8192, False, 32),
    (4096, 1024, True, 8),     # 128 blocks: one a SM
    (4096, 1003, True, 8),     # ragged: the last block has 3 chains
    (4096, 5, True, 4),        # four chains a lane: at least 4 a block
    (4096, 5, False, 1),
    (1024, 2048, True, 16),    # EA-2D L=32
    (25_000, 8192, True, 4),   # N * (C + 4) caps C
    (50_000, 8192, True, 2)])  # no block of 4 fits: one chain a lane
def test_sweep_plan(N, B, swar, chains):
    p = sweep.sweep_plan(N, B, 6, N_SM, _sweep_info, swar)
    assert p["chains"] == chains and p["threads"] == sweep.THREADS
    assert p["blocks"] == -(-B // chains)
    four = swar and N <= 28_000
    assert p["smem"] == 6 * 4 + N * sweep.site_bytes(chains)
    assert p["swar"] == four
    assert p["lanes"] == ("4 chains" if four else "1 chain")


def test_sweep_plan_refuses():
    """Above a block's shared memory at one chain (the kernel's limit, as
    before the redesign) the plan refuses."""
    for swar in (False, True):
        with pytest.raises(NotImplementedError, match="shared memory"):
            sweep.sweep_plan(BLOCK_SMEM - 4096, 64, 6, N_SM, _sweep_info,
                             swar)
        p = sweep.sweep_plan(200_000, 64, 6, N_SM, _sweep_info, swar)
        assert p["chains"] == 1 and not p["swar"]


@pytest.mark.parametrize("D", [1, 4])
def test_other_dimensions_take_the_kernel(D):
    """Even-L integer lattices of every D take the checkerboard kernel, as
    in the JAX package: D = 1 and 4 run its run-time-D instantiation."""
    m = pt.GraphEA(8 if D == 1 else 4, D, (-1, 1), seed=2, **CPU)
    assert isinstance(m, pt.LatticeEA) and sweep.sweep_eligible(m)
    Es, st = pt.sweepMC(m, 1.0, 3, chains=4, seed=1, **CPU)
    assert pt.LAST_ROUTE["backend"] == "kernel-sweep"
    assert torch.equal(m.energy(st.sigma), st.E)


@pytest.mark.parametrize("L,D", [(16, 1), (4, 4)])
def test_other_dimensions_match_jax_interpret(sweep_pallas, L, D):
    """On EA-1D and EA-4D the port's sweep equals the JAX Pallas kernel in
    interpret mode bit for bit (spins and energies after 10 sweeps on
    identical bits)."""
    jm = rt.GraphEA(L, D, (-1, 1), seed=5)
    sigma = random_sigma(np.random.default_rng(4), B, jm.N)
    sig_j = jnp.asarray(sigma)
    E0 = np.asarray(jax.vmap(jm.energy)(sig_j)).astype(np.int32)
    jsw = sweep_pallas.PallasSweeper(jm, 1.5, block_chains=B)
    sig_o, E_o = jsw(sig_j, jnp.asarray(E0), seed=SEED, n_sweeps=10)
    pm = port_lattice(jm)
    psw = Sweeper(pm, 1.5)
    assert psw.D == D and psw.rows.swar
    sig = torch.from_numpy(sigma.copy())
    E = torch.from_numpy(E0.copy())
    psw(sig, E, seed=SEED, n_sweeps=10, bits=sweep_bits(SEED, B, pm.N))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_o))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_o))
    assert not torch.equal(sig, torch.from_numpy(sigma))
