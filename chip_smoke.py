#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (rrrmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every CUDA kernel from rrrmc_tpu_torch/csrc/ (nvcc, sm_90a, one process
   per source, all started together).
2. Kernel versus plain: each kernel and its plain torch version get the same
   inputs and the same Philox bits, at the shapes the main paths give the
   kernels. The RRG path: GraphRRG(10_000, 3) (+-J) and GraphRRGNormal, 1024
   chains, the site kernel for 10 000 moves, the race kernel in bkl, wtm
   and rrr mode for one chunk of 1024 moves. The EA-3D path: the checkerboard
   sweep kernel on GraphEA(16, 3, +-1, seed=42) with 8192 chains at beta=2,
   and at 1024 chains on its field column and its exp path; the race kernel
   on the same lattice (the port of the TPU lattice race kernel), 1024
   chains, one 1024-move chunk per mode. Integer couplings must agree
   exactly; float couplings within the tolerances stated in `_compare`.
   Both times are printed.
3. Main paths, through the public API, each run with every launch count set
   to 0 just before it and read just after:
   - RRG: standardMC(backend="kernel"), rrrMC, bklMC and wtmMC on
     GraphRRG(10_000, 3) with 1024 chains at beta=2, then bklMC on
     GraphRRGNormal;
   - EA-3D: the benchmark line (`rrrmc_tpu_torch.bench`: sweepMC on EA-3D
     L=16 with 8192 chains) and its metric line, then bklMC, wtmMC and rrrMC
     on that lattice with 1024 chains, and sweepMC on GraphRRG(10_000, 3)
     through the site-sweep route.
   - dense SK: sweepMC on GraphSK(1024, seed=4) with 8192 chains and on
     GraphSK(8192, seed=4) with 2048 chains at beta=2 (the dense sweep
     kernel), bklMC and wtmMC at beta=4 and rrrMC at beta=2 on
     GraphSK(1024) with 1024 chains, bklMC on GraphSKNormal(4096) with 128
     chains, and bklMC on densify(GraphRRG(10_000, 3)) beside bklMC on the
     sparse GraphRRG(10_000, 3), 1024 chains, beta=4, one seed (the dense
     and the sparse race kernel make the same moves from the same streams).
     GraphSK(1024) is built, and sampled by sweepMC and bklMC, with no
     device given: the card is the default.
   - tau-EO (`eo_path`): extremal_opt(tau=1.4) with no device argument on
     the physics rows of bench_all_results.json at their chains and moves
     (GraphRRG(10_000, 3, seed=7) with 128 chains and 200 000 moves,
     GraphEA(8, 3, seed=42) with 1024 and 400 000, GraphSK(1024, seed=4)
     with 1024 and 100 000; best E/N within 2% of the JAX package's), then
     20 000 moves on GraphRRG(10_000, 3, seed=7) and its densified copy
     (1024 chains, one seed: identical results), GraphRRGNormal(10_000, 3,
     seed=7) with 1024 chains and GraphSKNormal(4096) with 512.
   - PSpin3 (`pspin_path`): GraphPSpin3(7500, 3, seed=7), built with no
     device argument, through bklMC at beta=1.5 and rrrMC at beta=1.0 with
     128 chains (scripts/bench_all.py's bkl_pspin7500 and rrr_pspin7500
     rows), wtmMC at beta=1.5 with 128 chains, bklMC with 1024 chains, and
     extremal_opt(tau=1.4) with 128 chains and 100 000 moves, whose best
     E/N must lie within EO_ROW_RTOL of the eo_pspin7500 row;
   - K-SAT (`sat_path`): GraphSAT(10_000, 3, 4.2, seed=167) through bklMC,
     wtmMC and rrrMC at beta=4 with 128 chains (bench_all.py's sat
     section) and extremal_opt(tau=1.4) with 128 chains and 30 000 moves,
     whose mean Emin must lie within SAT_EO_RTOL of the sat_eo row's (its
     standard error over the chains, and the best, are printed beside).
   After each run: the launch counter rose, LAST_ROUTE names the CUDA
   kernel route, the checkpoint series is finite and of the expected shape,
   and the running energy equals energy(sigma) (exactly for integer
   couplings); for EO, E and Emin equal the energies of sigma and
   sigma_min (exactly for integer couplings, within 1e-4 * N for float
   ones) and itmin lies in [0, moves].

The dense-model phases of 2 are the dense sweep kernel on GraphSK(1024)
with 8192 chains (3 sweeps) and GraphSK(8192) with 2048 chains (1 sweep),
then on its other code paths with 1024 chains (1 sweep each): GraphSK(1100)
(N % 4 != 0, the scalar commit) and GraphSK(1024) with integer fields; and
the dense race kernel on GraphSK(1024) with 1024 chains at beta=4 (one
1024-move chunk per mode), densify(GraphRRG(10_000, 3)) with 1024 chains
and GraphSKNormal(4096) with 128 chains (bkl), the main paths' shapes.
The EO phases of 2 are the sparse EO kernel on GraphRRG(10_000, 3,
seed=7) and GraphRRGNormal(10_000, 3, seed=7) and on GraphEA(8, 3, seed=42)
(the port of the lattice branch of `_eo_kernel`), and the dense EO kernel
on GraphSK(1024) (its dense branch) and on densify(GraphRRG(10_000, 3,
seed=7)) and GraphSKNormal(4096) (the streamed kernel's regime), 1024
chains (512 for GraphSKNormal(4096)), EO_CMP_MOVES moves each. Each pair of
TPU kernels that the VMEM size split (`_sk_kernel` / `_sk_kernel_hbm`,
`_rejfree_dense_kernel` / `_rejfree_stream_kernel`, `_eo_kernel`'s dense
branch / `_eo_stream_kernel`) is one CUDA kernel here; the record lists
each TPU kernel with the cases and main-path runs of the regime the TPU
would have sent to it (J within VMEM: the N=1024 models; else streamed).

The hypergraph phases of 2 are the PSpin3 race kernel (the sparse race
kernel with the hypergraph flip) in bkl, wtm and rrr mode for one 1024-move
chunk and the PSpin3 EO kernel for EO_CMP_MOVES moves on
GraphPSpin3(7500, 3, seed=7), and the SAT race and EO kernels alike on
GraphSAT(10_000, 3, 4.2, seed=167), all with 128 chains: every output
EQUAL (integer energies, cavity sums and clause counts). Their flips update
2K cavity sums (PSpin3) and the dE of the Cmax * K variables of the
winner's clauses (SAT): `_ops_race` and `_ops_eo` count those.

Every kernel entry of the record carries `bound_ms`, the least time the
card could take for the timed call: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s, and its
operations over 67 TFLOP/s (the float32 and integer work runs outside the
tensor cores), counted from this run's data as `_ops_*` say, plus the dense
sweep's rank-W commit (the TPU kernel's int8 MXU product) over the int8
tensor-core rate, 1,979 TOP/s; and
`library_ms`, null: no single PyTorch call computes a Metropolis sweep, a
race move or an EO move.

The last lines are the kernels' JSON record, the card line, and
{"ok": true, "device": {...}}. It exits 1 without a result when no CUDA
device is visible.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

SEED = 167
N_MAIN = 10_000
BETA = 2.0
CHAINS = 1024
#: main-path run lengths, each sized to take seconds on an H100
ITERS_MET, ITERS_RRR = 3_000_000, 32_768
ITERS_BKL, WTM_SAMPLES = 2_000_000, 200
#: EA-3D path: the race samplers' run lengths on the L=16 lattice, and the
#: site-sweep route's sweeps on GraphRRG
EA_ITERS_RRR, EA_ITERS_BKL, EA_WTM_SAMPLES = 16_384, 1_000_000, 100
RRG_SWEEPS = 100
#: moves per kernel-versus-plain comparison: the race kernel gets the main
#: path's chunk; the site kernel a slice of its launch (the plain version
#: takes ~0.3 ms per move); the sweep kernel 100 sweeps (its plain version
#: takes ~20 ms per sweep at 8192 chains)
SITE_MOVES, RACE_MOVES, SWEEPS = 10_000, 1024, 100
#: dense SK path: sweeps of the two sweepMC runs, and the race samplers'
#: run lengths on GraphSK(1024) and the other dense models
SK_SWEEPS, SK8_SWEEPS = 500, 20
SK_ITERS_BKL, SK_ITERS_RRR, SK_WTM_SAMPLES = 1_000_000, 16_384, 500
SKN_ITERS_BKL, DRRG_ITERS_BKL = 2_000_000, 10_000_000
#: sweeps per dense-sweep comparison (the plain version takes ~1 ms per
#: site at these shapes)
SK_CMP_SWEEPS, SK8_CMP_SWEEPS = 3, 1
#: tau-EO: tau, the moves of each kernel-versus-plain comparison, the main
#: path's moves where no physics row sets them, and the moves of the physics
#: rows of bench_all_results.json (scripts/bench_all.py: bench_eo_sparse,
#: bench_eo), whose chains and best E/N the file holds
EO_TAU, EO_CMP_MOVES, EO_MOVES = 1.4, 300, 20_000
EO_ROW_MOVES = {"eo_rrg1e4_sparse": 200_000, "eo_ea3d": 400_000,
                "eo_dense_sk": 100_000, "eo_pspin7500": 100_000}
#: the spread of a best E/N over 128-1024 chains: the physics rows' tolerance
EO_ROW_RTOL = 0.02
#: hypergraph paths: the instances of scripts/bench_all.py (bench_pspin,
#: sat_section), their chains, betas and run lengths, and the tolerance of
#: the SAT EO row's mean best energy: 5% of the row, a guard against a gross
#: fault of the physics, not a tight test (it spans many standard errors of
#: the mean over 128 chains, which the run prints beside it); the kernel is
#: held bit for bit against its plain version above
PSPIN_N, PSPIN_K, PSPIN_SEED, SAT_N, SAT_K, SAT_ALPHA = 7500, 3, 7, 10_000, \
    3, 4.2
HYPER_CHAINS, PS_BETA_BKL, PS_BETA_RRR, SAT_BETA = 128, 1.5, 1.0, 4.0
PS_ITERS_BKL, PS_ITERS_RRR, PS_WTM_SAMPLES = 2_000_000, 100_000, 200
SAT_ITERS_BKL, SAT_ITERS_RRR, SAT_WTM_SAMPLES = 4_000_000, 50_000, 200
SAT_EO_MOVES, SAT_EO_RTOL = 30_000, 0.05
#: the device every phase runs on (the script refuses to run without one)
DEV = "cuda"
REPLACES = {
    "site_metropolis": "rrrmc_tpu/ops/site_pallas.py:47",
    "rejfree_sparse": "rrrmc_tpu/ops/rejfree_pallas.py:870",
    "rejfree_lattice": "rrrmc_tpu/ops/rejfree_pallas.py:118",
    "sweep_checkerboard": "rrrmc_tpu/ops/sweep_pallas.py:64",
    "sk_sweep": "rrrmc_tpu/ops/sk_pallas.py:77",
    "sk_sweep_hbm": "rrrmc_tpu/ops/sk_pallas.py:115",
    "rejfree_dense": "rrrmc_tpu/ops/rejfree_pallas.py:349",
    "rejfree_stream": "rrrmc_tpu/ops/rejfree_pallas.py:559",
    "eo_sparse": "rrrmc_tpu/ops/eo_pallas.py:449",
    "eo_lattice": "rrrmc_tpu/ops/eo_pallas.py:66",
    "eo_dense": "rrrmc_tpu/ops/eo_pallas.py:66",
    "eo_stream": "rrrmc_tpu/ops/eo_pallas.py:255",
    "rejfree_pspin": "rrrmc_tpu/ops/rejfree_pallas.py:1122",
    "eo_pspin": "rrrmc_tpu/ops/eo_pallas.py:600",
    "rejfree_sat": "rrrmc_tpu/ops/sat_pallas.py:306",
    "eo_sat": "rrrmc_tpu/ops/sat_pallas.py:528",
}
SOURCES = {
    "site_metropolis": "rrrmc_tpu_torch/csrc/site.cu",
    "rejfree_sparse": "rrrmc_tpu_torch/csrc/rejfree_sparse.cu",
    "rejfree_lattice": "rrrmc_tpu_torch/csrc/rejfree_sparse.cu",
    "sweep_checkerboard": "rrrmc_tpu_torch/csrc/sweep.cu",
    "sk_sweep": "rrrmc_tpu_torch/csrc/sk_sweep.cu",
    "sk_sweep_hbm": "rrrmc_tpu_torch/csrc/sk_sweep.cu",
    "rejfree_dense": "rrrmc_tpu_torch/csrc/rejfree_dense.cu",
    "rejfree_stream": "rrrmc_tpu_torch/csrc/rejfree_dense.cu",
    "eo_sparse": "rrrmc_tpu_torch/csrc/eo_sparse.cu",
    "eo_lattice": "rrrmc_tpu_torch/csrc/eo_sparse.cu",
    "eo_dense": "rrrmc_tpu_torch/csrc/eo_dense.cu",
    "eo_stream": "rrrmc_tpu_torch/csrc/eo_dense.cu",
    "rejfree_pspin": "rrrmc_tpu_torch/csrc/rejfree_sparse.cu",
    "eo_pspin": "rrrmc_tpu_torch/csrc/eo_sparse.cu",
    "rejfree_sat": "rrrmc_tpu_torch/csrc/rejfree_sat.cu",
    "eo_sat": "rrrmc_tpu_torch/csrc/eo_sat.cu",
}
#: the H100 SXM's published device-memory rate, float32 rate outside the
#: tensor cores, and int8 tensor-core rate (dense)
HBM_BYTES_PER_S, F32_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 67e12, 1.979e15
#: operations of one Philox4x32-10 call: 10 rounds of two 32-bit products
#: with their high halves, two xors and two key additions
PHILOX_OPS = 80


def require(ok: bool, what: str):
    """A check that stays under python -O."""
    if not ok:
        raise AssertionError(what)


def bound(nbytes: float, ops: float, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations' time: `ops` over the float32 rate plus `int8_ops` (the
    products a TPU kernel ran on its MXU) over the int8 tensor-core rate."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / F32_OPS_PER_S + int8_ops / INT8_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _ops_race(N, moves, applied, mode, flip_sites):
    """A race move over N sites: a quarter Philox call, the score (two logs,
    an add, a compare) and the Boltzmann term (3) per site, the min and the
    log-sum-exp pass (4 per site), rrr's z' pass again (5 per site); an
    applied flip updates `flip_sites` fields (a product and an add each)."""
    per_site = PHILOX_OPS / 4 + 8 + 4 + (5 if mode == "rrr" else 0)
    return moves * N * per_site + applied * 2 * flip_sites


def _ops_eo(N, moves, flip_sites, bins):
    """A tau-EO move over N sites: two Philox calls (the rank draw and at
    least the winner's tie group), the key and the class compare per site
    in the tie race (3), the select (a scan over the histogram's `bins`,
    or for bins == 0 four radix passes of 4 per site) and the flip, which
    updates `flip_sites` fields (a product and an add each, and two bin
    moves each with a histogram)."""
    select = bins if bins else 4 * 4 * N
    flip = flip_sites * (4 if bins else 2)
    return moves * (2 * PHILOX_OPS + 3 * N + select + flip)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reference(chunk):
    """A kernel wrapper's plain version: `<name>_reference` of its module."""
    return getattr(sys.modules[chunk.__module__],
                   chunk.__name__ + "_reference")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _events_ms(fn) -> float:
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _compare(name, integer, kern: dict, plain: dict, B: int, N: int):
    """Kernel versus plain outputs. Integer couplings: every output must be
    EQUAL, bit for bit: spins, local fields, energies, accepted counts, the
    coordinates and both streams, and the float32 z/N sums and wtm clock
    too, because the plain version adds z in the kernel's order
    (ops/rejfree.py::block_sum) and both build without FMA contraction or
    fast math. Float couplings: at most one chain of B may diverge (a
    float32 local field that rounds differently can flip a borderline
    acceptance or race, after which that chain follows another path); on
    the others lf within 1e-3, E within 1e-5 * N, z/N and the wtm clock
    within rtol 1e-4 (float32 accumulation). Returns the max abs
    difference over E and lf."""
    import torch

    same = (kern["sigma"] == plain["sigma"]).all(dim=-1) \
        & (kern["acc"] == plain["acc"])
    if "coord" in kern and kern["coord"].dtype == torch.int32:
        same &= kern["coord"] == plain["coord"]
    bad = int((~same).sum())
    errs = {}
    for key in ("E", "lf"):
        d = (kern[key].double() - plain[key].double()).abs()
        d = d[same] if d.dim() == 1 else d[same, :]
        errs[key] = float(d.max()) if d.numel() else 0.0
    float_keys = [k for k in ("zacc", "coord", "cs") if k in kern
                  and kern[k].dtype == torch.float32]
    for key in float_keys:
        a, b = kern[key].double(), plain[key].double()
        if key == "cs":
            a, b = a[:, same], b[:, same]
        else:
            a, b = a[same], b[same]
        rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) \
            if a.numel() else 0.0
        errs[key + "_rel"] = rel
    if integer:
        if bad:
            raise AssertionError(f"{name}: {bad} chains differ (integer)")
        for key in ("E", "lf"):
            if errs[key] != 0.0:
                raise AssertionError(f"{name}: {key} differs by {errs[key]}")
        for key in ("coord", "zacc", "cs", "es"):
            if key in kern and not torch.equal(kern[key], plain[key]):
                raise AssertionError(f"{name}: {key} differs")
    else:
        if bad > 1:
            raise AssertionError(f"{name}: {bad} of {B} chains diverge")
        if errs["lf"] > 1e-3 or errs["E"] > 1e-5 * N:
            raise AssertionError(f"{name}: errors {errs}")
        for key in float_keys:
            if errs[key + "_rel"] > 1e-4:
                raise AssertionError(f"{name}: {key} rel err "
                                     f"{errs[key + '_rel']}")
    return bad, max(errs["E"], errs["lf"]), errs


def site_case(model, label, card):
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import site
    from rrrmc_tpu_torch.samplers.common import init_lfT

    B, n_moves = CHAINS, SITE_MOVES
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    sites = torch.randint(0, model.N, (n_moves,), generator=g, device=DEV,
                          dtype=torch.int32)
    base = dict(sigT=st.sigma.t().contiguous(), lfT=init_lfT(model, st.sigma),
                E=st.E.clone(), acc=torch.zeros(B, dtype=torch.int32,
                                                device=DEV))
    kw = dict(seed=SEED, beta_s=BETA * model.scale, move0=0, chain0=0)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a):
        fn(a["sigT"], a["lfT"], a["E"], a["acc"], sites, model.neigh,
           model.J, **kw)

    run(site.site_chunk, fresh())                       # warm-up
    k = fresh()
    ms = _events_ms(lambda: run(site.site_chunk, k))
    p = fresh()
    plain_ms = _events_ms(lambda: run(site.site_chunk_reference, p))
    kern = {"sigma": k["sigT"].t(), "lf": k["lfT"].t(), "E": k["E"],
            "acc": k["acc"]}
    plain = {"sigma": p["sigT"].t(), "lf": p["lfT"].t(), "E": p["E"],
             "acc": p["acc"]}
    integer = not model.J.dtype.is_floating_point
    bad, err, errs = _compare(f"site {label}", integer, kern, plain, B,
                              model.N)
    # a move: one Philox call, dE, exp and the compare; an applied flip
    # updates K neighbours' fields
    applied = float(k["acc"].double().sum())
    bound_ms, bound_by = bound(
        2 * _nbytes(*base.values()) + _nbytes(sites, model.neigh, model.J),
        B * n_moves * (PHILOX_OPS + 4) + applied * 2 * model.K)
    print(f"site_metropolis {label} B={B} moves={n_moves}: kernel {ms:.3f} ms"
          f", plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms ({bound_by}), "
          f"diverged chains {bad}, max abs err {err:.3g} [{card}]")
    return {"kernel": "site_metropolis", "case": label, "B": B,
            "moves": n_moves, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": bad, "max_abs_err": err, "errs": errs}


def sweep_case(model, label, B, card):
    """The checkerboard kernel against its plain version: SWEEPS sweeps of B
    chains from one random start, one Philox seed; spins and energies must
    be EQUAL (integer arithmetic; the exp path's float32 exp and threshold
    round alike under -fmad=false)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import sweep

    sw = sweep.Sweeper(model, BETA)
    st = rt.init_state(model, B, seed=SEED, device=DEV)

    def run(fn):
        sigma, E = st.sigma.clone(), st.E.clone()
        ms = _events_ms(lambda: fn(
            sigma, E, sw.Jp, sw.Jm, sw.th, L=sw.L, D=sw.D, n_sweeps=SWEEPS,
            beta2s=sw.beta2s, seed=SEED))
        return sigma, E, ms

    run(sweep.sweep_chunk)                                # warm-up
    ks, kE, ms = run(sweep.sweep_chunk)
    ps, pE, plain_ms = run(sweep.sweep_chunk_reference)
    require(torch.equal(ks, ps) and torch.equal(kE, pE),
            f"sweep {label}: kernel and plain differ "
            f"({int((ks != ps).any(dim=1).sum())} chains)")
    require(torch.equal(model.energy(ks), kE),
            f"sweep {label}: E != energy(sigma)")
    # an attempted flip: a quarter Philox call, the 2D neighbour products
    # and sums, the threshold and the compare
    bound_ms, bound_by = bound(
        2 * _nbytes(st.sigma, st.E) + _nbytes(sw.Jp, sw.Jm, sw.th),
        B * model.N * SWEEPS * (PHILOX_OPS / 4 + 4 * model.D + 3))
    print(f"sweep_checkerboard {label} B={B} sweeps={SWEEPS} table="
          f"{sw.table}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.3g} ms ({bound_by}), equal [{card}]")
    return {"kernel": "sweep_checkerboard", "case": label, "B": B,
            "sweeps": SWEEPS, "table": sw.table, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": 0, "max_abs_err": 0.0}


def rejfree_case(model, label, mode, card, kernel="rejfree_sparse",
                 B=CHAINS, beta=BETA):
    """A race kernel against its plain version for one 1024-move chunk of B
    chains: the kernel of the model's family (samplers/families.py)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import rejfree
    from rrrmc_tpu_torch.samplers.families import family_of

    n_moves = RACE_MOVES
    fam = family_of(model)
    chunk, ref = fam.race, _reference(fam.race)
    tables = fam.tables(model)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    ct = rejfree.coord_dtype(mode)
    z = dict(device=DEV)
    base = dict(sigma=st.sigma.clone(), lf=model.init_aux(st.sigma),
                E=st.E.clone(), coord=torch.zeros(B, dtype=ct, **z),
                acc=torch.zeros(B, dtype=torch.int32, **z),
                zacc=torch.zeros(B, dtype=torch.float32, **z))
    kw = dict(mode=mode, n_moves=n_moves, seed=SEED, move0=0, chain0=0,
              beta_s=beta * model.scale)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a, target):
        a["cs"], a["es"] = fn(a["sigma"], a["lf"], a["E"], a["coord"],
                              a["acc"], a["zacc"], *tables, target=target,
                              **kw)

    # a warm-up launch, then a timed one, with an unreachable target as on
    # the main path; then half the chains stop mid-chunk at the median
    # coordinate (rrr: all at half the chunk), so that the masking is
    # compared too
    unreachable = 1e30 if mode == "wtm" else 2 ** 30
    probe = fresh()
    run(chunk, probe, unreachable)
    full = fresh()
    ms_full = _events_ms(lambda: run(chunk, full, unreachable))
    require(all(torch.equal(probe[key], full[key]) for key in probe),
            f"rejfree {mode} {label}: two launches on one input differ")
    target = probe["coord"].double().median().item()
    target = {"wtm": float(target), "bkl": max(int(target), 1),
              "rrr": n_moves // 2}[mode]
    k = fresh()
    ms = _events_ms(lambda: run(chunk, k, target))
    p = fresh()
    plain_ms = _events_ms(lambda: run(ref, p, target))
    integer = not st.E.dtype.is_floating_point
    bad, err, errs = _compare(f"rejfree {mode} {label}", integer, k, p, B,
                              model.N)
    applied = float(k["acc"].double().sum())
    moves = float(k["coord"].double().sum()) if mode == "rrr" else applied
    bound_ms, bound_by = bound(
        2 * _nbytes(*base.values()) + _nbytes(*tables, k["cs"], k["es"]),
        _ops_race(model.N, moves, applied, mode, fam.flip_sites(model)))
    print(f"{kernel} {mode} {label} B={B} moves={n_moves}: kernel "
          f"{ms:.3f} ms ({ms_full:.3f} ms with every chain active), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.3g} ms ({bound_by}), "
          f"diverged chains {bad}, max abs err {err:.3g} [{card}]")
    return {"kernel": kernel, "case": f"{mode} {label}", "B": B,
            "moves": n_moves, "target": target, "ms": ms, "ms_full": ms_full,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": bad, "max_abs_err": err, "errs": errs}


def sk_case(model, label, B, n_sweeps, card, kernel):
    """The dense sweep kernel against its plain version: n_sweeps sweeps of
    B chains from one random start, one Philox seed; spins, local fields
    and energies must be EQUAL (integer arithmetic, one threshold table)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import sk

    sw = sk.SKSweeper(model, BETA)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    lf0 = model.local_fields(st.sigma)

    def run(fn, sweeps=n_sweeps, sigma=st.sigma, lf=lf0, E=st.E, sweep0=0):
        sigma, lf, E = sigma.clone(), lf.clone(), E.clone()
        ms = _events_ms(lambda: fn(sigma, lf, E, sw.J8, sw.th,
                                   n_sweeps=sweeps, seed=SEED,
                                   sweep0=sweep0))
        return sigma, lf, E, ms

    run(sk.sk_sweep_chunk)                                # warm-up
    ks, klf, kE, ms = run(sk.sk_sweep_chunk)
    ps, plf, pE, plain_ms = run(sk.sk_sweep_chunk_reference)
    same = torch.equal(ks, ps) and torch.equal(klf, plf) \
        and torch.equal(kE, pE)
    require(same, f"sk_sweep {label}: kernel and plain differ "
                  f"({int((ks != ps).any(dim=1).sum())} chains)")
    require(torch.equal(model.energy(ks), kE)
            and torch.equal(model.local_fields(ks), klf),
            f"sk_sweep {label}: E or lf != recomputed")
    # accepted flips, one sweep at a time (a site flips at most once per
    # sweep): the commits' work depends on them
    flips, sig, lf, E = 0, st.sigma, lf0, st.E
    for s_ in range(n_sweeps):
        s2, lf, E, _ = run(sk.sk_sweep_chunk, 1, sig, lf, E, s_)
        flips += int((s2 != sig).sum())
        sig = s2
    require(torch.equal(sig, ks), f"sk_sweep {label}: split launches differ")
    # an attempted flip: a quarter Philox call, the threshold and compare;
    # an accepted one adds its row of J to the chain's N local fields, a
    # product and an add each: the rank-W commit, the TPU kernel's int8 MXU
    # product, at the int8 tensor-core rate
    bound_ms, bound_by = bound(
        2 * _nbytes(st.sigma, lf0, st.E) + _nbytes(sw.J8, sw.th),
        B * model.N * n_sweeps * (PHILOX_OPS / 4 + 4),
        int8_ops=flips * 2 * model.N)
    print(f"{kernel} {label} B={B} sweeps={n_sweeps}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms ({bound_by}), "
          f"accepted {flips / (B * model.N * n_sweeps):.4f} of the attempts,"
          f" equal [{card}]")
    return {"kernel": kernel, "case": label, "B": B, "sweeps": n_sweeps,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "accepted": flips, "diverged": 0,
            "max_abs_err": 0.0}


def eo_case(model, label, B, card, kernel):
    """An EO kernel against its plain version: EO_CMP_MOVES tau-EO moves of
    B chains from one random start, one Philox seed, the sampler's select
    (the histogram for integer keys, the radix select for float ones).
    Spins and best spins, itmin, E and Emin and the local fields are held
    to `_compare`'s rule; the same moves split over two launches (move0)
    must equal the one launch."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import eo
    from rrrmc_tpu_torch.samplers.eo import rank_table
    from rrrmc_tpu_torch.samplers.families import family_of

    fam = family_of(model)
    chunk, ref, tables = fam.eo, _reference(fam.eo), fam.tables(model)
    kw = fam.eo_kw(model)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    integer = not st.E.dtype.is_floating_point
    lf0 = model.init_aux(st.sigma).contiguous()
    E0 = st.E.to(lf0.dtype)
    cdf = rank_table(model.N, EO_TAU, DEV)

    def fresh():
        return [st.sigma.clone(), lf0.clone(), E0.clone(), E0.clone(),
                st.sigma.clone(), torch.zeros(B, dtype=torch.int32,
                                              device=DEV)]

    def run(fn, a):
        fn(*a, *tables, cdf, n_moves=EO_CMP_MOVES, seed=SEED, **kw)

    def outs(a):
        return {"sigma": torch.cat([a[0], a[4]], dim=1), "acc": a[5],
                "E": torch.stack([a[2], a[3]], dim=1), "lf": a[1]}

    run(chunk, fresh())                                   # warm-up
    k = fresh()
    ms = _events_ms(lambda: run(chunk, k))
    p = fresh()
    plain_ms = _events_ms(lambda: run(ref, p))
    bad, err, errs = _compare(f"{kernel} {label}", integer, outs(k),
                              outs(p), B, model.N)
    # the same moves in two launches, the second from move0
    s = fresh()
    third = EO_CMP_MOVES // 3
    chunk(*s, *tables, cdf, n_moves=third, seed=SEED, **kw)
    chunk(*s, *tables, cdf, n_moves=EO_CMP_MOVES - third, seed=SEED,
          move0=third, **kw)
    require(all(torch.equal(a, b) for a, b in zip(s, k)),
            f"{kernel} {label}: two launches differ from one")
    e_err = max(float((model.energy(k[i]).double() - k[j].double()).abs()
                      .max()) for i, j in ((0, 2), (4, 3)))
    require(e_err <= (1e-4 * model.N if not integer else 0.0),
            f"{kernel} {label}: E or Emin != energy, by {e_err}")
    bins = eo.hist_bins(integer, fam.key_max(model))
    bound_ms, bound_by = bound(
        2 * _nbytes(*fresh()) + _nbytes(*tables, cdf),
        _ops_eo(model.N, B * EO_CMP_MOVES, fam.flip_sites(model), bins))
    print(f"{kernel} {label} B={B} moves={EO_CMP_MOVES} select="
          f"{f'histogram of {bins} bins' if bins else 'radix'}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms "
          f"({bound_by}), diverged chains {bad}, max abs err {err:.3g} "
          f"[{card}]")
    return {"kernel": kernel, "case": label, "B": B, "moves": EO_CMP_MOVES,
            "bins": bins, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "diverged": bad,
            "max_abs_err": err, "errs": errs}


def _drive(runs, card, mods):
    """Run each (name, model, route, module, nominal, unit, n_ckpt, call)
    through the public API with every launch count of `mods` set to 0 just
    before the first run; returns the per-run records and the counts just
    after the last. A run whose `nominal` is None gets no rate here (one
    that times itself)."""
    import torch
    import rrrmc_tpu_torch as rt

    torch.cuda.synchronize()
    for mod in mods.values():
        mod.LAUNCHES = 0
    records = []
    for name, model, route, mod, nominal, unit, n_ckpt, call in runs:
        before = mod.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es, st = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = mod.LAUNCHES - before
        require(launched > 0, f"{name}: no kernel launch")
        require(rt.LAST_ROUTE["backend"] == route
                and rt.LAST_ROUTE["impl"] == "cuda",
                f"{name}: route {rt.LAST_ROUTE}")
        require(Es.shape == (st.sigma.shape[0], n_ckpt)
                and bool(torch.isfinite(Es).all()),
                f"{name}: series {tuple(Es.shape)}, finite "
                f"{bool(torch.isfinite(Es).all())}")
        E_re = model.energy(st.sigma)
        if st.E.dtype.is_floating_point:
            # float32 E accumulated over ~1e5 moves at |E| ~ 1e4 (one ulp
            # is 1e-3): 1e-4 per spin
            err = float((E_re.double() - st.E.double()).abs().max())
            require(err <= 1e-4 * model.N, f"{name}: |E - energy| = {err}")
        else:
            err = 0.0
            require(torch.equal(E_re, st.E), f"{name}: E != energy(sigma)")
        chains = st.sigma.shape[0]
        rec = {"run": name, "seconds": dt, "launches": launched,
               "chains": chains,
               "E_per_spin": float(Es[:, -1].double().mean()) / model.N,
               "energy_err": err}
        if nominal is not None:
            rec.update(rate=nominal * chains / dt,
                       rate_unit=f"{unit}*chains/s")
        if "z_over_n" in rt.LAST_ROUTE:
            acc = rt.LAST_ROUTE["acc"].double()
            rec["moves_per_chain"] = float(acc.mean())
            rec["mean_z_over_n"] = float(
                (rt.LAST_ROUTE["z_over_n"].double() / acc.clamp(min=1))
                .mean())
            rec["moves_rate"] = float(acc.sum()) / dt
        records.append(rec)
        print(f"{name}: E/N {rec['E_per_spin']:.5f}  [{card}]")
        if "mean_z_over_n" in rec:
            print(f"{name}: mean z/N {rec['mean_z_over_n']:.5f}  [{card}]")
        if "rate" in rec:
            print(f"{name}: {rec['rate']:.4g} {unit}*chains/s ({dt:.2f} s, "
                  f"{launched} launches)  [{card}]")
        else:
            print(f"{name}: {dt:.2f} s, {launched} launches  [{card}]")
    torch.cuda.synchronize()
    return records, {name: mod.LAUNCHES for name, mod in mods.items()}


def rrg_path(card):
    """The RRG main path (the factor table's samplers) on GraphRRG(10^4,
    3)."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import rejfree, site

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    mn = rt.GraphRRGNormal(N_MAIN, 3, seed=SEED, device=DEV)
    iters_met, iters_rrr, iters_bkl = ITERS_MET, ITERS_RRR, ITERS_BKL
    wtm_samples, wtm_step = WTM_SAMPLES, float(N_MAIN)
    runs = [
        ("standardMC", m, "kernel-site", site, iters_met, "moves", 10,
         lambda: rt.standardMC(m, BETA, iters_met, step=iters_met // 10,
                               chains=CHAINS, seed=1, backend="kernel",
                               device=DEV)),
        ("rrrMC", m, "kernel-rejfree-sparse", rejfree, iters_rrr, "moves",
         10,
         lambda: rt.rrrMC(m, BETA, iters_rrr, step=iters_rrr // 10,
                          chains=CHAINS, seed=2, device=DEV)),
        ("bklMC", m, "kernel-rejfree-sparse", rejfree, iters_bkl,
         "virtual iterations", 10,
         lambda: rt.bklMC(m, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=3, device=DEV)),
        ("wtmMC", m, "kernel-rejfree-sparse", rejfree,
         int(wtm_samples * wtm_step), "virtual iterations", wtm_samples,
         lambda: rt.wtmMC(m, BETA, wtm_samples, step=wtm_step,
                          chains=CHAINS, seed=4, device=DEV)),
        ("bklMC GraphRRGNormal", mn, "kernel-rejfree-sparse", rejfree,
         iters_bkl, "virtual iterations", 10,
         lambda: rt.bklMC(mn, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=5, device=DEV)),
    ]
    return _drive(runs, card, {"site_metropolis": site,
                               "rejfree_sparse": rejfree})


def ea_path(card):
    """The EA-3D benchmark line and the samplers on its lattice, plus the
    site-sweep route of sweepMC on GraphRRG(10^4, 3)."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch import bench
    from rrrmc_tpu_torch.ops import rejfree, site, sweep

    lat = rt.GraphEA(bench.L, bench.D, (-1, 1), seed=bench.SEED, device=DEV)
    rrg = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    n = lat.N
    iters_rrr, iters_bkl, wtm_samples = EA_ITERS_RRR, EA_ITERS_BKL, \
        EA_WTM_SAMPLES
    bench_out = {}

    def run_bench():
        """The benchmark's own runs; its series is the final energy."""
        record, extra, model, st = bench.measure()
        bench_out.update(record=record, extra=extra)
        return model.to_physical(st.E)[:, None], st

    runs = [
        # the bench times its own runs: its rate is its metric, below
        ("sweepMC EA-3D L=16 (bench)", lat, "kernel-sweep", sweep, None,
         None, 1, run_bench),
        ("rrrMC EA-3D L=16", lat, "kernel-rejfree-sparse", rejfree,
         iters_rrr, "moves", 8,
         lambda: rt.rrrMC(lat, BETA, iters_rrr, step=iters_rrr // 8,
                          chains=CHAINS, seed=12, device=DEV)),
        ("bklMC EA-3D L=16", lat, "kernel-rejfree-sparse", rejfree,
         iters_bkl, "virtual iterations", 10,
         lambda: rt.bklMC(lat, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=13, device=DEV)),
        ("wtmMC EA-3D L=16", lat, "kernel-rejfree-sparse", rejfree,
         wtm_samples * n, "virtual iterations", wtm_samples,
         lambda: rt.wtmMC(lat, BETA, wtm_samples, step=float(n),
                          chains=CHAINS, seed=14, device=DEV)),
        ("sweepMC GraphRRG (site sweeps)", rrg, "kernel-site-sweep", site,
         RRG_SWEEPS, "sweeps", 10,
         lambda: rt.sweepMC(rrg, BETA, RRG_SWEEPS, step=RRG_SWEEPS // 10,
                            chains=CHAINS, seed=15, device=DEV)),
    ]
    records, counts = _drive(runs, card, {"sweep_checkerboard": sweep,
                                          "rejfree_lattice": rejfree,
                                          "site_metropolis": site})
    record = bench_out["record"]
    print(bench.card_line())
    print(json.dumps(record))
    records[0].update(bench=bench_out, rate=record["value"],
                      rate_unit="attempted flips/s (bench: best of "
                                f"{bench.REPS} runs of {bench.SWEEPS} sweeps)")
    return records, counts


def dense_path(card, sk1, sk8, skn, drrg, rrg):
    """The dense SK path: sweepMC on both SK sizes, the race samplers on
    GraphSK(1024) and GraphSKNormal(4096), and bklMC on a densified RRG
    beside the sparse race on the same graph, same seed. Returns the run
    records, the path's launch counts and the launches of each run."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import rejfree, rejfree_dense, sk

    b4 = 4.0
    n1 = sk1.N
    runs = [
        ("sweepMC GraphSK(1024)", sk1, "kernel-sk-sweep", sk,
         SK_SWEEPS * n1, "attempted flips", 10,
         lambda: rt.sweepMC(sk1, BETA, SK_SWEEPS, step=SK_SWEEPS // 10,
                            chains=8192, seed=21)),
        ("sweepMC GraphSK(8192)", sk8, "kernel-sk-sweep", sk,
         SK8_SWEEPS * sk8.N, "attempted flips", 10,
         lambda: rt.sweepMC(sk8, BETA, SK8_SWEEPS, step=SK8_SWEEPS // 10,
                            chains=2048, seed=22, device=DEV)),
        ("bklMC GraphSK(1024) beta=4", sk1, "kernel-rejfree-dense",
         rejfree_dense, SK_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(sk1, b4, SK_ITERS_BKL, step=SK_ITERS_BKL // 10,
                          chains=CHAINS, seed=23)),
        ("wtmMC GraphSK(1024) beta=4", sk1, "kernel-rejfree-dense",
         rejfree_dense, SK_WTM_SAMPLES * n1, "virtual iterations",
         SK_WTM_SAMPLES,
         lambda: rt.wtmMC(sk1, b4, SK_WTM_SAMPLES, step=float(n1),
                          chains=CHAINS, seed=24, device=DEV)),
        ("rrrMC GraphSK(1024)", sk1, "kernel-rejfree-dense", rejfree_dense,
         SK_ITERS_RRR, "moves", 8,
         lambda: rt.rrrMC(sk1, BETA, SK_ITERS_RRR, step=SK_ITERS_RRR // 8,
                          chains=CHAINS, seed=25, device=DEV)),
        ("bklMC GraphSKNormal(4096) beta=4", skn, "kernel-rejfree-dense",
         rejfree_dense, SKN_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(skn, b4, SKN_ITERS_BKL, step=SKN_ITERS_BKL // 10,
                          chains=128, seed=26, device=DEV)),
        ("bklMC densify(GraphRRG(10^4)) beta=4", drrg, "kernel-rejfree-dense",
         rejfree_dense, DRRG_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(drrg, b4, DRRG_ITERS_BKL,
                          step=DRRG_ITERS_BKL // 10, chains=CHAINS, seed=27,
                          device=DEV)),
        ("bklMC GraphRRG(10^4) beta=4 (sparse)", rrg,
         "kernel-rejfree-sparse", rejfree, DRRG_ITERS_BKL,
         "virtual iterations", 10,
         lambda: rt.bklMC(rrg, b4, DRRG_ITERS_BKL, step=DRRG_ITERS_BKL // 10,
                          chains=CHAINS, seed=27, device=DEV)),
    ]
    records, counts = _drive(runs, card, {"sk_sweep": sk,
                                          "rejfree_dense": rejfree_dense,
                                          "rejfree_sparse": rejfree})
    d, s = records[-2], records[-1]
    same = (d["E_per_spin"] == s["E_per_spin"]
            and d["mean_z_over_n"] == s["mean_z_over_n"])
    print(f"one factor table, bklMC beta=4 on GraphRRG(10^4): dense race E/N "
          f"{d['E_per_spin']!r} mean z/N {d['mean_z_over_n']!r}; sparse race "
          f"E/N {s['E_per_spin']!r} mean z/N {s['mean_z_over_n']!r}; "
          f"identical {same}  [{card}]")
    per_run = [r["launches"] for r in records]
    return records, counts, {
        "sk_sweep": per_run[0], "sk_sweep_hbm": per_run[1],
        "rejfree_dense": sum(per_run[2:5]),
        "rejfree_stream": per_run[5] + per_run[6]}


def _physics_rows() -> dict:
    """The EO rows of bench_all_results.json's `kernels` (the JAX package's
    best E/N at each row's chains), by kernel name."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "bench_all_results.json"
    rows = json.loads(path.read_text())["kernels"]
    return {r["kernel"]: r for r in rows if r["kernel"] in EO_ROW_MOVES}


def _eo_run(name, model, route, chains, moves, seed, launches, card):
    """One extremal_opt(tau=EO_TAU) run through the public API with no
    device argument, and its checks: a kernel launched (`launches()` reads
    the path's launch counts), LAST_ROUTE names the CUDA route, E and Emin
    equal the energies of sigma and sigma_min (exactly for integer
    energies, within 1e-4 * N for float ones), itmin in [0, moves].
    Returns (record, EOResult)."""
    import torch
    import rrrmc_tpu_torch as rt

    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = rt.extremal_opt(model, EO_TAU, moves, chains=chains, seed=seed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = launches() - before
    require(launched > 0, f"EO {name}: no kernel launch")
    require(rt.LAST_ROUTE == {"backend": route, "impl": "cuda"},
            f"EO {name}: route {rt.LAST_ROUTE}")
    errs = [float((model.to_physical(model.energy(s)).double()
                   - e.double()).abs().max())
            for s, e in ((r.sigma, r.E), (r.sigma_min, r.Emin))]
    if model.energy(r.sigma).dtype.is_floating_point:
        require(max(errs) <= 1e-4 * model.N,
                f"EO {name}: |E - energy| {errs}")
    else:
        require(max(errs) == 0.0, f"EO {name}: E != energy, {errs}")
    require(bool(((r.itmin >= 0) & (r.itmin <= moves)).all())
            and bool(torch.isfinite(r.Emin).all()),
            f"EO {name}: itmin or Emin out of range")
    best = float(r.Emin.min()) / model.N
    rec = {"run": f"extremal_opt {name}", "seconds": dt,
           "launches": launched, "chains": chains, "moves": moves,
           "rate": moves * chains / dt, "rate_unit": "moves*chains/s",
           "best_E_per_spin": best,
           "mean_Emin_per_spin": float(r.Emin.double().mean())
           / model.N, "energy_err": max(errs)}
    print(f"extremal_opt {name}: {rec['rate']:.4g} moves*chains/s "
          f"({chains} chains, {moves} moves, {dt:.2f} s, {launched} "
          f"launches), best E/N {best:.5f}, mean Emin/N "
          f"{rec['mean_Emin_per_spin']:.5f}  [{card}]")
    return rec, r


def _check_row(rec, row, ref):
    """A run's best E/N within EO_ROW_RTOL of its physics row's."""
    best, name = rec["best_E_per_spin"], rec["run"]
    rec["row"], rec["row_best_E_per_spin"] = row, ref
    print(f"  physics row {row}: port best E/N {best:.5f}, JAX "
          f"package {ref:.5f} ({rec['chains']} chains, {rec['moves']} "
          f"moves)")
    require(abs(best - ref) <= EO_ROW_RTOL * abs(ref),
            f"{name}: best E/N {best} against {row}'s {ref}")


def eo_path(card, rrg, rrgn, ea, sk, drrg, skn):
    """The EO main path: extremal_opt(tau=1.4) through the public API with
    no device argument, with every EO launch count set to 0 just before the
    first run: the three physics rows of bench_all_results.json at their
    chains and moves (their best E/N must agree within EO_ROW_RTOL), and
    the RRG, its densified copy, RRGNormal and SKNormal(4096) with
    EO_MOVES moves; the densified and the sparse RRG under one seed must
    give identical results. Returns the run records, the path's launch
    counts and the launches of each kernel entry."""
    import torch
    from rrrmc_tpu_torch.ops import eo, eo_dense

    rows = _physics_rows()
    # (name, model, route, kernel entry, chains, moves, seed, physics row)
    runs = [
        ("GraphRRG(10^4)", rrg, "kernel-eo-sparse", "eo_sparse", 0, 0, 41,
         "eo_rrg1e4_sparse"),
        ("GraphEA(8, 3)", ea, "kernel-eo-sparse", "eo_lattice", 0, 0, 42,
         "eo_ea3d"),
        ("GraphSK(1024)", sk, "kernel-eo-dense", "eo_dense", 0, 0, 43,
         "eo_dense_sk"),
        ("GraphRRG(10^4) 1024 chains", rrg, "kernel-eo-sparse", "eo_sparse",
         CHAINS, EO_MOVES, 44, None),
        ("densify(GraphRRG(10^4))", drrg, "kernel-eo-dense", "eo_stream",
         CHAINS, EO_MOVES, 44, None),
        ("GraphRRGNormal(10^4)", rrgn, "kernel-eo-sparse", "eo_sparse",
         CHAINS, EO_MOVES, 45, None),
        ("GraphSKNormal(4096)", skn, "kernel-eo-dense", "eo_stream", 512,
         EO_MOVES, 46, None),
    ]
    torch.cuda.synchronize()
    eo.LAUNCHES = eo_dense.LAUNCHES = 0
    records, results, per_entry = [], {}, {}
    for name, model, route, entry, chains, moves, seed, row in runs:
        if row is not None:
            chains, moves = rows[row]["chains"], EO_ROW_MOVES[row]
        rec, r = _eo_run(name, model, route, chains, moves, seed,
                         lambda: eo.LAUNCHES + eo_dense.LAUNCHES, card)
        per_entry[entry] = per_entry.get(entry, 0) + rec["launches"]
        if row is not None:
            _check_row(rec, row, rows[row]["best_E_per_spin"])
        records.append(rec)
        results[name] = r
    a, b = results["GraphRRG(10^4) 1024 chains"], results[
        "densify(GraphRRG(10^4))"]
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("sigma", "E", "Emin", "sigma_min", "itmin"))
    print(f"one law, extremal_opt on densify(GraphRRG(10^4)) and on the "
          f"sparse GraphRRG(10^4), one seed: identical {same}  [{card}]")
    require(same, "EO: the dense and the sparse kernel differ on one graph")
    torch.cuda.synchronize()
    return records, {"eo_sparse+eo_lattice": eo.LAUNCHES,
                     "eo_dense+eo_stream": eo_dense.LAUNCHES}, per_entry


def _sat_eo_row() -> dict:
    """The sat_eo row of bench_all_results.json (the JAX package's best and
    mean best energy over its chains)."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "bench_all_results.json"
    rows = json.loads(path.read_text())["sat"]
    return next(r for r in rows if r["kernel"] == "sat_eo")


def pspin_path(card, ps):
    """The PSpin3 path: the race samplers through the public API (the
    race launch count set to 0 just before them), then extremal_opt (the
    EO launch count set to 0 just before it) on the eo_pspin7500 row's
    chains and moves. Returns the run records and the launches of both
    kernel entries."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import eo_pspin, pspin

    route, B = "kernel-rejfree-pspin", HYPER_CHAINS
    bkl_b, rrr_b, n = PS_BETA_BKL, PS_BETA_RRR, ps.N
    runs = [
        ("bklMC GraphPSpin3(7500, 3) beta=1.5", ps, route, pspin,
         PS_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(ps, bkl_b, PS_ITERS_BKL, step=PS_ITERS_BKL // 10,
                          chains=B, seed=51)),
        ("rrrMC GraphPSpin3(7500, 3) beta=1.0", ps, route, pspin,
         PS_ITERS_RRR, "moves", 10,
         lambda: rt.rrrMC(ps, rrr_b, PS_ITERS_RRR, step=PS_ITERS_RRR // 10,
                          chains=B, seed=52)),
        ("wtmMC GraphPSpin3(7500, 3) beta=1.5", ps, route, pspin,
         PS_WTM_SAMPLES * n, "virtual iterations", PS_WTM_SAMPLES,
         lambda: rt.wtmMC(ps, bkl_b, PS_WTM_SAMPLES, step=float(n),
                          chains=B, seed=53)),
        ("bklMC GraphPSpin3(7500, 3) beta=1.5, 1024 chains", ps, route, pspin,
         PS_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(ps, bkl_b, PS_ITERS_BKL, step=PS_ITERS_BKL // 10,
                          chains=CHAINS, seed=54)),
    ]
    records, counts = _drive(runs, card, {"rejfree_pspin": pspin})
    row = _physics_rows()["eo_pspin7500"]
    eo_pspin.LAUNCHES = 0
    rec, _ = _eo_run("GraphPSpin3(7500, 3)", ps, "kernel-eo-pspin",
                     row["chains"], EO_ROW_MOVES["eo_pspin7500"], 55,
                     lambda: eo_pspin.LAUNCHES, card)
    _check_row(rec, "eo_pspin7500", row["best_E_per_spin"])
    return records + [rec], {**counts, "eo_pspin": eo_pspin.LAUNCHES}


def sat_path(card, sat):
    """The K-SAT path: bklMC, wtmMC and rrrMC at beta=4 through the public
    API (the race launch count set to 0 just before them), then
    extremal_opt (the EO launch count set to 0 just before it), whose mean
    best energy over the chains must lie within SAT_EO_RTOL of the sat_eo
    row's. Returns the run records and the launches of both kernel
    entries."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import eo_sat
    from rrrmc_tpu_torch.ops import sat as sat_ops

    route, B, beta, n = "kernel-rejfree-sat", HYPER_CHAINS, SAT_BETA, sat.N
    runs = [
        ("bklMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, sat_ops,
         SAT_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(sat, beta, SAT_ITERS_BKL,
                          step=SAT_ITERS_BKL // 10, chains=B, seed=61)),
        ("wtmMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, sat_ops,
         SAT_WTM_SAMPLES * n, "virtual iterations", SAT_WTM_SAMPLES,
         lambda: rt.wtmMC(sat, beta, SAT_WTM_SAMPLES, step=float(n),
                          chains=B, seed=62)),
        ("rrrMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, sat_ops,
         SAT_ITERS_RRR, "moves", 10,
         lambda: rt.rrrMC(sat, beta, SAT_ITERS_RRR,
                          step=SAT_ITERS_RRR // 10, chains=B, seed=63)),
    ]
    records, counts = _drive(runs, card, {"rejfree_sat": sat_ops})
    row = _sat_eo_row()
    eo_sat.LAUNCHES = 0
    rec, r = _eo_run("GraphSAT(10^4, 3, 4.2)", sat, "kernel-eo-sat",
                     row["chains"], SAT_EO_MOVES, 64,
                     lambda: eo_sat.LAUNCHES, card)
    mean_best = rec["mean_Emin_per_spin"] * n
    best = rec["best_E_per_spin"] * n
    emin = r.Emin.double()
    sem = float(emin.std()) / emin.numel() ** 0.5
    rec.update(row="sat_eo", row_mean_best_E=row["mean_best_E"],
               row_best_E=row["best_E"], mean_best_E=mean_best, best_E=best,
               sem_mean_best_E=sem)
    print(f"  physics row sat_eo: port mean best E {mean_best:.2f} (standard "
          f"error {sem:.3f}, limit {SAT_EO_RTOL * row['mean_best_E']:.2f}), "
          f"best {best:.0f}; JAX package {row['mean_best_E']:.2f}, best "
          f"{row['best_E']:.0f} ({rec['chains']} chains, {rec['moves']} "
          f"moves)")
    require(abs(mean_best - row["mean_best_E"])
            <= SAT_EO_RTOL * row["mean_best_E"],
            f"EO SAT: mean best E {mean_best} against {row['mean_best_E']}")
    return records + [rec], {**counts, "eo_sat": eo_sat.LAUNCHES}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import rrrmc_tpu_torch as rt   # fails in a directory without the repo
    from rrrmc_tpu_torch.ops import cuda_build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    # the ptxas report first: the build time stays in the output's tail
    print(cuda_build.build_info["log"].strip())
    print(f"kernel build: {build_s:.1f} s ({cuda_build.build_info['path']})")

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    mn = rt.GraphRRGNormal(N_MAIN, 3, seed=SEED, device=DEV)
    cases = [site_case(m, "RRG+-J", card), site_case(mn, "RRGNormal", card)]
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(m, "RRG+-J", mode, card))
        cases.append(rejfree_case(mn, "RRGNormal", mode, card))
    lat = rt.GraphEA(16, 3, (-1, 1), seed=42, device=DEV)
    field = dataclasses.replace(lat, h=torch.as_tensor(
        np.random.default_rng(SEED).integers(-2, 3, lat.N),
        dtype=lat.h.dtype, device=DEV))
    fixed = rt.GraphEA(16, 3, (-1.5, 0.5), seed=42, device=DEV)
    cases.append(sweep_case(lat, "EA3D-L16+-J", 8192, card))
    cases.append(sweep_case(field, "EA3D-L16+-J fields", CHAINS, card))
    cases.append(sweep_case(fixed, "EA3D-L16 (-1.5,0.5) exp", CHAINS, card))
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(lat, "EA3D-L16+-J", mode, card,
                                  kernel="rejfree_lattice"))

    # built and, below, sampled with no device given: the card is the
    # default
    sk1 = rt.GraphSK(1024, seed=4)
    require(sk1.J.device.type == "cuda", "GraphSK without a device is not "
                                         "on the card")
    sk8 = rt.GraphSK(8192, seed=4, device=DEV)
    skn = rt.GraphSKNormal(4096, seed=4, device=DEV)
    rrg7 = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=7, device=DEV)
    drrg = rt.densify(rrg7)
    cases.append(sk_case(sk1, "GraphSK(1024)", 8192, SK_CMP_SWEEPS, card,
                         "sk_sweep"))
    cases.append(sk_case(sk8, "GraphSK(8192)", 2048, SK8_CMP_SWEEPS, card,
                         "sk_sweep_hbm"))
    # the sweep kernel's other code paths: the scalar commit (N % 4 != 0)
    # and fields seeding lf
    sk11 = rt.GraphSK(1100, seed=4, device=DEV)
    cases.append(sk_case(sk11, "GraphSK(1100)", CHAINS, 1, card, "sk_sweep"))
    skf = dataclasses.replace(sk1, h=torch.as_tensor(
        np.random.default_rng(SEED).integers(-2, 3, sk1.N),
        dtype=sk1.h.dtype, device=DEV))
    cases.append(sk_case(skf, "GraphSK(1024) fields", CHAINS, 1, card,
                         "sk_sweep"))
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(sk1, "GraphSK(1024)", mode, card,
                                  kernel="rejfree_dense", beta=4.0))
    cases.append(rejfree_case(drrg, "densify(GraphRRG(10^4))", "bkl", card,
                              kernel="rejfree_stream", beta=4.0))
    cases.append(rejfree_case(skn, "GraphSKNormal(4096)", "bkl", card,
                              kernel="rejfree_stream", B=128, beta=4.0))

    rrgn7 = rt.GraphRRGNormal(N_MAIN, 3, seed=7, device=DEV)
    ea8 = rt.GraphEA(8, 3, (-1, 1), seed=42, device=DEV)
    cases.append(eo_case(rrg7, "GraphRRG(10^4)", CHAINS, card, "eo_sparse"))
    cases.append(eo_case(rrgn7, "GraphRRGNormal(10^4)", CHAINS, card,
                         "eo_sparse"))
    cases.append(eo_case(ea8, "GraphEA(8, 3)", CHAINS, card, "eo_lattice"))
    cases.append(eo_case(sk1, "GraphSK(1024)", CHAINS, card, "eo_dense"))
    cases.append(eo_case(drrg, "densify(GraphRRG(10^4))", CHAINS, card,
                         "eo_stream"))
    cases.append(eo_case(skn, "GraphSKNormal(4096)", 512, card,
                         "eo_stream"))

    # the hypergraph models, built with no device given: the card is the
    # default
    ps = rt.GraphPSpin3(PSPIN_N, PSPIN_K, seed=PSPIN_SEED)
    sat = rt.GraphSAT(SAT_N, SAT_K, SAT_ALPHA, seed=SEED)
    require(ps.A.device.type == "cuda" and sat.A.device.type == "cuda",
            "the hypergraph builders without a device are not on the card")
    for model, label in ((ps, "GraphPSpin3(7500, 3)"),
                         (sat, "GraphSAT(10^4, 3, 4.2)")):
        kind = "pspin" if model is ps else "sat"
        for mode in ("bkl", "wtm", "rrr"):
            beta = (SAT_BETA if model is sat
                    else PS_BETA_RRR if mode == "rrr" else PS_BETA_BKL)
            cases.append(rejfree_case(model, label, mode, card,
                                      kernel=f"rejfree_{kind}",
                                      B=HYPER_CHAINS, beta=beta))
        cases.append(eo_case(model, label, HYPER_CHAINS, card, f"eo_{kind}"))

    rrg_records, rrg_counts = rrg_path(card)
    ea_records, ea_counts = ea_path(card)
    sk_records, sk_counts, sk_launches = dense_path(card, sk1, sk8, skn,
                                                    drrg, rrg7)
    eo_records, eo_counts, eo_launches = eo_path(card, rrg7, rrgn7, ea8,
                                                 sk1, drrg, skn)
    ps_records, ps_counts = pspin_path(card, ps)
    sat_records, sat_counts = sat_path(card, sat)
    print(json.dumps({"paths": {"RRG": rrg_counts, "EA-3D": ea_counts,
                                "dense SK": sk_counts, "EO": eo_counts,
                                "PSpin3": ps_counts, "K-SAT": sat_counts},
                      "runs": rrg_records + ea_records + sk_records
                      + eo_records + ps_records + sat_records}))
    launches = {"site_metropolis": rrg_counts["site_metropolis"],
                "rejfree_sparse": rrg_counts["rejfree_sparse"],
                "rejfree_lattice": ea_counts["rejfree_lattice"],
                "sweep_checkerboard": ea_counts["sweep_checkerboard"],
                **sk_launches, **eo_launches, **ps_counts, **sat_counts}

    kernels = []
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # times: the first case (race: bkl mode)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
        require(launches[name] > 0, f"{name}: not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
