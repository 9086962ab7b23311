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
   chains, one 1024-move chunk per mode. The class kernel (bklMC's on
   integer sparse models, csrc/rejfree_classes.cu) on the same RRG and
   lattice and on its other paths (`classes_cases`), its own line.
   Integer couplings must agree exactly; float couplings within the
   tolerances stated in `_compare`. Both times are printed.
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
   - replica composites (`replica_path`): QIsing, GraphQSKT(1024, 16,
     Gamma=0.3, beta=2), and REIsing, GraphSKRE(1024, 5, gamma, beta=0.4),
     built with no device argument, 1024 chains, through sweepMC_quant /
     sweepMC_replica and rrrMC (QIsing also bklMC and wtmMC; REIsing's
     gamma grid 3, 4, 5 by sweepMC_replica), their observables held to
     paper_quant_results.json's first trajectory points within
     REPLICA_RTOL; Quant and RE over GraphRRG(1000, 3), M=8, through
     rrrMC and bklMC and the float bases GraphQSKNormalT(1024, 16) and
     GraphQEAT(8, 3, M=8) through bklMC, 128 chains.
   - perceptrons (`perc_path`): scripts/bench_all.py's perc_comm_section,
     GraphPercStep(1023, 511, seed=5), GraphPercLinear and
     GraphPercXEntr(1023, 511, 1.0, seed=5), built with no device
     argument, 256 chains at beta=1: bklMC and rrrMC on each, wtmMC on
     step, extremal_opt(tau=1.4) with 20 000 moves on step and xentr, the
     Metropolis row standardMC(backend="torch") (no kernel); then, after
     the path's launch counts are read (the law check's runs are counted
     in their own records), a law check: bklMC's time-averaged E on
     GraphPercStep, GraphPercLinear and GraphPercXEntr(15, 9) must equal
     the exact Boltzmann mean of the 2^15 states within max(5 standard
     errors, 0.05).
   - the north star's experiment (`factors_path`):
     experiments.equilibrated_factors on GraphRRG(10_000, 3, +-J,
     seed=167), built with no device argument, at beta=3 with 128 chains
     and target_s=1: every row on its CUDA kernel (kernel-site,
     kernel-rejfree-sparse) for at least 0.5 s, finite positive factors,
     z/N in (0, 1], E_per_spin_eq within FACTORS_EQ_TOL of the JAX
     package's factors_sparse row; each row's E/N and z/N printed beside
     the JAX row's.
   - the generic torch paths (`generic_path`): on GraphRRG(1000, 3) +-J,
     128 chains at beta=2, equilibrated by kernel bklMC, rrrMC, bklMC and
     wtmMC with backend="torch" against the same calls on the kernel route
     (route "torch", E == energy(sigma), second-half E/N compared chain by
     chain: the mean difference within 5 standard errors of the chains'
     differences; generic rrrMC at LE_FAULT_BETA * beta, the control, must
     fail it); rrrMC on GraphRRGNormalDiscretized(1000, 3)
     (a Double); a bklMC hook that stops the run; stats_overlaps with
     bklMC, 16 chains, 2 disorders (q2 and x2 finite, in [0, 1]); the
     snapshot stream of generic bklMC on GraphRRG(10_000, 3) with 128
     chains, cut to its memory budget, its snapshots' energies equal to
     the energy series.
   - the wrappers (`wrapper_path`): GraphLocalEntropy(1000, M=8, gamma=1,
     beta=1) over GraphRRG(1000, 3, +-J, seed=13), built with no device
     argument, 128 chains: rrrMC, bklMC and wtmMC on LE (the generic path,
     about 2000 moves a chain) against the same calls on flatten(LE) (the
     sparse race kernel) from spins that kernel bklMC equilibrated, their
     second-half E/N within 5 standard errors, and LEenergies plus the
     star's energy equal to E; on flatten(LE) standardMC (the site kernel),
     bklMC (the sparse race), sweepMC (the site-sweep route) and
     extremal_opt(tau=1.4) (the sparse EO kernel); sweepMC on LE's and on
     TLE's composite masks (bench_all.py's tle_rrg_sweep row, its rates
     printed) and generic bklMC moves on TLE; the committee rows of
     bench_all.py (GraphCommStep(65, 15, 487), GraphCommReLU and
     GraphCommQu(64, 16, 487), 256 chains, beta=1) through standardMC,
     rrrMC and bklMC on the generic path, exact int32 energies. The
     replica race kernel must not launch; the path's wall time is printed.
   - parallel tempering (`pt_path`): parallel_tempering on
     GraphRRG(10_000, 3, +-J, seed=167), built with no device argument,
     PT_T = 32 rungs beta_k = 1 + 0.02 k of 32 chains (1024 chains), 10
     sweeps a round, 200 rounds, ONE site-kernel launch a round (the
     kernel reads each chain's beta); the exact int32 energy on every
     chain, ranks a permutation of every column after every round, E/N by
     rung non-increasing within 3 standard errors, every adjacent pair
     swapping; the law (`pt_law`: the ladder continued to 6000 rounds,
     as beta = 1 lies below beta_c and both runs age from random spins;
     rung 0's second-half E/N against sweepMC at beta 1 over as many
     sweeps within 5 hypot of the standard errors, sweepMC at 1.1 must
     fail it; the gap after 200 rounds printed beside it); wall time,
     attempted flips * chains / s, launches and host syncs a round, each
     pair's acceptance, and the device busy share of 5 rounds under the
     port's profiling.trace.
   - ensemble exchange (`et_path`): tempered_ensembles with sweep_kernel
     on 8 slots flatten(GraphQuant(1000, 8, Gamma_k, beta=2, base)) over
     GraphRRG(1000, 3, +-J, seed 13), Gamma_k = 1 + 0.02 k, 128 chains, 100
     rounds: one site launch a slot a round, E within 1e-4 max(1, |E|) of
     each slot's energy(sigma), walkers permutations, every pair swapping.
   - sharding (`shard_path`): sample_sharded(standardMC) over a mesh of
     the card repeated 4 times, sample_disorder(bklMC) over 4
     GraphRRG(10_000, 3) instances, a one-rank NCCL group's
     sample_distributed(sweepMC) and parallel tempering, and a PT state
     saved after 10 rounds, loaded and continued: each EQUAL to its
     unsharded, sequential, in-memory and one-call reference.
   - the ported scripts (`scripts_path`) at their published shapes and
     chain counts with short lengths: every row of the scoreboard's
     kernels, sat, composite_sparse, sparse_chains (1024 chains),
     disorder and perc_comm sections (scripts/torch_bench_all.py's
     SHORT), each with its energy guard, the JAX artifact's keys for its
     section (with the port's ADDED_KEYS) and its kernel's route;
     QIsing's four engines for QISING_T seconds each
     (scripts/torch_paper_quant.py), and the tempering scaling at T = 2
     and 32 for 3 rounds (scripts/torch_tempering_scaling.py); every
     kernel module launched, its wall time printed.
   After each run: the launch counter rose, LAST_ROUTE names the CUDA
   kernel route, the checkpoint series is finite and of the expected shape,
   and the running energy equals energy(sigma) (exactly for integer
   couplings, within 1e-4 * max(1, |E|) for the replica composites'
   float32 physical energies and the xentr perceptron's float32 E); for
   EO, E and Emin equal the energies of sigma and sigma_min (exactly for
   integer couplings, within 1e-4 * N for float ones, 1e-4 * max(1, |E|)
   for xentr) and itmin lies in [0, moves].

The site and checkerboard phases of 2 hold the redesigned kernels on
their other routes and shapes too. The site kernel with a beta per chain
(`pt_site_case`): the PT path's shape, 32 distinct betas over 1024 chains,
one sweep of the permutation schedule, EQUAL to its plain version, its
time printed beside row 1's. The site kernel (`site_cases`): the
row's GraphRRG(10^4, 3) +-J case and GraphRRGNormal (float32 fields, held
bit for bit: the groups keep the serial order of every field's adds and E
is summed in schedule order), a conflict-heavy GraphRRG(64, 3) and a
schedule of repeated sites, a graph with padded neighbour rows and fields
(`padded_graph`, K = 6), EA-4D L=6 (K = 8), a ragged batch (SITE_RAGGED_B
chains), int16 fields (couplings -70 and 30, bound 210) and int32 fields
(fixed-point couplings, bound 450 000), and GraphRRG(SITE_GLOBAL_N, 3) and
GraphRRGNormal(SITE_GLOBAL_N, 3), above the resident route's shared
memory, which take the global route (int32 and float32); each prints its
plan (route, field type, chains a block, warps, shared bytes, blocks a SM,
registers). Then the
device's groups (`site.group_lengths` on the card) must equal
`site.site_groups` on the path's schedules (a standardMC launch's 300 000
random sites and the site-sweep route's permutations), with the mean
group length printed. The checkerboard kernel (`sweep_case`): the bench's
B=8192 row, the field column, the exp path, a ragged batch, an EA-2D
lattice, EA-4D and EA-1D lattices (the kernel's run-time-D instantiation),
one chain a lane on +-J couplings and four chains a lane on the exp path;
each prints its plan (chains a block, threads, lanes, shared
bytes, blocks a SM, registers), and each launches once more with the fields
epilogue of a call's last launch (`aux`), whose fields must equal the
model's local_fields with the spins and E unchanged; the main path's
sweepMC row holds its state's aux to local_fields the same way.
`site_sweep_instantiations` prints every instantiation of both kernels
with its registers and spill bytes (ptxas) and local bytes (the CUDA
runtime) and fails on a spill or a local byte.

The wrapper phase of 2 holds the site kernel (SITE_CMP_MOVES moves), the
sparse race kernel (bkl, wtm, rrr; CMP_MOVES moves) and the sparse EO
kernel on flatten(LE) at the wrapper path's 128 chains: float32
couplings, centre spins of degree M = 8 (K = 8), under `_compare`'s float
rule.

The replica phases of 2 are the composite race kernel on GraphQSKT(1024,
16) (bkl, wtm, rrr), GraphSKRE(1024, 5) (rrr) and GraphQSKNormalT(1024, 16)
(bkl), the dense base, and on Quant and RE over GraphRRG(1000, 3) (bkl,
wtm, rrr) and GraphQEAT(8, 3, M=8) (bkl), the sparse base, at the main
paths' chains; and the composite sweep kernel, one sweep and a split pair,
on GraphQSKT(1024, 16), GraphSKRE(1024, 5) and GraphQSKNormalT(1024, 16),
then on GraphQSKT(1024, 16) after 79 warm sweeps (one checkpoint of the
path's sweepMC_quant: its equilibrium case), with REPLICA_RAGGED_B and
with SMALL_B chains, on GraphQSKT(1100, 4) and GraphSKRE(1101, 3) (rows
of 4-byte and of single-byte loads) with REPLICA_RAGGED_B chains, and on
GraphSKRE(1024, 5) gamma=5 after the path's 100 sweeps (nearly frozen:
the row-by-row commit). Every dense and composite sweep case
prints its launch plan (chains a block, span, shared bytes, commit path).
Integer bases must agree bit for bit, E and z/N included. Then the
refusals: a composite above shared memory, a sparse base under
sweepMC_quant and a Double under bklMC(backend="kernel") each raise.

The perceptron phases of 2 are the perceptron race kernel in bkl, wtm and
rrr mode and the perceptron EO kernel (EO_CMP_MOVES moves; the histogram
select of 1023 bins for step and linear, the radix select for xentr) on
the three perceptrons of the path, 256 chains at beta=1: one 1024-move
chunk for step bkl (the row's case), CMP_MOVES moves for the others. Step
and linear must agree bit for bit, stabilities, E and z/N included. The
plain version of xentr computes g with torch's exp and log1p and adds the
product in the kernel's order, so it agrees bit for bit too on this card;
it is held to `_compare`'s float rule (at most one diverged chain, E within
1e-5 * N, z/N and the wtm clock within rtol 1e-4). The race kernel reads
the patterns as bits (ops/perc.py::pack_patterns), in shared memory on
these models; `hyper_fused_cases` also holds it with the bits in global
memory (GraphPercStep(1023, 2047)) and at the block size the path does
not pick, and the SAT race likewise (256 threads, the all-up
`sat_chain` start where every flip raises E, and at SAT_WIDE_N variables,
the earlier SAT kernel's largest N at alpha = 4.2). `_ops_perc` counts the
bound's operations: the g pass, the full product xi^T g (2 N P a move,
twice for rrr; at the int8 tensor-core rate for step and linear, whose
operands fit int8, as the TPU kernel ran it on its MXU; xentr's float32
product at the float32 rate), the race or select passes and the P-entry
stability update.

The dense-model phases of 2 are the dense sweep kernel on GraphSK(1024)
with 8192 chains (3 sweeps) and GraphSK(8192) with 2048 chains (1 sweep),
then on its other code paths with 1024 chains (1 sweep each): GraphSK(1100)
(N % 16 != 0: the commit's J loads of 4 bytes) and GraphSK(1024) with
integer fields; each row's equilibrium case (its chains after one
main-path checkpoint of warm sweeps of the kernel, 50 and 2, then the
row's sweeps from there, at the main path's acceptance), a ragged B
(SK_RAGGED_B chains: the last block has warps past B; SMALL_B chains,
fewer than one block's tile of 8) and near-frozen
chains (FROZEN_BETA after 50 sweeps, N = 1024 and 1101: the row-by-row
commit of a span with few flips); and
the dense race kernel on GraphSK(1024) with 1024 chains at beta=4 (one
1024-move chunk per mode), densify(GraphRRG(10_000, 3)) with 1024 chains
and GraphSKNormal(4096) with 128 chains (bkl), the main paths' shapes;
then (`dense_fused_cases`) at both block sizes (pinned) and in every
resident type (int8 on the densified RRG, int16 on GraphSK(1024), int32
on GraphSK(1100) with J scaled to +-127, whose rows are not all 16-byte
aligned, float32 on GraphSKNormal(4096) and (1100)), bkl, wtm and rrr, the
all-up densified ferromagnet (every flip raises E: z summed twice), and
an SK model of DENSE_WIDE_N spins built on the card, the largest N of the
earlier 5-bytes-a-site dense kernel, int32 fields, where rrr keeps the
fields its tentative flip overwrites in global memory. Every dense case is
held bit for bit, float J too.
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
Every EO kernel prints its launch plan (ops/eo.py::eo_plan for the
sparse, dense and K-SAT ones, which share csrc/eo_chain.cuh's move loop;
ops/eo_perc.py::eo_perc_plan) beside each case, and `eo_route_cases`
holds every route of the sparse one (one warp a chain, blocks of 4, 8 and
32 warps, each at a shape for which the plan picks it), every key type
(int8, int16, int32 and float32, the last two with the coarse select,
float keys with -0.0 and crowded bins) and PSpin3 on each block size;
`eo_dense_sat_route_cases` every warps a chain and key type of the dense
kernel (int8, int16, int32, float32 with -0.0 and crowded bins; rows not
16-byte aligned) and of the K-SAT one (uint8 and uint16 keys),
EO_ROUTE_MOVES moves each, bit for bit (the dense and K-SAT kernels' float
cases too); the perceptron EO kernel also with its pattern bits in global
memory. `eo_instantiations` prints every EO instantiation's registers,
spills (ptxas) and local bytes (the CUDA runtime) and fails on a spill or
a local byte. Every EO case's two-launch check splits at a move0 off the
kernels' batch of 32 rank draws, and its bound counts the tie race's
member groups of that run (the plain version's ops/eo.py::TIE_GROUPS),
with the earlier count, two Philox calls a move, printed beside it; a
dense case's bound also the rows of J beyond L2 (`bound`).

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

Each entry of the record also carries `registers`: the fewest and the most
registers of its kernel function's instantiations, from the build's ptxas
report (null when the library was already built); the sweep entries also
their plan and their equilibrium case's time. `sweep_instantiations` prints
every instantiation of the two sweep kernels with its registers and spill
bytes (ptxas) and local bytes (the CUDA runtime), and fails on a spill or
local byte, or on an integer instantiation whose SASS (cuobjdump -sass of
the built library) holds neither IMMA nor IGMMA: the commit's int8
tensor-core product.

The last lines are the kernels' JSON record, the card line, and
{"ok": true, "device": {...}}. It exits 1 without a result when no CUDA
device is visible.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
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
#: the class kernel's comparisons (`classes_cases`): beta, and the kernel
#: bklMC iterations that equilibrate the RRG's chains for one of them
CLASS_BETA, CLASS_WARM_ITERS = 4.0, 1_000_000
#: the site kernel's other cases: a ragged batch, the moves of the cases
#: beside the row, a graph above the resident route's shared memory (int8
#: fields: N > 116 224) and its chains, and the moves of one standardMC
#: launch on the path (its schedule's groups are checked)
SITE_RAGGED_B, SITE_CMP_MOVES, SITE_GLOBAL_N, SITE_GLOBAL_B = 1003, 2000, \
    120_000, 64
SITE_PATH_MOVES = ITERS_MET // 10
#: moves of every race comparison but the one that gives its kernel's row
#: (the first, bkl, case at RACE_MOVES): the other modes and the other
#: models of a kernel, whose plain versions take 2-10 s at RACE_MOVES
CMP_MOVES = 256
#: dense SK path: sweeps of the two sweepMC runs, and the race samplers'
#: run lengths on GraphSK(1024) and the other dense models
SK_SWEEPS, SK8_SWEEPS = 500, 20
SK_ITERS_BKL, SK_ITERS_RRR, SK_WTM_SAMPLES = 1_000_000, 16_384, 500
SKN_ITERS_BKL, DRRG_ITERS_BKL = 2_000_000, 10_000_000
#: sweeps per dense-sweep comparison (the plain version takes ~1 ms per
#: site at these shapes)
SK_CMP_SWEEPS, SK8_CMP_SWEEPS = 3, 1
#: chains of the sweep kernels' ragged cases: not a multiple of a block's
#: 16 chains (the last block has warps past B), and fewer than 8 (one block
#: whose second tile of 8 chains is all past B)
SK_RAGGED_B, REPLICA_RAGGED_B, SMALL_B = 1003, 203, 5
#: beta of the dense sweep's near-frozen cases
FROZEN_BETA = 40.0
#: the dense sweep kernels' __global__ functions whose integer
#: instantiations must run their commit on the tensor cores (IMMA or IGMMA
#: in their SASS); the float base's kernel commits on the CUDA cores
SWEEP_FUNCTIONS = ("sk_sweep_kernel", "replica_sweep_kernel",
                   "replica_sweep_float_kernel")
#: tau-EO: tau, the moves of each kernel-versus-plain comparison, the main
#: path's moves where no physics row sets them, and the moves of the physics
#: rows of bench_all_results.json (scripts/bench_all.py: bench_eo_sparse,
#: bench_eo), whose chains and best E/N the file holds
EO_TAU, EO_CMP_MOVES, EO_MOVES = 1.4, 300, 20_000
#: moves of the EO comparisons beside the rows' cases (the redesigned
#: kernels' other routes and key types)
EO_ROUTE_MOVES = 100
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
#: the SAT race's largest N at alpha = 4.2 before its dE went to 16 bits
#: (int32 dE: 4 N + N + 4.2 N bytes within 227 KB), held at a few chains
SAT_WIDE_N, SAT_WIDE_CHAINS = 25_250, 8
#: the dense race's largest N before its spins went to bits (5 bytes a site
#: within the H100's 232 448 opt-in bytes less 64), held at a few chains
DENSE_WIDE_N, DENSE_WIDE_CHAINS = 46_476, 8
PS_ITERS_BKL, PS_ITERS_RRR, PS_WTM_SAMPLES = 2_000_000, 100_000, 200
SAT_ITERS_BKL, SAT_ITERS_RRR, SAT_WTM_SAMPLES = 4_000_000, 50_000, 200
SAT_EO_MOVES, SAT_EO_RTOL = 30_000, 0.05
#: the replica path: scripts/paper_quant.py's QIsing (GraphQSKT(1024, 16,
#: Gamma=0.3, beta=2)) and REIsing (GraphSKRE(1024, 5, gamma, beta=0.4) over
#: the gamma grid) with 1024 chains, scripts/bench_all.py's
#: composite_sparse section (Quant and RE over GraphRRG(1000, 3), M=8, 128
#: chains, beta=1) and one float base each (dense GraphQSKNormalT, sparse
#: GraphQEAT), 128 chains. The sweeps and rrr moves of QIsing and of
#: REIsing at gamma=2 are those of the first trajectory points of
#: paper_quant_results.json (6471680 / 16384 and 2554880 / 5120 sweeps, 6004
#: and 17432 moves), whose mean observables the runs are held to within
#: REPLICA_RTOL: a guard against gross faults of the physics (the files'
#: standard errors, printed beside, are 0.02-0.1% of the means)
Q_NK, Q_M, Q_GAMMA, Q_BETA, Q_SEED = 1024, 16, 0.3, 2.0, 8370274
RE_NK, RE_M, RE_BETA, RE_SEED = 1024, 5, 0.4, 8370275
RE_GAMMAS = (2.0, 3.0, 4.0, 5.0)
Q_SWEEPS, Q_RRR, RE_SWEEPS, RE_RRR = 395, 6004, 499, 17432
Q_ITERS_BKL, Q_WTM_SAMPLES, RE_GRID_SWEEPS = 100_000, 10, 100
SP_NK, SP_M, SP_BETA, SP_CHAINS = 1000, 8, 1.0, 128
SP_ITERS_RRR, SP_ITERS_BKL, FLT_ITERS_BKL = 10_000, 300_000, 100_000
REPLICA_RTOL = 0.01
#: sweeps per replica sweep comparison (the plain version takes seconds per
#: sweep at these shapes)
REPLICA_CMP_SWEEPS = 1
#: the perceptron path: scripts/bench_all.py's perc_comm_section (the
#: step, linear and xentr perceptrons at N = 1023, P = 511, seed 5, xentr
#: lambda = 1; 256 chains at beta = 1), the race samplers' and standardMC's
#: run lengths, the EO moves, and the law check's instances (N = 15, P = 9,
#: seed 11: 2^15 states enumerated) and run length
PERC_N, PERC_P, PERC_SEED, PERC_LAM = 1023, 511, 5, 1.0
PERC_CHAINS, PERC_BETA = 256, 1.0
PERC_ITERS_BKL, PERC_ITERS_RRR, PERC_WTM_SAMPLES = 100_000, 20_000, 50
PERC_ITERS_MET, PERC_EO_MOVES = 5_000, 20_000
PERC_LAW_N, PERC_LAW_P, PERC_LAW_SEED, PERC_LAW_ITERS = 15, 9, 11, 40_000
PERC_NAMES = {"step": "GraphPercStep", "linear": "GraphPercLinear",
              "xentr": "GraphPercXEntr"}
#: the factor path: equilibrated_factors on GraphRRG(10^4, 3, +-J,
#: seed=167) at beta=3 with 128 chains, each row measured for >= half of
#: FACTORS_TARGET_S; its E_per_spin_eq held within FACTORS_EQ_TOL of the
#: JAX package's factors_sparse row (bench_all_results.json, about twice the
#: spread of the JAX runs)
FACTORS_BETA, FACTORS_CHAINS, FACTORS_TARGET_S = 3.0, 128, 1.0
FACTORS_EQ_TOL = 0.01
#: the generic path: GraphRRG(1000, 3) +-J, 128 chains at beta=2, after
#: GEN_EQ_SWEEPS sweeps of kernel bklMC; the generic and kernel runs'
#: lengths (rrr moves, bkl virtual iterations, wtm samples of step N*10),
#: and the overlap pipeline's chains, disorders and iterations
GEN_N, GEN_CHAINS, GEN_BETA, GEN_EQ_SWEEPS = 1000, 128, 2.0, 1000
GEN_ITERS_RRR, GEN_ITERS_BKL, GEN_WTM_SAMPLES = 2_000, 200_000, 20
GEN_OV_CHAINS, GEN_OV_DISORDER, GEN_OV_ITERS = 16, 2, 50_000
#: the snapshot stream at the north star's width: GraphRRG(10_000, 3) +-J,
#: 128 chains, generic bklMC with the configuration observer from a random
#: start for WIDE_ITERS virtual iterations (several chunks once the chunk
#: is cut to the stream budget), four checkpoints; the device memory the
#: call may take beyond STREAM_BYTES
WIDE_N, WIDE_CHAINS, WIDE_ITERS, WIDE_CKPT = 10_000, 128, 1_000, 4
WIDE_SLACK_BYTES = 1 << 26
#: the wrapper path (`wrapper_path`): scripts/bench_all.py's composite_sparse
#: shape for local entropy, GraphLocalEntropy(1000, M=8, gamma=1, beta=1)
#: over GraphRRG(1000, 3, +-J, seed=13), 128 chains (composite N = 9000);
#: kernel bklMC's equilibration on flatten(LE) in sweeps of N; the generic
#: samplers' moves a chain (bkl and wtm: their iterations and time from the
#: kernel run's z/N); the kernel routes' run lengths on flatten(LE)
LE_NK, LE_M, LE_GAMMA, LE_BETA, LE_SEED, LE_CHAINS = 1000, 8, 1.0, 1.0, 13, \
    128
LE_EQ_SWEEPS, LE_MOVES, LE_CKPT = 50, 2000, 20
LE_ITERS_MET, LE_ITERS_BKL, LE_EO_MOVES, LE_SWEEPS = 300_000, 200_000, \
    20_000, 20
#: the control of the generic-against-kernel check: generic rrrMC on LE at
#: this multiple of LE_BETA must fail the check
LE_FAULT_BETA = 0.9
#: bench_all.py's tle_rrg_sweep row: GraphTopologicalLocalEntropy(1000, 8,
#: 0.5, 0.3, 1.0, GraphRRG(1000, 3, +-J, seed=13)), 128 chains, sweepMC on
#: the composite masks; then generic bklMC moves a chain
TLE_GAMMA, TLE_LAMBDA, TLE_SWEEPS, TLE_BKL_MOVES = 0.5, 0.3, 20, 500
#: bench_all.py's perc_comm_section committee rows at 256 chains, beta=1,
#: and the generic samplers' run lengths (bkl: one chunk of moves)
COMM_ROWS = (("GraphCommStep", 65, 15), ("GraphCommReLU", 64, 16),
             ("GraphCommQu", 64, 16))
COMM_P, COMM_SEED, COMM_CHAINS, COMM_BETA = 487, 5, 256, 1.0
COMM_ITERS_MET, COMM_ITERS_RRR, COMM_BKL_MOVES = 2000, 500, 500
#: the PT path (`pt_path`): GraphRRG(10^4, 3, +-J, seed 167), PT_T rungs
#: beta_k = PT_BETA0 + PT_DBETA k (beta_c ~ 0.88 for K = 3), PT_CHAINS
#: chains a rung (1024 chains, row 1's case), PT_SWEEPS sweeps a round,
#: PT_ROUNDS rounds; the rounds traced for the device busy share
PT_T, PT_BETA0, PT_DBETA, PT_CHAINS = 32, 1.0, 0.02, 32
PT_SWEEPS, PT_ROUNDS, PT_TRACE_ROUNDS = 10, 200, 5
#: the law check: rung 0 (beta = 1, below beta_c) against sweepMC at beta
#: 1 over PT_LAW_ROUNDS rounds and as many sweeps. Both age from random
#: spins: their gap falls from 0.0034 at 200 rounds to 0.00072 at 2000 and
#: 0.00024 at 6000, inside its 5-sigma bound only there
#: (scripts/torch_pt_equilibration.py); the control runs at
#: PT_CONTROL_BETA
PT_LAW_ROUNDS, PT_CONTROL_BETA = 6000, 1.1
#: the ET path (`et_path`): ET_T slots flatten(GraphQuant(ET_NK, ET_M,
#: Gamma_k, ET_BETA, base)) over GraphRRG(ET_NK, 3, +-J, seed ET_SEED) (the
#: wrapper path's base), Gamma_k = ET_GAMMA0 + ET_DGAMMA k (spaced so that
#: every adjacent pair swaps at this size), ET_CHAINS chains, ET_ROUNDS
#: rounds of sweep_kernel (one sweep a slot)
ET_T, ET_NK, ET_M, ET_BETA, ET_SEED = 8, 1000, 8, 2.0, 13
ET_GAMMA0, ET_DGAMMA, ET_CHAINS, ET_ROUNDS = 1.0, 0.02, 128, 100
#: the shard path (`shard_path`): standardMC's moves over 4 shards of the
#: card, and bklMC's iterations a disorder instance
SHARD_ITERS, DISORDER_ITERS = 100_000, 200_000
#: the device every phase runs on (the script refuses to run without one)
DEV = "cuda"
#: each entry of the `kernels` line: the TPU kernel it replaces, its CUDA
#: source, and its __global__ function, whose instantiations' register
#: counts the ptxas report of the build gives (function/policy: the
#: instantiations of a shared template with that policy type, as the EO
#: kernels' move loop, csrc/eo_chain.cuh, takes its flip)
ENTRIES = {
    "site_metropolis": ("rrrmc_tpu/ops/site_pallas.py:47", "site.cu",
                        "site_resident_kernel"),
    "rejfree_sparse": ("rrrmc_tpu/ops/rejfree_pallas.py:870",
                       "rejfree_sparse.cu", "rejfree_sparse_kernel"),
    "rejfree_lattice": ("rrrmc_tpu/ops/rejfree_pallas.py:118",
                        "rejfree_sparse.cu", "rejfree_sparse_kernel"),
    "sweep_checkerboard": ("rrrmc_tpu/ops/sweep_pallas.py:64", "sweep.cu",
                           "sweep_kernel"),
    "sk_sweep": ("rrrmc_tpu/ops/sk_pallas.py:77", "sk_sweep.cu",
                 "sk_sweep_kernel"),
    "sk_sweep_hbm": ("rrrmc_tpu/ops/sk_pallas.py:115", "sk_sweep.cu",
                     "sk_sweep_kernel"),
    "rejfree_dense": ("rrrmc_tpu/ops/rejfree_pallas.py:349",
                      "rejfree_dense.cu", "rejfree_dense_kernel"),
    "rejfree_stream": ("rrrmc_tpu/ops/rejfree_pallas.py:559",
                       "rejfree_dense.cu", "rejfree_dense_kernel"),
    "eo_sparse": ("rrrmc_tpu/ops/eo_pallas.py:449", "eo_sparse.cu",
                  "eo_chain_kernel/SparseFlip"),
    "eo_lattice": ("rrrmc_tpu/ops/eo_pallas.py:66", "eo_sparse.cu",
                   "eo_chain_kernel/SparseFlip"),
    "eo_dense": ("rrrmc_tpu/ops/eo_pallas.py:66", "eo_dense.cu",
                 "eo_chain_kernel/DenseFlip"),
    "eo_stream": ("rrrmc_tpu/ops/eo_pallas.py:255", "eo_dense.cu",
                  "eo_chain_kernel/DenseFlip"),
    "rejfree_pspin": ("rrrmc_tpu/ops/rejfree_pallas.py:1122",
                      "rejfree_sparse.cu", "rejfree_sparse_kernel"),
    "eo_pspin": ("rrrmc_tpu/ops/eo_pallas.py:600", "eo_sparse.cu",
                 "eo_chain_kernel/SparseFlip"),
    "rejfree_sat": ("rrrmc_tpu/ops/sat_pallas.py:306", "rejfree_sat.cu",
                    "rejfree_sat_kernel"),
    "eo_sat": ("rrrmc_tpu/ops/sat_pallas.py:528", "eo_sat.cu",
               "eo_chain_kernel/SatFlip"),
    "rejfree_replica": ("rrrmc_tpu/ops/quant_pallas.py:232",
                        "rejfree_replica.cu", "rejfree_replica_kernel"),
    "replica_sweep": ("rrrmc_tpu/ops/quant_pallas.py:478",
                      "replica_sweep.cu", "replica_sweep_kernel"),
    "rejfree_replica_sparse": ("rrrmc_tpu/ops/quant_pallas.py:752",
                               "rejfree_replica.cu",
                               "rejfree_replica_kernel"),
    "rejfree_perc": ("rrrmc_tpu/ops/perc_pallas.py:138", "rejfree_perc.cu",
                     "rejfree_perc_kernel"),
    "eo_perc": ("rrrmc_tpu/ops/perc_pallas.py:404", "eo_perc.cu",
                "eo_perc_kernel"),
}
#: the H100 SXM's published device-memory rate, float32 rate outside the
#: tensor cores, and int8 tensor-core rate (dense), and its L2 cache
HBM_BYTES_PER_S, F32_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 67e12, 1.979e15
L2_BYTES = 50e6
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
    products a TPU kernel ran on its MXU) over the int8 tensor-core rate.
    A dense EO case (`eo_case`) takes beside it the bytes of the winner's
    row of J that every chain-move reads from device memory, the share of
    J beyond the L2 cache, B moves N sizeof(J) max(0, 1 - L2_BYTES / |J|)
    over the memory rate, as its bound where that is larger."""
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


def _ops_eo(N, moves, flip_sites, bins, tie_groups=None):
    """Tau-EO moves over N sites: a Philox call for each rank draw and one
    for each group of four sites that holds a member of the selected class
    where it holds more than one (`tie_groups`, summed over the chain-moves
    as the plain version counts them, ops/eo.py::TIE_GROUPS; None: one a
    move, the count before the law's groups were counted), the key and the
    class compare per site in the tie race (3), the select (a scan over the
    histogram's `bins`; for keys without exact bins, bins == 0, a pass over
    the N keys for their coarse bins and a scan of COARSE_BINS, as the
    sparse kernel's coarse select needs it) and the flip, which updates
    `flip_sites` fields (a product and an add each, and two bin moves
    each)."""
    from rrrmc_tpu_torch.ops.eo import COARSE_BINS

    select = bins if bins else N + COARSE_BINS
    flip = flip_sites * 4
    calls = moves + (moves if tie_groups is None else tie_groups)
    return calls * PHILOX_OPS + moves * (3 * N + select + flip)


def _ops_perc(N, P, moves, mode, xentr, bins=0, tie_groups=None):
    """(ops, int8_ops) of perceptron moves, per chain and move: the g pass
    over the P patterns (4 operations each; xentr 22: three softplus of 6
    and 4 more), the full product xi^T g, 2 N P, and dE from it (2 per
    site), all twice for rrr, whose z' needs dE at the flipped state too;
    the P-entry stability update (2 each); then the race's pass over the N
    sites as `_ops_race` counts it, or for mode "eo" the EO select and tie
    race as `_ops_eo` counts them (`bins` of the histogram, refilled every
    move: a pass over the N keys besides; 0 for keys without exact bins,
    whose coarse bins `_ops_eo` counts; the tie race's member groups
    `tie_groups`). The TPU
    kernel ran the product on its MXU; for step and linear (xi = +-1, g in
    [-2, 2]) it goes in `int8_ops`, xentr's float32 product in `ops`."""
    evals = 2 if mode == "rrr" else 1
    product = moves * evals * 2 * N * P
    per = evals * ((22 if xentr else 4) * P + 2 * N) + 2 * P
    if mode == "eo":
        ops = _ops_eo(N, moves, 0, bins, tie_groups) + moves * (
            per + (N + bins if bins else 0))
    else:
        ops = _ops_race(N, moves, 0, mode, 0) + moves * per
    return (ops + product, 0.0) if xentr else (ops, product)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reference(chunk):
    """A kernel wrapper's plain version: `<name>_reference` of its module."""
    return getattr(sys.modules[chunk.__module__],
                   chunk.__name__ + "_reference")


def launched(kernels) -> int:
    """The launches so far of a kernel, or of a tuple of kernels, by their
    names in ops/launch.py's LAUNCHES."""
    from rrrmc_tpu_torch.ops.launch import LAUNCHES

    return sum(LAUNCHES[k] for k in
               ((kernels,) if isinstance(kernels, str) else kernels))


def reset_launches(*kernels) -> None:
    """Set the launch counts of `kernels` (names, or tuples of names) to
    0."""
    from rrrmc_tpu_torch.ops.launch import LAUNCHES

    for k in kernels:
        for name in ((k,) if isinstance(k, str) else k):
            LAUNCHES[name] = 0


def only_plan() -> dict:
    """The one plan recorded since ops/launch.py's PLANS was cleared."""
    from rrrmc_tpu_torch.ops.launch import PLANS

    (plan,) = PLANS.values()
    return plan


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


def padded_graph(N, seed):
    """A sparse +-J graph with integer fields in -2..2 whose degrees run
    from 1 to 6: its neighbour rows are padded with N (K = 6, beyond the
    site kernel's 4 neighbours read ahead of the acceptance)."""
    import numpy as np
    import rrrmc_tpu_torch as rt

    rng = np.random.default_rng(seed)
    adj = [set() for _ in range(N)]
    for i in range(N):
        for j in rng.choice(N, size=rng.integers(1, 4), replace=False):
            if j != i and len(adj[i]) < 6 and len(adj[j]) < 6:
                adj[i].add(int(j))
                adj[j].add(i)
    for i in range(N):
        if not adj[i]:
            j = (i + 1) % N
            adj[i].add(j)
            adj[j].add(i)
    adj = [sorted(a) for a in adj]
    J = [[1.0 if (i + j) % 3 else -1.0 for j in a] for i, a in enumerate(adj)]
    return rt.make_pairwise(adj, J, N, h=rng.integers(-2, 3, N).astype(float),
                            integer_scale=1.0, device=DEV)


def plan_of_site(plan) -> str:
    """The site kernel's launch plan (ops/launch.py's PLANS["site"]) as
    printed."""
    return (f"[route {plan['route']}, {plan['field']} fields, "
            f"{plan['chains']} chains a block, {plan['warps']} warps, "
            f"{plan['smem']} shared bytes, {plan['blocks_per_sm']} blocks/SM, "
            f"{plan['registers']} registers, {plan['spill_bytes']} local "
            f"bytes]")


def site_case(model, label, card, n_moves=SITE_MOVES, B=CHAINS, sites=None,
              betas=None):
    """The site kernel against its plain version: n_moves moves of B chains
    from one random start on one schedule (uniform random sites unless
    `sites` is given), one Philox seed, every chain at BETA or chain b at
    betas[b] (a [B] tensor: the kernel reads beta * scale chain by chain);
    integer couplings EQUAL, float ones under `_compare`'s float rule. The
    kernel gets the family's bound on |lf| (its resident field type), as
    SiteSampler gives it."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, site
    from rrrmc_tpu_torch.samplers.common import init_lfT
    from rrrmc_tpu_torch.samplers.families import half_bound

    st = rt.init_state(model, B, seed=SEED, device=DEV)
    if sites is None:
        g = torch.Generator(device=DEV).manual_seed(SEED)
        sites = torch.randint(0, model.N, (n_moves,), generator=g,
                              device=DEV, dtype=torch.int32)
    n_moves = sites.shape[0]
    base = dict(sigT=st.sigma.t().contiguous(), lfT=init_lfT(model, st.sigma),
                E=st.E.clone(), acc=torch.zeros(B, dtype=torch.int32,
                                                device=DEV))
    beta_s = (BETA * model.scale if betas is None else
              (betas.double() * model.scale).float().to(DEV))
    kw = dict(seed=SEED, beta_s=beta_s, move0=0, chain0=0)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a, **extra):
        fn(a["sigT"], a["lfT"], a["E"], a["acc"], sites, model.neigh,
           model.J, **kw, **extra)

    bound_kw = {"field_bound": half_bound(model)}
    run(site.site_chunk, fresh(), **bound_kw)           # warm-up
    k = fresh()
    ms = _events_ms(lambda: run(site.site_chunk, k, **bound_kw))
    plan = dict(launch.PLANS["site"])
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
          f"diverged chains {bad}, max abs err {err:.3g} "
          f"{plan_of_site(plan)} [{card}]")
    return {"kernel": "site_metropolis", "case": label, "B": B,
            "moves": n_moves, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": bad, "max_abs_err": err, "errs": errs,
            "site_plan": plan}


def site_cases(card):
    """The site kernel beside its row (`site_case`): a conflict-heavy
    graph and a schedule of repeated sites (groups of 1-4 moves), padded
    rows with fields, K = 8 (EA-4D), a ragged batch, int16 and int32
    resident fields, and the global route above shared memory (integer
    and float32); each must take its route and field type. Then
    `site_groups_case`."""
    import numpy as np
    import torch
    import rrrmc_tpu_torch as rt

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    small = rt.GraphRRG(64, 3, (-1, 1), seed=3, device=DEV)
    repeats = torch.as_tensor(np.repeat(np.random.default_rng(SEED).integers(
        0, 8, SITE_CMP_MOVES // 4), 4).astype(np.int32), device=DEV)
    wide = rt.GraphRRG(SITE_GLOBAL_N, 3, (-1, 1), seed=5, device=DEV)
    wide_f = rt.GraphRRGNormal(SITE_GLOBAL_N, 3, seed=5, device=DEV)
    # (case, route and field type it must take)
    cases = [
        (site_case(small, "GraphRRG(64, 3) conflict-heavy", card,
                   SITE_CMP_MOVES), "resident", "int8"),
        (site_case(small, "GraphRRG(64, 3) repeated sites", card,
                   sites=repeats, B=37), "resident", "int8"),
        (site_case(padded_graph(2000, SEED), "padded rows, fields", card,
                   SITE_CMP_MOVES), "resident", "int8"),
        # K = 8: past the neighbours read ahead and the cut's registers
        (site_case(rt.GraphEA(6, 4, (-1, 1), seed=SEED, device=DEV),
                   "EA-4D L=6 (K=8)", card, SITE_CMP_MOVES), "resident",
         "int8"),
        (site_case(m, "RRG+-J ragged", card, SITE_CMP_MOVES,
                   B=SITE_RAGGED_B), "resident", "int8"),
        (site_case(rt.GraphRRG(N_MAIN, 3, (-70, 30), seed=SEED, device=DEV),
                   "RRG J in {-70, 30} (bound 210)", card, SITE_CMP_MOVES),
         "resident", "int16"),
        (site_case(rt.GraphRRG(N_MAIN, 3, (-1.5, 0.5), seed=SEED,
                               device=DEV),
                   "RRG (-1.5, 0.5) fixed point", card, SITE_CMP_MOVES),
         "resident", "int32"),
        (site_case(wide, f"GraphRRG({SITE_GLOBAL_N}, 3) global", card,
                   SITE_CMP_MOVES // 2, B=SITE_GLOBAL_B), "global", "int8"),
        (site_case(wide_f, f"GraphRRGNormal({SITE_GLOBAL_N}, 3) global",
                   card, SITE_CMP_MOVES // 2, B=SITE_GLOBAL_B), "global",
         "float32")]
    for c, route, field in cases:
        got = (c["site_plan"]["route"], c["site_plan"]["field"])
        require(got == (route, field), f"site {c['case']}: plan {got}, "
                                       f"expected {(route, field)}")
    return [c for c, _, _ in cases] + [site_groups_case(m, card)]


def site_groups_case(model, card):
    """The cut of the path's schedules on the card (`site.group_lengths`,
    walked from move 0) against the plain `site.site_groups`: the random
    sites of one standardMC launch (drawn as SiteSampler draws them) and
    the site-sweep route's permutations of the same length; and random
    sites on EA-4D L=6, whose K + 1 = 9 neighbourhood members pass the
    cut kernel's registers."""
    import numpy as np
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import site
    from rrrmc_tpu_torch.ops.site import _perm_of

    g = torch.Generator(device=DEV).manual_seed(1)
    random = torch.randint(0, model.N, (SITE_PATH_MOVES,), generator=g,
                           device=DEV, dtype=torch.int32)
    perm = torch.as_tensor(np.concatenate(
        [_perm_of(15, s, model.N)
         for s in range(-(-SITE_PATH_MOVES // model.N))])[:SITE_PATH_MOVES]
        .astype(np.int32), device=DEV)
    ea4 = rt.GraphEA(6, 4, (-1, 1), seed=SEED, device=DEV)
    out = {}
    for name, m, sites in (("random", model, random),
                           ("permutations", model, perm),
                           ("EA-4D L=6 (K=8), random", ea4,
                            random[:SITE_CMP_MOVES] % ea4.N)):
        dev_groups = site.walk_groups(site.group_lengths(sites, m.neigh,
                                                         m.N))
        want = site.site_groups(sites, m.neigh, m.N)
        require(np.array_equal(dev_groups, want),
                f"site groups ({name}): the card's cut differs from "
                f"site_groups")
        out[name] = sites.shape[0] / len(want)
    print(f"site groups on the path's schedules ({SITE_PATH_MOVES} moves, "
          f"GraphRRG(10^4, 3)): the card's cut equals site_groups; mean "
          f"group {out['random']:.2f} moves (random sites), "
          f"{out['permutations']:.2f} (permutations); EA-4D L=6 (K=8) "
          f"{out['EA-4D L=6 (K=8), random']:.2f}  [{card}]")
    return {"kernel": "site_groups", "mean_group": out}


def plan_of_sweep(plan) -> str:
    """The checkerboard kernel's launch plan (ops/launch.py's
    PLANS["sweep"])."""
    return (f"[{plan['chains']} chains a block, {plan['threads']} threads, "
            f"{plan['lanes']} a lane, {plan['smem']} shared bytes, "
            f"{plan['blocks_per_sm']} blocks/SM, {plan['registers']} "
            f"registers, {plan['spill_bytes']} local bytes]")


def sweep_case(model, label, B, card, one_lane=False):
    """The checkerboard kernel against its plain version: SWEEPS sweeps of B
    chains from one random start, one Philox seed; spins and energies must
    be EQUAL (integer arithmetic; the exp path's float32 exp and threshold
    round alike under -fmad=false). one_lane: the kernel gets rows of one
    chain a lane where the Sweeper's rows take four."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, sweep

    sw = sweep.Sweeper(model, BETA)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    rows = {} if one_lane else {"rows": sw.rows}

    def run(fn, **extra):
        sigma, E = st.sigma.clone(), st.E.clone()
        ms = _events_ms(lambda: fn(
            sigma, E, sw.Jp, sw.Jm, sw.th, L=sw.L, D=sw.D, n_sweeps=SWEEPS,
            beta2s=sw.beta2s, seed=SEED, **extra))
        return sigma, E, ms

    run(sweep.sweep_chunk, **rows)                        # warm-up
    ks, kE, ms = run(sweep.sweep_chunk, **rows)
    plan = dict(launch.PLANS["sweep"])
    # a call's last launch: the fields epilogue, the spins and E unchanged
    aux = torch.empty_like(st.sigma, dtype=torch.int32)
    fs, fE, _ = run(sweep.sweep_chunk, aux=aux, **rows)
    require(torch.equal(fs, ks) and torch.equal(fE, kE)
            and launch.PLANS["sweep"] == plan,
            f"sweep {label}: a launch with aux moves sigma, E or the plan")
    require(torch.equal(aux, model.local_fields(ks)),
            f"sweep {label}: the epilogue's fields differ from local_fields "
            f"({int((aux != model.local_fields(ks)).sum())} sites)")
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
          f"{bound_ms:.3g} ms ({bound_by}), equal, epilogue's fields equal "
          f"{plan_of_sweep(plan)} "
          f"[{card}]")
    return {"kernel": "sweep_checkerboard", "case": label, "B": B,
            "sweeps": SWEEPS, "table": sw.table, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": 0, "max_abs_err": 0.0, "sweep_plan": plan}


def site_sweep_instantiations(log: str, card: str) -> None:
    """Every instantiation of the site kernels (resident, global, cut) and
    of the checkerboard kernel: registers and spill bytes from the ptxas
    report (when this run built the library) and local bytes a thread from
    the CUDA runtime's attributes. Fails on a spill or a local byte."""
    import re

    from rrrmc_tpu_torch.ops import launch

    names = ("site_resident_kernel", "site_global_kernel", "site_cut_kernel",
             "sweep_kernel")
    ptx, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if any(f"{len(n)}{n}" in m.group(1)
                                   for n in names) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["spill"] = max(int(m.group(1)),
                                                  int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["registers"] = int(m.group(1))
    demangled = _demangle(set(ptx))
    for f in sorted(ptx, key=demangled.get):
        rec = ptx[f]
        print(f"site/sweep instantiation {demangled[f]}: registers "
              f"{rec.get('registers')}, spill bytes {rec.get('spill')} "
              f"(ptxas)  [{card}]")
        require(rec.get("spill", 0) == 0, f"{demangled[f]} spills")
    local = {}
    for field, name in enumerate(("int8", "int16", "int32", "float32")):
        for chains in (0, 1, 2, 4, 8):
            local[f"site {'global' if chains == 0 else 'resident'} "
                  f"{name} W={chains}"] = launch.facts(
                      "rrrmc_site_info", (field,), chains, 0, 0)[2]
    for D in (2, 3, 4):   # D = 4: the run-time-D instantiation
        for table in (0, 1):
            for swar in (0, 1):
                local[f"sweep D={D if D < 4 else 'any'} table={table} "
                      f"swar={swar}"] = launch.facts(
                          "rrrmc_sweep_info", (D, table, swar), 1024, 0,
                          0)[2]
    print(f"site and sweep instantiations' local bytes a thread: "
          f"{json.dumps(local)}  [{card}]")
    require(not any(local.values()), f"site/sweep kernels use local "
                                     f"memory: {local}")


def _fused():
    """The wrappers of the fused race kernels (rejfree_sparse.cu with the
    pairwise or the hypergraph flip, rejfree_dense.cu, rejfree_replica.cu,
    rejfree_sat.cu, rejfree_perc.cu), whose block size and resident type
    the launch rule picks (ops/rejfree.py::fused_plan)."""
    from rrrmc_tpu_torch.ops import (perc, pspin, rejfree, rejfree_dense,
                                     replica, sat)

    return (rejfree.rejfree_sparse_chunk, pspin.rejfree_pspin_chunk,
            rejfree_dense.rejfree_dense_chunk, replica.rejfree_replica_chunk,
            sat.rejfree_sat_chunk, perc.rejfree_perc_chunk)


def plan_text(plan) -> str:
    """A fused launch's plan (ops/rejfree.py::fused_plan's) as printed."""
    if not plan:
        return ""
    where = (f", patterns in {plan['patterns']} memory"
             if "patterns" in plan else
             f", rrr's saved fields: {plan['saved']}" if "saved" in plan
             else "")
    return (f" [T={plan['threads']}, {plan['field']} fields{where}, "
            f"{plan['blocks_per_sm']} blocks/SM, {plan['smem']} shared "
            f"bytes, {plan['registers']} registers, {plan['spill_bytes']} "
            f"local bytes]")


def rejfree_case(model, label, mode, card, kernel="rejfree_sparse",
                 B=CHAINS, beta=BETA, n_moves=RACE_MOVES, ops=None,
                 sigma=None, exact=False):
    """A race kernel against its plain version for one chunk of n_moves
    moves of B chains: the kernel of the model's family
    (samplers/families.py). `ops(moves, applied)` gives the bound's
    operations as `bound`'s (ops, int8_ops) (`_ops_race` by default). The
    kernel takes the family's `race_kw` (a fused kernel's bound on its
    resident fields), and a fused kernel's plain version the block size the
    kernel ran with (the launch's plan, printed). `sigma` [B, N] replaces
    the random start. `exact`: float couplings are held bit for bit too,
    as integer ones are (`_compare`)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, rejfree
    from rrrmc_tpu_torch.samplers.families import family_of

    fam = family_of(model)
    chunk, ref = fam.race, _reference(fam.race)
    fused = chunk in _fused()
    tables = fam.tables(model)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    sig0 = st.sigma if sigma is None else sigma
    E0 = st.E if sigma is None else model.energy(sigma)
    ct = rejfree.coord_dtype(mode)
    z = dict(device=DEV)
    base = dict(sigma=sig0.clone(), lf=model.init_aux(sig0),
                E=E0.clone(), coord=torch.zeros(B, dtype=ct, **z),
                acc=torch.zeros(B, dtype=torch.int32, **z),
                zacc=torch.zeros(B, dtype=torch.float32, **z))
    kw = dict(mode=mode, n_moves=n_moves, seed=SEED, move0=0, chain0=0,
              beta_s=beta * model.scale)
    kernel_kw = fam.race_kw(model)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a, target, **extra):
        a["cs"], a["es"] = fn(a["sigma"], a["lf"], a["E"], a["coord"],
                              a["acc"], a["zacc"], *tables, target=target,
                              **kw, **extra)

    # a warm-up launch, then a timed one, with an unreachable target as on
    # the main path; then half the chains stop mid-chunk at the median
    # coordinate (rrr: all at half the chunk), so that the masking is
    # compared too
    unreachable = 1e30 if mode == "wtm" else 2 ** 30
    probe = fresh()
    run(chunk, probe, unreachable, **kernel_kw)
    full = fresh()
    ms_full = _events_ms(lambda: run(chunk, full, unreachable, **kernel_kw))
    require(all(torch.equal(probe[key], full[key]) for key in probe),
            f"rejfree {mode} {label}: two launches on one input differ")
    target = probe["coord"].double().median().item()
    target = {"wtm": float(target), "bkl": max(int(target), 1),
              "rrr": n_moves // 2}[mode]
    k = fresh()
    launch.PLANS.clear()
    ms = _events_ms(lambda: run(chunk, k, target, **kernel_kw))
    plan = only_plan() if fused else None
    ref_kw = {"threads": plan["threads"]} if fused else {}
    p = fresh()
    plain_ms = _events_ms(lambda: run(ref, p, target, **ref_kw))
    integer = not st.E.dtype.is_floating_point
    bad, err, errs = _compare(f"rejfree {mode} {label}", integer or exact, k,
                              p, B, model.N)
    applied = float(k["acc"].double().sum())
    moves = float(k["coord"].double().sum()) if mode == "rrr" else applied
    bound_ms, bound_by = bound(
        2 * _nbytes(*base.values()) + _nbytes(*tables, k["cs"], k["es"]),
        *(ops(moves, applied) if ops else
          (_ops_race(model.N, moves, applied, mode, fam.flip_sites(model)),)))
    print(f"{kernel} {mode} {label} B={B} moves={n_moves}: kernel "
          f"{ms:.3f} ms ({ms_full:.3f} ms with every chain active), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.3g} ms ({bound_by}), "
          f"diverged chains {bad}, max abs err {err:.3g}{plan_text(plan)} "
          f"[{card}]")
    return {"kernel": kernel, "case": f"{mode} {label}", "B": B,
            "moves": n_moves, "target": target, "ms": ms, "ms_full": ms_full,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": bad, "max_abs_err": err, "errs": errs, "plan": plan}


def classes_case(model, label, card, B=CHAINS, beta=CLASS_BETA,
                 n_moves=RACE_MOVES, sigma=None):
    """The class kernel (rejfree_classes.cu, bklMC's kernel on integer
    sparse models) against its plain version on one chunk of n_moves moves
    of B chains from one input and one Philox seed: every output EQUAL, bit
    for bit (spins, fields, energies, flips, coordinates, z/N sums and both
    streams), once with every chain active and once with half of them
    stopping mid-chunk at the median coordinate. `sigma` [B, N] replaces
    the random start. Times both launches with CUDA events; the bound
    counts the kernel's bytes and K + 3 operations an applied flip."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch
    from rrrmc_tpu_torch.ops import rejfree_classes as rc
    from rrrmc_tpu_torch.samplers.families import half_bound

    bound_lf = half_bound(model)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    sig0 = st.sigma if sigma is None else sigma
    E0 = st.E if sigma is None else model.energy(sigma)
    z = dict(device=DEV)
    base = dict(sigma=sig0.clone(), lf=model.init_aux(sig0), E=E0.clone(),
                coord=torch.zeros(B, dtype=torch.int32, **z),
                acc=torch.zeros(B, dtype=torch.int32, **z),
                zacc=torch.zeros(B, dtype=torch.float32, **z))
    kw = dict(mode="bkl", n_moves=n_moves, seed=SEED, move0=0, chain0=0,
              beta_s=beta * model.scale, field_bound=bound_lf)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a, target):
        a["cs"], a["es"] = fn(a["sigma"], a["lf"], a["E"], a["coord"],
                              a["acc"], a["zacc"], model.neigh, model.J,
                              target=target, **kw)

    out = {}
    for what in ("every chain", "half stopping"):
        target = 2 ** 30
        if what == "half stopping":
            target = max(int(out["every chain"][0]["coord"].double()
                             .median().item()), 1)
        k = fresh()
        ms = _events_ms(lambda: run(rc.rejfree_classes_chunk, k, target))
        p = fresh()
        plain_ms = _events_ms(
            lambda: run(rc.rejfree_classes_chunk_reference, p, target))
        _compare(f"classes {label} ({what})", True, k, p, B, model.N)
        out[what] = (k, ms, plain_ms)
    k, ms, plain_ms = out["half stopping"]
    plan = dict(launch.PLANS["rejfree_classes"])
    require(plan["spill_bytes"] == 0, f"classes {label}: {plan}")
    applied = float(k["acc"].double().sum())
    bound_ms, bound_by = bound(
        2 * _nbytes(*base.values())
        + _nbytes(model.neigh, model.J, k["cs"], k["es"]),
        applied * (model.neigh.shape[1] + 3))
    print(f"rejfree_classes bkl {label} B={B} moves={n_moves}: kernel "
          f"{ms:.3f} ms ({out['every chain'][1]:.3f} ms with every chain "
          f"active), plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms "
          f"({bound_by}), equal bit for bit [{plan['classes']} classes, "
          f"{plan['groups']} groups, {plan['blocks_per_sm']} blocks/SM, "
          f"{plan['smem']} shared bytes, {plan['registers']} registers, "
          f"{plan['spill_bytes']} local bytes] [{card}]")
    return {"kernel": "rejfree_classes", "case": f"bkl {label}", "B": B,
            "moves": n_moves, "ms": ms, "ms_full": out["every chain"][1],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": 0.0, "classes_plan": plan}


def classes_cases(card):
    """The class kernel against its plain version at the benchmark's
    shapes and on every path through it: GraphRRG(10^4, 3, +-J) with 1024
    chains from random spins at beta = 2 (the race row's case, first: it
    gives the kernel's row) and at CLASS_BETA from spins that
    CLASS_WARM_ITERS iterations of kernel bklMC reached (the cell's
    regime), GraphEA(16, 3, +-J) with 1024 chains at beta = 2, a +-J RRG
    with integer fields in -2..2 (six classes), and the ferromagnetic RRG
    from all spins up, where every flip raises E (the least occupied class
    above 0), and the L = 2 lattice, whose rows hold each neighbour twice
    (lane 0 applies the slots in order). Returns the cases."""
    import dataclasses

    import numpy as np
    import torch
    import rrrmc_tpu_torch as rt

    rrg = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    _, warm = rt.bklMC(rrg, CLASS_BETA, CLASS_WARM_ITERS,
                       step=CLASS_WARM_ITERS, chains=CHAINS, seed=SEED)
    require(rt.LAST_ROUTE["pick"] == "classes",
            f"bklMC on the +-J RRG: pick {rt.LAST_ROUTE}")
    lat = rt.GraphEA(16, 3, (-1, 1), seed=42, device=DEV)
    fielded = dataclasses.replace(rrg, h=torch.as_tensor(
        np.random.default_rng(SEED).integers(-2, 3, N_MAIN),
        dtype=rrg.h.dtype, device=DEV))
    ferro = rt.GraphRRG(N_MAIN, 3, (1,), seed=SEED, device=DEV)
    up = torch.ones((HYPER_CHAINS, N_MAIN), dtype=torch.int8, device=DEV)
    return [classes_case(rrg, "RRG+-J", card, beta=BETA),
            classes_case(rrg, "RRG+-J equilibrated", card, sigma=warm.sigma),
            classes_case(lat, "EA3D-L16+-J", card, beta=2.0),
            classes_case(fielded, "RRG+-J fields", card, n_moves=CMP_MOVES),
            classes_case(ferro, "ferro RRG all up", card, B=HYPER_CHAINS,
                         n_moves=CMP_MOVES, sigma=up),
            classes_case(rt.GraphEA(2, 3, (-1, 1), seed=42, device=DEV),
                         "EA3D-L2+-J (each neighbour twice)", card,
                         beta=1.0, n_moves=CMP_MOVES)]


def sk_case(model, label, B, n_sweeps, card, kernel, warm=0, beta=BETA):
    """The dense sweep kernel against its plain version: n_sweeps sweeps of
    B chains from one random start, or (warm > 0, an equilibrium case) from
    the state that `warm` sweeps of the kernel reach from it, one Philox
    seed; spins, local fields and energies must be EQUAL (integer
    arithmetic, one threshold table)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, sk

    sw = sk.SKSweeper(model, beta)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    sig0, lf0, E0 = st.sigma, model.local_fields(st.sigma), st.E
    if warm:
        sig0, lf0, E0 = sig0.clone(), lf0.clone(), E0.clone()
        sk.sk_sweep_chunk(sig0, lf0, E0, sw.J8, sw.th, n_sweeps=warm,
                          seed=SEED)

    def run(fn, sweeps=n_sweeps, sigma=sig0, lf=lf0, E=E0, sweep0=warm):
        sigma, lf, E = sigma.clone(), lf.clone(), E.clone()
        ms = _events_ms(lambda: fn(sigma, lf, E, sw.J8, sw.th,
                                   n_sweeps=sweeps, seed=SEED,
                                   sweep0=sweep0))
        return sigma, lf, E, ms

    # the warm-up checks J's symmetry and the table in the wrapper; the
    # timed launches skip it, as SKSweeper's do
    run(sk.sk_sweep_chunk)                                # warm-up
    kern = functools.partial(sk.sk_sweep_chunk, checked=True)
    ks, klf, kE, ms = run(kern)
    plan = dict(launch.PLANS["sk_sweep"])
    from rrrmc_tpu_torch.ops.cuda_build import library
    require(library().rrrmc_sk_smem(model.N, plan["hmax_bytes"])
            == plan["smem"],
            f"sk_sweep {label}: the plan's shared bytes are not the kernel's")
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
    flips, sig, lf, E = 0, sig0, lf0, E0
    for s_ in range(n_sweeps):
        s2, lf, E, _ = run(kern, 1, sig, lf, E, warm + s_)
        flips += int((s2 != sig).sum())
        sig = s2
    require(torch.equal(sig, ks), f"sk_sweep {label}: split launches differ")
    # an attempted flip: a quarter Philox call, the threshold and compare;
    # an accepted one adds its row of J to the chain's N local fields, a
    # product and an add each: the rank-W commit, the TPU kernel's int8 MXU
    # product, at the int8 tensor-core rate
    bound_ms, bound_by = bound(
        2 * _nbytes(sig0, lf0, E0) + _nbytes(sw.J8, sw.th),
        B * model.N * n_sweeps * (PHILOX_OPS / 4 + 4),
        int8_ops=flips * 2 * model.N)
    print(f"{kernel} {label} B={B} sweeps={n_sweeps}"
          f"{f' after {warm} warm sweeps' if warm else ''}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms "
          f"({bound_by}), accepted {flips / (B * model.N * n_sweeps):.4f} "
          f"of the attempts, equal, split launches equal [{plan_line(plan)}]"
          f" [{card}]")
    return {"kernel": kernel, "case": label, "B": B, "sweeps": n_sweeps,
            "warm": warm, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "accepted": flips,
            "diverged": 0, "max_abs_err": 0.0, "sweep_plan": plan}


def plan_line(plan) -> str:
    """A dense or composite sweep's launch plan, for the case line."""
    return (f"{plan['chains']} chains a block, span {plan['span']}, "
            f"{plan['smem']} shared bytes, {plan['path']} commit, J loads "
            f"of {plan['loads']} bytes"
            + (f", hmax in {plan['hmax_bytes']} bytes"
               if "hmax_bytes" in plan else ""))


def plan_of_eo(plan) -> str:
    """An EO launch plan, for the case line."""
    if "route" in plan:
        return (f"{plan['route']} route, {plan['warps']} warps a chain, "
                f"{plan['chains']} chains a block, {plan['key']} keys, "
                f"{plan['select']} select of {plan['bins']} bins, "
                f"{plan['smem']} shared bytes, {plan['blocks_per_sm']} "
                f"blocks/SM, {plan['registers']} registers, "
                f"{plan['spill_bytes']} local bytes")
    return (f"{plan['threads']} threads, patterns in {plan['patterns']} "
            f"memory, {plan['select']} select of {plan['bins']} bins, "
            f"{plan['smem']} shared bytes, {plan['blocks_per_sm']} "
            f"blocks/SM, {plan['registers']} registers, "
            f"{plan['spill_bytes']} local bytes")


def eo_case(model, label, B, card, kernel, ops=None, warps=None,
            n_moves=EO_CMP_MOVES, key=None):
    """An EO kernel against its plain version: n_moves tau-EO moves of B
    chains from one random start, one Philox seed, the sampler's select
    (the histogram for integer keys, the radix select for float ones; the
    sparse kernel's plan, which must give `warps` a chain where that is
    given, and `key` keys where that is given). Spins and best spins,
    itmin, E and Emin and the local fields are held to `_compare`'s rule
    (the dense and K-SAT kernels' bit for bit, float J too); the same moves
    split
    over two launches (move0, off the kernels' batch of 32 rank draws) must
    equal the one launch. `ops(moves, bins, tie_groups)` gives the bound's
    operations as `bound`'s (ops, int8_ops) (`_ops_eo` by default); the
    bound counts the tie race's member groups of this run (the plain
    version's ops/eo.py::TIE_GROUPS), and `bound_two_calls_ms` the earlier
    count of two Philox calls a move."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import eo, launch
    from rrrmc_tpu_torch.samplers.eo import rank_table
    from rrrmc_tpu_torch.samplers.families import family_of, resident_state

    fam = family_of(model)
    chunk, ref, tables = fam.eo, _reference(fam.eo), fam.tables(model)
    kw = fam.eo_kw(model)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    integer = not st.E.dtype.is_floating_point
    lf0, E0 = resident_state(fam, model, st.sigma, st.E)
    cdf = rank_table(model.N, EO_TAU, DEV)

    def fresh():
        return [st.sigma.clone(), lf0.clone(), E0.clone(), E0.clone(),
                st.sigma.clone(), torch.zeros(B, dtype=torch.int32,
                                              device=DEV)]

    def run(fn, a, n=n_moves, move0=0):
        fn(*a, *tables, cdf, n_moves=n, seed=SEED, move0=move0, **kw)

    run(chunk, fresh())                                   # warm-up
    k = fresh()
    launch.PLANS.clear()
    ms = _events_ms(lambda: run(chunk, k))
    plan = only_plan()
    if warps is not None:
        require(plan["warps"] == warps, f"{kernel} {label}: the plan gives "
                f"{plan['warps']} warps a chain, not {warps}")
    if key is not None:
        require(plan["key"] == key, f"{kernel} {label}: the plan gives "
                f"{plan['key']} keys, not {key}")
    # the same moves in two launches, the second from move0
    s = fresh()
    third = n_moves // 3
    run(chunk, s, third)
    run(chunk, s, n_moves - third, third)
    p = fresh()
    plain_ms = _events_ms(lambda: run(ref, p))
    groups = eo.TIE_GROUPS["groups"]
    exact = integer or kernel in ("eo_dense", "eo_stream", "eo_sat")
    bad, err, errs = _compare(f"{kernel} {label}", exact, outs_eo(k),
                              outs_eo(p), B, model.N)
    require(third % 32 and all(torch.equal(a, b) for a, b in zip(s, k)),
            f"{kernel} {label}: two launches differ from one")
    e_err = max(float((model.energy(k[i]).double() - k[j].double()).abs()
                      .max()) for i, j in ((0, 2), (4, 3)))
    require(e_err <= (1e-4 * model.N if not integer else 0.0),
            f"{kernel} {label}: E or Emin != energy, by {e_err}")
    bins = eo.hist_bins(integer, fam.key_max(model))
    moves = B * n_moves
    nbytes = 2 * _nbytes(*fresh()) + _nbytes(*tables, cdf)

    def ops_of(g):
        return (ops(moves, bins, g) if ops else
                (_ops_eo(model.N, moves, fam.flip_sites(model), bins, g),))

    bound_ms, bound_by = bound(nbytes, *ops_of(groups))
    two_calls_ms, _ = bound(nbytes, *ops_of(None))
    # a dense kernel reads the winner's row of J at every chain-move: the
    # share of J beyond L2 comes from device memory each time
    row_ms = None
    if kernel in ("eo_dense", "eo_stream"):
        J = tables[0]
        row_ms = 1e3 * moves * _nbytes(J[0]) * max(
            0.0, 1.0 - L2_BYTES / _nbytes(J)) / HBM_BYTES_PER_S
        if row_ms > bound_ms:
            bound_ms, bound_by = row_ms, "bytes"
    print(f"{kernel} {label} B={B} moves={n_moves} select="
          f"{f'histogram of {bins} bins' if bins else 'radix'}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms "
          f"({bound_by}; {groups / moves:.1f} tie groups a move; two "
          f"Philox calls a move: {two_calls_ms:.3g} ms"
          f"{f'; rows of J beyond L2: {row_ms:.3g} ms' if row_ms is not None else ''}"
          f"), diverged chains {bad}, max abs err {err:.3g}"
          f"{f' [{plan_of_eo(plan)}]' if plan else ''} [{card}]")
    return {"kernel": kernel, "case": label, "B": B, "moves": n_moves,
            "bins": bins, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rows_ms": row_ms,
            "bound_two_calls_ms": two_calls_ms,
            "tie_groups_a_move": groups / moves, "diverged": bad,
            "max_abs_err": err, "errs": errs, "eo_plan": plan}


def outs_eo(a):
    """An EO case's outputs as `_compare` reads them."""
    import torch

    return {"sigma": torch.cat([a[0], a[4]], dim=1), "acc": a[5],
            "E": torch.stack([a[2], a[3]], dim=1), "lf": a[1]}


def eo_route_cases(card, rrg, rrgn, ps):
    """The redesigned sparse EO kernel on the plan routes and key types the
    main paths' cases above do not reach, each held bit for bit to its plain
    version (`eo_case`, which prints the plan), each at a shape for which
    the plan (ops/eo.py::eo_plan) picks the warps a chain that the case
    names, and fails where it picks others: EA-3D L=2, whose rows list each
    neighbour twice (the flip's repeated-site path; one warp a chain);
    GraphRRG(10^4) +-J with 128 chains (32 warps) and 256 (8);
    GraphRRGNormal(10^4) with 128 chains (32) and GraphRRGNormal(600) with
    256 (one warp, the coarse select); PSpin3 on 8 warps (256 chains), 4
    (528) and, GraphPSpin3(600, 3), one; int16 keys (+-70 couplings, 421
    bins), int32 keys with the coarse select (+-1000 couplings, bound 3000)
    and float keys on {-1, 0, 1} couplings (halves -0.0 and +0.0, and
    crowded coarse bins: the radix select over the selected bin) on 8 warps
    (256 chains), the last also on one warp (600 sites)."""
    import torch
    import rrrmc_tpu_torch as rt

    def zero(m):
        return dataclasses.replace(m, J=torch.where(
            m.J > 0.5, 1.0, torch.where(m.J < -0.5, -1.0, 0.0)))

    rrgn600 = rt.GraphRRGNormal(600, 3, seed=7, device=DEV)
    wide = dataclasses.replace(rrg, J=rrg.J * 70)
    huge = dataclasses.replace(rrg, J=rrg.J * 1000)
    crowded = "J in {-1, 0, 1} float (crowded bins)"
    out = []
    for model, label, B, kernel, warps in (
            (rt.GraphEA(2, 3, (-1, 1), seed=42, device=DEV),
             "GraphEA(2, 3) (each row lists its sites twice)", 64,
             "eo_lattice", 1),
            (rrg, "GraphRRG(10^4) 128 chains", HYPER_CHAINS, "eo_sparse", 32),
            (rrg, "GraphRRG(10^4) 256 chains", 256, "eo_sparse", 8),
            (rrgn, "GraphRRGNormal(10^4) 128 chains", HYPER_CHAINS,
             "eo_sparse", 32),
            (rrgn600, "GraphRRGNormal(600)", 256, "eo_sparse", 1),
            (ps, "GraphPSpin3(7500, 3) 256 chains", 256, "eo_pspin", 8),
            (ps, "GraphPSpin3(7500, 3) 528 chains", 528, "eo_pspin", 4),
            (rt.GraphPSpin3(600, 3, seed=7, device=DEV),
             "GraphPSpin3(600, 3)", 256, "eo_pspin", 1),
            (wide, "GraphRRG(10^4) J*70 (int16 keys)", 256, "eo_sparse", 8),
            (huge, "GraphRRG(10^4) J*1000 (int32 keys, coarse)", 256,
             "eo_sparse", 8),
            (zero(rrgn), f"GraphRRG(10^4) {crowded}", 256, "eo_sparse", 8),
            (zero(rrgn600), f"GraphRRG(600) {crowded}", 256, "eo_sparse",
             1)):
        out.append(eo_case(model, label, B, card, kernel, warps=warps,
                           n_moves=EO_ROUTE_MOVES))
    return out


def eo_dense_sat_route_cases(card, sk1, drrg, skn, sat):
    """The dense and K-SAT EO kernels on the plan routes and key types the
    main paths' cases do not reach, each held bit for bit to its plain
    version (`eo_case`, which prints the plan), each at a shape for which
    the plan (ops/eo.py::eo_plan) picks the warps a chain and the key type
    that the case names, and fails where it picks others. Dense (the plan
    takes the fewest warps that give a lane at most 40 sites):
    GraphSK(500) with 256 chains (one warp, int16 keys, rows at 500-byte
    strides, most not 16-byte aligned); densify(GraphRRG(16000)) with 64
    chains (32 warps) and densify(GraphRRG(10^4)) with 256 (8), int8 keys;
    GraphSKNormal(8192) with 64 chains (8 warps, float32 keys);
    GraphSK(1100) with J scaled to +-127 (one warp, int32 keys with the
    coarse select); float couplings in {-1, 0, 1} (halves -0.0 and +0.0,
    and crowded coarse bins: the radix select over the selected bin) on one
    warp (600 spins) and on 4 (4096 spins, 256 chains). K-SAT: the
    GraphSAT(10^4, 3, 4.2) of the path with 256 chains (8 warps),
    GraphSAT(2000, 3, 4.2) with 1024 (4) and GraphSAT(600, 3, 4.2) (one
    warp), all with uint8 keys, and GraphSAT(1000, 3, 45), whose Cmax above
    127 takes the uint16 keys (4 warps)."""
    import torch
    import rrrmc_tpu_torch as rt

    def zero(m):
        return dataclasses.replace(m, J=torch.where(
            m.J > 0.5, 1.0, torch.where(m.J < -0.5, -1.0, 0.0)))

    sk11 = rt.GraphSK(1100, seed=4, device=DEV)
    skn600 = rt.GraphSKNormal(600, seed=4, device=DEV)
    crowded = "J in {-1, 0, 1} float (crowded bins)"
    dense = "eo_stream"
    out = []
    for model, label, B, kernel, warps, key in (
            (rt.GraphSK(500, seed=4, device=DEV), "GraphSK(500)", 256,
             "eo_dense", 1, "int16"),
            (rt.densify(rt.GraphRRG(16_000, 3, (-1, 1), seed=7, device=DEV)),
             "densify(GraphRRG(16000))", 64, dense, 32, "int8"),
            (drrg, "densify(GraphRRG(10^4)) 256 chains", 256, dense, 8,
             "int8"),
            (rt.GraphSKNormal(8192, seed=4, device=DEV),
             "GraphSKNormal(8192)", 64, dense, 8, "float32"),
            (dataclasses.replace(sk11, J=sk11.J * 127),
             "GraphSK(1100) J*127 (int32 keys, coarse)", 256, "eo_dense", 1,
             "int32"),
            (zero(skn600), f"GraphSKNormal(600) {crowded}", 256, "eo_dense",
             1, "float32"),
            (zero(skn), f"GraphSKNormal(4096) {crowded}", 256, dense, 4,
             "float32"),
            (sat, "GraphSAT(10^4, 3, 4.2) 256 chains", 256, "eo_sat", 8,
             "uint8"),
            (rt.GraphSAT(2000, 3, 4.2, seed=SEED, device=DEV),
             "GraphSAT(2000, 3, 4.2)", CHAINS, "eo_sat", 4, "uint8"),
            (rt.GraphSAT(600, 3, 4.2, seed=SEED, device=DEV),
             "GraphSAT(600, 3, 4.2)", 256, "eo_sat", 1, "uint8"),
            (rt.GraphSAT(1000, 3, 45.0, seed=SEED, device=DEV),
             "GraphSAT(1000, 3, 45) (Cmax > 127: uint16 keys)", HYPER_CHAINS,
             "eo_sat", 4, "uint16")):
        out.append(eo_case(model, label, B, card, kernel, warps=warps,
                           n_moves=EO_ROUTE_MOVES, key=key))
    return out


def eo_instantiations(log: str, card: str) -> None:
    """Every instantiation of the redesigned EO kernels (eo_chain.cuh's move
    loop in eo_sparse.cu: warps a chain, key type, hypergraph flip; in
    eo_dense.cu: warps a chain, key type; in eo_sat.cu: warps a chain, key
    type; eo_perc.cu: family, select, pattern memory): its registers and
    spill bytes (ptxas, when this run built the library) and its local
    bytes a thread (the CUDA runtime). Fails on a spill or a local byte."""
    import re

    from rrrmc_tpu_torch.ops import eo, eo_sat, launch

    names = ("eo_chain_kernel", "eo_perc_kernel")
    ptx, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if any(_instance_of(n, m.group(1))
                                   for n in names) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["spill"] = max(int(m.group(1)),
                                                  int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["registers"] = int(m.group(1))
    readable = _demangle(ptx)
    for fn in sorted(ptx, key=readable.get):
        rec = ptx[fn]
        print(f"EO instantiation {readable[fn]}: registers "
              f"{rec.get('registers')}, spill bytes {rec.get('spill')} "
              f"(ptxas)  [{card}]")
        require(rec.get("spill", 0) == 0, f"{readable[fn]} spills")
    require(not log or len(ptx) == 24 + 16 + 8 + 10,
            f"{len(ptx)} EO instantiations in the ptxas report, expected 24 "
            f"sparse, 16 dense, 8 K-SAT and 10 perceptron ones")
    local = {}
    for w in eo.EO_WARPS:
        for key, code in eo.KEY_CODES.items():
            for pspin in ((0, 1) if code < 2 else (0,)):
                local[f"eo_sparse {w} warps {str(key)[6:]}"
                      f"{' pspin' if pspin else ''}"] = launch.facts(
                          "rrrmc_eo_sparse_info", (code, pspin), w, 0,
                          0)[1:3]
    for w in eo.EO_WARPS:
        for key, code in eo.KEY_CODES.items():
            local[f"eo_dense {w} warps {str(key)[6:]}"] = launch.facts(
                "rrrmc_eo_dense_info", (code,), w, 0, 0)[1:3]
        for key, code in eo_sat.SAT_KEY_CODES.items():
            local[f"eo_sat {w} warps {str(key)[6:]}"] = launch.facts(
                "rrrmc_eo_sat_info", (code,), w, 0, 0)[1:3]
    for fam in (0, 1, 2):
        for hist in ((1, 0) if fam < 2 else (0,)):
            for sx in (1, 0):
                local[f"eo_perc fam {fam} {'hist' if hist else 'radix'} "
                      f"{'shared' if sx else 'global'}"] = launch.facts(
                          "rrrmc_eo_perc_info", (fam, hist, sx), 256, 0,
                          0)[1:3]
    print(f"EO instantiations' (registers, local bytes a thread): "
          f"{json.dumps(local)}  [{card}]")
    require(not any(v[1] for v in local.values()),
            f"EO kernels use local memory: {local}")


def _instance_of(name: str, mangled: str) -> bool:
    """Whether a mangled function name is an instantiation of an ENTRIES
    function name (function, or function/policy type)."""
    fn, *policy = name.split("/")
    return f"{len(fn)}{fn}" in mangled and all(p in mangled for p in policy)


def registers(log: str) -> dict:
    """{function name: [fewest, most] registers over its instantiations}
    from the ptxas report of the build (empty when nothing was built)."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            for name in {fn for _, _, fn in ENTRIES.values()}:
                if _instance_of(name, fn):
                    lo, hi = out.get(name, [1 << 30, 0])
                    n = int(m.group(1))
                    out[name] = [min(lo, n), max(hi, n)]
            fn = None
    return out


def spill_bytes(log: str) -> dict:
    """{function name: the most spill-store bytes over its instantiations}
    from the ptxas report of the build, for the ENTRIES' functions."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            for name in {fn for _, _, fn in ENTRIES.values()}:
                if _instance_of(name, fn):
                    n = max(int(m.group(1)), int(m.group(2)))
                    out[name] = max(out.get(name, 0), n)
    return out


def _cuda_tool(name: str) -> str:
    """A CUDA toolkit program (cuobjdump, cu++filt) beside nvcc."""
    import os
    import shutil

    from rrrmc_tpu_torch.ops import cuda_build

    cand = os.path.join(os.path.dirname(cuda_build._nvcc()), name)
    found = cand if os.path.exists(cand) else shutil.which(name)
    require(found is not None, f"{name} not found beside nvcc")
    return found


def _demangle(names) -> dict:
    """{mangled: readable} through cu++filt (the mangled name where it
    fails)."""
    names = list(names)
    try:
        out = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (AssertionError, OSError, subprocess.SubprocessError):
        out = []
    if len(out) != len(names):
        return {n: n for n in names}
    return dict(zip(names, (o.split(">(")[0] + ">" for o in out)))


def sweep_instantiations(log: str, card: str) -> None:
    """Every instantiation of the dense sweep kernels: its registers and
    spill bytes (ptxas, when this run built the library), its local bytes
    a thread (the CUDA runtime's attributes), and for the integer ones
    whether the built library's SASS (cuobjdump -sass) holds IMMA or IGMMA,
    the commit's tensor-core product. Fails on a spill or local byte, or an
    integer instantiation without a tensor-core instruction."""
    import re

    from rrrmc_tpu_torch.ops import cuda_build, launch

    ptx, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if any(f"{len(s)}{s}" in m.group(1)
                                   for s in SWEEP_FUNCTIONS) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["spill"] = max(int(m.group(1)),
                                                  int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            ptx.setdefault(fn, {})["registers"] = int(m.group(1))
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                           cuda_build.build_info["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    tensor, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(f"{len(s)}{s}" in m.group(1)
                                   for s in SWEEP_FUNCTIONS) else None
            if fn is not None:
                tensor[fn] = False
            continue
        if fn is not None and re.search(r"\b(IMMA|IGMMA)", line):
            tensor[fn] = True
    names = _demangle(set(tensor) | set(ptx))
    for fn in sorted(set(tensor) | set(ptx), key=names.get):
        integer = "float_kernel" not in fn
        rec = ptx.get(fn, {})
        print(f"sweep instantiation {names[fn]}: registers "
              f"{rec.get('registers')}, spill bytes {rec.get('spill')}"
              f" (ptxas; None: not built in this run), IMMA/IGMMA in its "
              f"SASS {tensor.get(fn)}  [{card}]")
        require(rec.get("spill", 0) == 0, f"{names[fn]} spills")
        require(not integer or tensor.get(fn),
                f"{names[fn]}: no IMMA or IGMMA in its SASS")
    require(sum("float_kernel" not in f for f in tensor) == 12,
            f"{len(tensor)} sweep instantiations in the SASS, expected the "
            f"12 integer ones and the float ones")
    # these entries' out[5]: registers, local bytes a thread, ...
    local = {}
    for hb in (2, 4):
        for vec in (16, 4, 1):
            local[f"sk_sweep hmax {hb} bytes, loads {vec}"] = launch.facts(
                "rrrmc_sk_info", (hb, vec), None, None, 0)[1]
    for is_float in (0, 1):
        for star in (0, 1):
            for vec in ((16, 4, 1) if not is_float else (4,)):
                local[f"replica_sweep {'float' if is_float else 'int'} "
                      f"{'star' if star else 'ring'}"
                      f"{'' if is_float else f', loads {vec}'}"] = \
                    launch.facts("rrrmc_replica_sweep_info",
                                 (is_float, star, vec), None, None, 0)[1]
    print(f"sweep instantiations' local bytes a thread: "
          f"{json.dumps(local)}  [{card}]")
    require(not any(local.values()), f"sweep kernels use local memory: "
                                     f"{local}")


def fused_local_bytes() -> dict:
    """{function name: the most local bytes a thread (spills included) over
    every instantiation of the fused race kernels, every block size,
    resident type, coordinate type, term, perceptron family and pattern
    memory}, from the CUDA runtime's function attributes: known whether or
    not this run built the library."""
    from rrrmc_tpu_torch.ops import launch, rejfree
    from rrrmc_tpu_torch.ops.perc import FAMILY_CODES

    out = {"rejfree_sparse_kernel": 0, "rejfree_dense_kernel": 0,
           "rejfree_replica_kernel": 0, "rejfree_sat_kernel": 0,
           "rejfree_perc_kernel": 0}
    for t in rejfree.FUSED_THREADS:
        for wtm in (0, 1):
            heads = [("rejfree_sat_kernel", "rrrmc_rejfree_sat_info",
                      (wtm,))]
            heads += [("rejfree_perc_kernel", "rrrmc_rejfree_perc_info",
                       (fam, wtm, sx)) for fam in FAMILY_CODES.values()
                      for sx in (0, 1)]
            for field in rejfree.FIELD_CODES.values():
                heads += [("rejfree_sparse_kernel",
                           "rrrmc_rejfree_sparse_info", (field, wtm)),
                          ("rejfree_dense_kernel",
                           "rrrmc_rejfree_dense_info", (field, wtm))]
                heads += [("rejfree_replica_kernel",
                           "rrrmc_rejfree_replica_info", (field, star, wtm))
                          for star in (0, 1)]
            for fn, entry, head in heads:
                local = launch.facts(entry, head, t, 0, 0)[2]
                out[fn] = max(out[fn], local)
    return out


def fused_cases(card):
    """The fused race kernels (rejfree_sparse.cu, rejfree_replica.cu)
    against their plain versions bit for bit where the main paths' cases do
    not reach: each kernel at the other block size the launch rule picks
    (512 threads at 256 chains on GraphRRG(10^4, 3) and GraphQSKT(1024, 16),
    whose paths run 256 at 1024 chains), the resident field types int16
    and int32 (couplings
    scaled to |J| = 100 and 20000 on GraphRRG(10^4, 3) and, for the
    composite, a Quant over GraphRRG(1000, 3) at |J| = 20000), and a start
    whose least bE is above 0 (every spin up on the ferromagnetic
    GraphRRG(J = +1), beta = 4: every flip raises E, so the fused pass sums
    z a second time), for both kernels. int8 (+-J graphs, PSpin3), int16
    (the SK base of QSKT) and f32 (RRGNormal, QSKNormalT) are the main
    paths' cases. Appended after those, so that the kernels' rows keep
    their main-path cases."""
    import dataclasses

    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import rejfree, replica
    from rrrmc_tpu_torch.samplers.families import family_of, resident_state

    rrg = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    mid = dataclasses.replace(rrg, J=rrg.J * 100)
    big = dataclasses.replace(rrg, J=rrg.J * 20000)
    ferro = rt.GraphRRG(N_MAIN, 3, (1,), seed=SEED, device=DEV)
    qb = rt.GraphRRG(SP_NK, 3, (-1, 1), seed=11, device=DEV)
    qbig = rt.GraphQuant(SP_NK, SP_M, 1.0, 1.0,
                         dataclasses.replace(qb, J=qb.J * 20000))
    qferro = rt.GraphQuant(SP_NK, SP_M, 1.0, 1.0,
                           rt.GraphRRG(SP_NK, 3, (1,), seed=11, device=DEV))
    qskt = rt.GraphQSKT(Q_NK, Q_M, Q_GAMMA, Q_BETA, seed=Q_SEED)
    B = HYPER_CHAINS
    up, qup = (torch.ones((B, n), dtype=torch.int8, device=DEV)
               for n in (N_MAIN, qferro.N))
    # the start's least bE over the sites, per chain: above 0 everywhere
    fam = family_of(qferro)
    lf, _ = resident_state(fam, qferro, qup, qferro.energy(qup))
    for what, de, beta in (
            ("ferro RRG", rejfree.pair_de(up.int(), ferro.init_aux(up)), 4.0),
            ("Quant(ferro RRG)", replica.replica_de(
                fam.tables(qferro)[0], qup, lf), 4.0)):
        least = float((beta * de.clamp(min=0).float()).min(1).values.min())
        require(least > 0, f"{what}: the start's least bE is {least}")
    cases = [
        rejfree_case(rrg, "RRG+-J", "bkl", card, B=2 * B, n_moves=CMP_MOVES),
        rejfree_case(mid, "RRG J=+-100", "rrr", card, B=B, beta=0.01,
                     n_moves=CMP_MOVES),
        rejfree_case(big, "RRG J=+-20000", "rrr", card, B=B, beta=1e-4,
                     n_moves=CMP_MOVES),
        rejfree_case(ferro, "ferro RRG all up", "rrr", card, B=B, beta=4.0,
                     n_moves=CMP_MOVES, sigma=up),
        rejfree_case(ferro, "ferro RRG all up", "bkl", card, B=B, beta=4.0,
                     n_moves=CMP_MOVES, sigma=up),
        replica_race_case(qskt, "QSKT(1024, 16)", "bkl", card,
                          "rejfree_replica", 2 * B, Q_BETA, CMP_MOVES),
        replica_race_case(qbig, "Quant(RRG(1000) J=+-20000, M=8)", "rrr",
                          card, "rejfree_replica_sparse", B, 1e-4,
                          CMP_MOVES),
        replica_race_case(qferro, "Quant(ferro RRG(1000) all up, M=8)",
                          "rrr", card, "rejfree_replica_sparse", B, 4.0,
                          CMP_MOVES, sigma=qup),
    ]
    want = {("rejfree_sparse", "RRG J=+-100"): "int16",
            ("rejfree_sparse", "RRG J=+-20000"): "int32",
            ("rejfree_replica_sparse", "Quant(RRG(1000) J=+-20000, M=8)"):
                "int32"}
    for c in cases:
        key = (c["kernel"], c["case"].split(" ", 1)[1])
        if key in want:
            require(c["plan"]["field"] == want[key],
                    f"{key}: resident {c['plan']['field']}, not {want[key]}")
    return cases


def dense_fused_cases(card, sk1, drrg, skn):
    """The dense race kernel (rejfree_dense.cu) against its plain version,
    bit for bit (float J too), where the main paths' cases do not reach:
    every resident type at both block sizes (pinned) in rrr and in bkl or
    wtm (int8 on the densified RRG, int16 on GraphSK(1024), int32 on
    GraphSK(1100) with J scaled to +-127 (rows at 1100-byte strides, most
    not 16-byte aligned), float32 on GraphSKNormal(4096) and (1100)), the
    all-up densified ferromagnet at beta = 4 (every flip raises E: the
    fused pass sums z twice, the z' pass too), and an SK model of
    DENSE_WIDE_N spins (+-1 couplings drawn on the card, int32 fields: the
    earlier kernel's largest N), where rrr's saved fields do not fit beside
    the state and go to global memory. Appended after the main paths'
    cases, so that rows 5 and 6 keep theirs."""
    import dataclasses
    import math

    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.models.dense import FullyConnected
    from rrrmc_tpu_torch.ops import rejfree
    from rrrmc_tpu_torch.ops.rejfree import pinned_threads

    B = HYPER_CHAINS
    sk11 = rt.GraphSK(1100, seed=4, device=DEV)
    wide_j = dataclasses.replace(sk11, J=sk11.J * 127)
    skn11 = rt.GraphSKNormal(1100, seed=4, device=DEV)
    ferro = rt.densify(rt.GraphRRG(2000, 3, (1,), seed=SEED, device=DEV))
    up = torch.ones((B, ferro.N), dtype=torch.int8, device=DEV)
    de = rejfree.pair_de(up.int(), ferro.init_aux(up))
    least = float((4.0 * de.clamp(min=0).float()).min())
    require(least > 0, f"dense ferro all up: the start's least bE is {least}")

    def case(model, label, mode, threads, want, kernel="rejfree_dense",
             **kw):
        with pinned_threads(threads):
            c = rejfree_case(model, label, mode, card, kernel=kernel,
                             exact=True, **kw)
        plan = c["plan"]
        require((threads is None or plan["threads"] == threads)
                and plan["field"] == want,
                f"{kernel} {c['case']}: T={plan['threads']}, "
                f"{plan['field']} fields, not {threads} and {want}")
        return c

    cases = []
    for model, label, want, kernel, beta, runs in (
            (sk1, "GraphSK(1024)", "int16", "rejfree_dense", 4.0,
             ((512, "rrr"), (512, "wtm"))),
            (drrg, "densify(GraphRRG(10^4))", "int8", "rejfree_stream", 4.0,
             ((256, "rrr"), (512, "rrr"), (512, "wtm"))),
            (skn, "GraphSKNormal(4096)", "float32", "rejfree_stream", 4.0,
             ((256, "rrr"), (512, "rrr"), (256, "wtm"))),
            (wide_j, "GraphSK(1100) J=+-127", "int32", "rejfree_dense",
             4.0 / 127, ((256, "rrr"), (512, "rrr"), (256, "bkl"),
                         (512, "wtm"))),
            (skn11, "GraphSKNormal(1100)", "float32", "rejfree_dense", 4.0,
             ((512, "rrr"), (256, "bkl")))):
        cases += [case(model, label, mode, t, want, kernel, B=B, beta=beta,
                       n_moves=CMP_MOVES) for t, mode in runs]
    cases += [case(ferro, "densify(ferro RRG(2000)) all up", mode, None,
                   "int8", B=B, beta=4.0, n_moves=CMP_MOVES, sigma=up)
              for mode in ("rrr", "bkl")]
    # J = triu(+-1, 1) + its transpose, drawn on the card in int8
    n = DENSE_WIDE_N
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    J = torch.randint(0, 2, (n, n), dtype=torch.int8, device=DEV,
                      generator=gen)
    J = torch.triu(J * 2 - 1, 1)
    wide = FullyConnected(J=J + J.t(), N=n, scale=1.0 / math.sqrt(n),
                          h=torch.zeros(n, dtype=torch.int32, device=DEV))
    del J
    label = f"SK({n}) on the card"
    wide_cases = [case(wide, label, "rrr", None, "int32",
                       kernel="rejfree_stream", B=DENSE_WIDE_CHAINS,
                       beta=4.0, n_moves=CMP_MOVES // 8),
                  case(wide, label, "bkl", 256, "int32",
                       kernel="rejfree_stream", B=DENSE_WIDE_CHAINS,
                       beta=4.0, n_moves=CMP_MOVES // 8)]
    require(wide_cases[0]["plan"]["saved"] == "global",
            f"{label}: rrr's saved fields in "
            f"{wide_cases[0]['plan']['saved']} memory")
    del wide
    torch.cuda.empty_cache()
    return cases + wide_cases


def sat_chain(n):
    """A 3-SAT instance whose all-up start has every dE = +1: clause v holds
    v (+), v + 1 (-) and v + 2 (-) mod n, so under all spins up v is its
    clause's sole satisfier and breaks it when flipped, and its other two
    clauses stay satisfied by their own first variable."""
    import numpy as np
    import rrrmc_tpu_torch as rt

    v = np.arange(n)
    A = np.stack([v, (v + 1) % n, (v + 2) % n], axis=1)
    L = np.tile(np.array([1, -1, -1]), (n, 1))
    return rt.make_sat(n, A, L, device=DEV)


def hyper_fused_cases(card):
    """The SAT and perceptron race kernels (rejfree_sat.cu, rejfree_perc.cu)
    against their plain versions where the main paths' cases do not reach:
    each at the block size its path does not pick (pinned: SAT at 256
    threads, its path running 512 at 128 chains; the perceptrons at 512,
    their path running 256, too few sites a thread for 512), SAT rrr and
    bkl from a start whose least bE is above 0 (`sat_chain`, all up, beta =
    4: the fused pass sums z a second time), the perceptrons at 512
    threads on step, linear and xentr (xentr within `_compare`'s float
    rule, which it meets bit for bit on this card), and the pattern bits
    in global memory on GraphPercStep(1023, 2047) (262 KB of bits, above a
    block's shared memory) at both block sizes, and SAT at SAT_WIDE_N
    variables, the earlier SAT kernel's largest N at alpha = 4.2, at both
    block sizes. Every integer case bit for bit. Appended after the
    perceptron path's cases, so that the kernels' rows keep their main-path
    cases."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import sat as sat_ops
    from rrrmc_tpu_torch.ops.rejfree import pinned_threads

    B = HYPER_CHAINS
    sat = rt.GraphSAT(SAT_N, SAT_K, SAT_ALPHA, seed=SEED, device=DEV)
    chain = sat_chain(SAT_N)
    up = torch.ones((B, chain.N), dtype=torch.int8, device=DEV)
    de = sat_ops.de_flip(chain.T, chain.TL)[0](up, chain.init_aux(up))
    least = float((SAT_BETA * de.clamp(min=0).float()).min())
    require(least > 0, f"SAT chain all up: the start's least bE is {least}")
    step = rt.GraphPercStep(PERC_N, PERC_P, seed=PERC_SEED, device=DEV)
    lin = rt.GraphPercLinear(PERC_N, PERC_P, seed=PERC_SEED, device=DEV)
    xen = rt.GraphPercXEntr(PERC_N, PERC_P, PERC_LAM, seed=PERC_SEED,
                            device=DEV)
    wide = rt.GraphPercStep(PERC_N, 4 * PERC_P + 3, seed=PERC_SEED,
                            device=DEV)

    def perc_case(model, label, mode, threads, n_moves=CMP_MOVES):
        xentr = model is xen
        with pinned_threads(threads):
            return rejfree_case(
                model, f"{label}({PERC_N}, {model.P})", mode, card,
                kernel="rejfree_perc", B=PERC_CHAINS, beta=PERC_BETA,
                n_moves=n_moves,
                ops=lambda moves, applied: _ops_perc(
                    PERC_N, model.P, moves, mode, xentr))

    # (case, the block size it must have run at; None: the rule's pick)
    with pinned_threads(256):
        held = [(rejfree_case(sat, "GraphSAT(10^4, 3, 4.2)", "bkl", card,
                              kernel="rejfree_sat", B=B, beta=SAT_BETA,
                              n_moves=CMP_MOVES), 256)]
    wide_sat = rt.GraphSAT(SAT_WIDE_N, SAT_K, SAT_ALPHA, seed=SEED,
                           device=DEV)
    for threads, mode in ((256, "rrr"), (512, "bkl")):
        with pinned_threads(threads):
            held.append((rejfree_case(
                wide_sat, f"GraphSAT({SAT_WIDE_N}, 3, 4.2)", mode, card,
                kernel="rejfree_sat", B=SAT_WIDE_CHAINS, beta=SAT_BETA,
                n_moves=CMP_MOVES), threads))
    held += [(rejfree_case(chain, "SAT chain(10^4) all up", mode, card,
                           kernel="rejfree_sat", B=B, beta=SAT_BETA,
                           n_moves=CMP_MOVES, sigma=up), None)
             for mode in ("rrr", "bkl")]
    held += [(perc_case(step, "GraphPercStep", "bkl", 512), 512),
             (perc_case(lin, "GraphPercLinear", "rrr", 512, CMP_MOVES // 2),
              512),
             (perc_case(xen, "GraphPercXEntr", "rrr", 512), 512),
             (perc_case(wide, "GraphPercStep", "rrr", None), None),
             (perc_case(wide, "GraphPercStep", "bkl", 512), 512)]
    for c, threads in held:
        require(threads is None or c["plan"]["threads"] == threads,
                f"{c['kernel']} {c['case']}: T={c['plan']['threads']}")
        if c["kernel"] == "rejfree_perc":
            where = "global" if f", {wide.P})" in c["case"] else "shared"
            require(c["plan"]["patterns"] == where,
                    f"{c['case']}: patterns in {c['plan']['patterns']}")
    return [c for c, _ in held]


def _ops_replica(N, moves, applied, mode, flip_sites):
    """A composite race move: `_ops_race` plus the site's composite dE (the
    scaled field, the ring partners or mu and fk, two products and an add:
    6) once for each state whose rates the move needs: the current one, and
    for rrr the flipped one of z'."""
    states = 2 if mode == "rrr" else 1
    return _ops_race(N, moves, applied, mode, flip_sites) \
        + moves * N * 6 * states


def replica_race_case(model, label, mode, card, kernel, B, beta, n_moves,
                      sigma=None):
    """The composite race kernel against its plain version for one chunk of
    n_moves moves of B chains, on the family's tables: an integer base must
    agree bit for bit (E and z/N included: the same float32 operations in
    the same order), a float base within `_compare`'s tolerances. The
    kernel takes the family's bound on the base fields (`race_kw`), the
    plain version the block size the kernel ran with; `sigma` [B, N]
    replaces the random start."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, rejfree, replica
    from rrrmc_tpu_torch.samplers.families import family_of, resident_state

    fam = family_of(model)
    tables = fam.tables(model)
    tab = tables[0]
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    sig0 = st.sigma if sigma is None else sigma
    lf, E = resident_state(fam, model, sig0, st.E if sigma is None
                           else model.energy(sigma))
    ct = rejfree.coord_dtype(mode)
    z = dict(device=DEV)
    base = dict(sigma=sig0.clone(), lf=lf, E=E,
                coord=torch.zeros(B, dtype=ct, **z),
                acc=torch.zeros(B, dtype=torch.int32, **z),
                zacc=torch.zeros(B, dtype=torch.float32, **z))
    kw = dict(mode=mode, n_moves=n_moves, seed=SEED, beta_s=beta)
    kernel_kw = fam.race_kw(model)

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    def run(fn, a, target, **extra):
        a["cs"], a["es"] = fn(a["sigma"], a["lf"], a["E"], a["coord"],
                              a["acc"], a["zacc"], *tables, target=target,
                              **kw, **extra)

    unreachable = 1e30 if mode == "wtm" else 2 ** 30
    probe = fresh()
    run(replica.rejfree_replica_chunk, probe, unreachable,      # warm-up
        **kernel_kw)
    full = fresh()
    ms_full = _events_ms(lambda: run(replica.rejfree_replica_chunk, full,
                                     unreachable, **kernel_kw))
    target = probe["coord"].double().median().item()
    target = {"wtm": float(target), "bkl": max(int(target), 1),
              "rrr": n_moves // 2}[mode]
    k = fresh()
    launch.PLANS.clear()
    ms = _events_ms(lambda: run(replica.rejfree_replica_chunk, k, target,
                                **kernel_kw))
    plan = only_plan()
    p = fresh()
    plain_ms = _events_ms(lambda: run(
        replica.rejfree_replica_chunk_reference, p, target,
        threads=plan["threads"]))
    integer = not lf.dtype.is_floating_point
    bad, err, errs = _compare(f"{kernel} {mode} {label}", integer, k, p, B,
                              model.N)
    e_err = float((model.energy(k["sigma"]).double()
                   - k["E"].double()).abs().max())
    require(e_err <= 1e-4 * max(1.0, float(k["E"].abs().max())),
            f"{kernel} {mode} {label}: |E - energy| = {e_err}")
    applied = float(k["acc"].double().sum())
    moves = float(k["coord"].double().sum()) if mode == "rrr" else applied
    bound_ms, bound_by = bound(
        2 * _nbytes(*base.values()) + _nbytes(tab.J, tab.params, k["cs"],
                                              k["es"])
        + (_nbytes(tab.neigh) if tab.neigh is not None else 0),
        _ops_replica(model.N, moves, applied, mode, fam.flip_sites(model)))
    print(f"{kernel} {mode} {label} B={B} moves={n_moves}: kernel "
          f"{ms:.3f} ms ({ms_full:.3f} ms with every chain active), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.3g} ms ({bound_by}), "
          f"diverged chains {bad}, max abs err {err:.3g}{plan_text(plan)} "
          f"[{card}]")
    return {"kernel": kernel, "case": f"{mode} {label}", "B": B,
            "moves": n_moves, "target": target, "ms": ms, "ms_full": ms_full,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "diverged": bad, "max_abs_err": err, "errs": errs, "plan": plan}


def replica_sweep_case(model, label, B, beta, card, warm=0):
    """The composite sweep kernel against its plain version: REPLICA_CMP_
    SWEEPS sweeps of B chains from one random start, or (warm > 0, an
    equilibrium case) from the state that `warm` sweeps of the kernel reach
    from it, one Philox seed. An integer base must agree bit for bit
    (spins, fields, E, accepted counts), a float base within `_compare`'s
    tolerances; the same sweeps split over two launches equal one."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.ops import launch, replica, replica_sweep

    sw = replica_sweep.ReplicaSweeper(model, beta)
    st = rt.init_state(model, B, seed=SEED, device=DEV)
    lf0, E0 = replica.replica_state(model, st.sigma, st.E)
    sig0 = st.sigma
    if warm:
        sig0 = sig0.clone()
        replica_sweep.replica_sweep_chunk(
            sig0, lf0, E0, torch.zeros(B, dtype=torch.int32, device=DEV),
            sw.tab, beta=beta, n_sweeps=warm, seed=SEED)
    n = REPLICA_CMP_SWEEPS

    def run(fn, sweeps=n, sweep0=warm, a=None):
        a = a or {"sigma": sig0.clone(), "lf": lf0.clone(),
                  "E": E0.clone(),
                  "acc": torch.zeros(B, dtype=torch.int32, device=DEV)}
        ms = _events_ms(lambda: fn(a["sigma"], a["lf"], a["E"], a["acc"],
                                   sw.tab, beta=beta, n_sweeps=sweeps,
                                   seed=SEED, sweep0=sweep0))
        return a, ms

    # the warm-up checks an integer base's symmetry in the wrapper; the
    # timed launches skip it, as ReplicaSweeper's do
    run(replica_sweep.replica_sweep_chunk)                  # warm-up
    kern = functools.partial(replica_sweep.replica_sweep_chunk, checked=True)
    k, ms = run(kern)
    plan = dict(launch.PLANS["replica_sweep"])
    from rrrmc_tpu_torch.ops.cuda_build import library
    require(library().rrrmc_replica_sweep_smem(
        sw.tab.Nk, int(plan["path"] == "scalar")) == plan["smem"],
        f"replica_sweep {label}: the plan's shared bytes are not the "
        f"kernel's")
    p, plain_ms = run(replica_sweep.replica_sweep_chunk_reference)
    integer = not lf0.dtype.is_floating_point
    bad, err, errs = _compare(f"replica_sweep {label}", integer, k, p, B,
                              model.N)
    s2, _ = run(kern, sweeps=2)
    s1, _ = run(kern, sweeps=1)
    s1, _ = run(kern, sweeps=1, sweep0=warm + 1, a=s1)
    require(all(torch.equal(s1[key], s2[key]) for key in s1),
            f"replica_sweep {label}: two launches differ from one")
    e_err = float((model.energy(k["sigma"]).double()
                   - k["E"].double()).abs().max())
    require(e_err <= 1e-4 * max(1.0, float(k["E"].abs().max())),
            f"replica_sweep {label}: |E - energy| = {e_err}")
    flips = float(k["acc"].double().sum())
    # an attempted flip: a quarter of a Philox call (four sites share one
    # call's words), dE, exp and the threshold (20); an accepted one adds
    # its base row to the mover's block, Nk products and adds: the TPU
    # kernel's rank-W MXU product, at the int8 tensor-core rate for an
    # integer base, the float32 rate otherwise
    commit = flips * 2 * sw.tab.Nk
    bound_ms, bound_by = bound(
        2 * _nbytes(sig0, lf0, E0, k["acc"])
        + _nbytes(sw.tab.J, sw.tab.params),
        B * model.N * n * (PHILOX_OPS / 4 + 20) + (0 if integer else commit),
        int8_ops=commit if integer else 0.0)
    print(f"replica_sweep {label} B={B} sweeps={n}"
          f"{f' after {warm} warm sweeps' if warm else ''}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3g} ms "
          f"({bound_by}), accepted {flips / (B * model.N * n):.4f} of the "
          f"attempts, diverged chains {bad}, max abs err {err:.3g}, split "
          f"launches equal [{plan_line(plan)}] [{card}]")
    return {"kernel": "replica_sweep", "case": label, "B": B, "sweeps": n,
            "warm": warm, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "accepted": flips,
            "diverged": bad, "max_abs_err": err, "errs": errs,
            "sweep_plan": plan}


def _drive(runs, card, kernels):
    """Run each (name, model, route, kernel, nominal, unit, n_ckpt, call)
    through the public API with every launch count of `kernels` ({label:
    a kernel's name or a tuple of names}) set to 0 just before the first
    run; returns the per-run records and the counts just after the last. A
    run whose `nominal` is None gets no rate here (one that times
    itself)."""
    import torch
    import rrrmc_tpu_torch as rt

    torch.cuda.synchronize()
    reset_launches(*kernels.values())
    records = []
    for name, model, route, kernel, nominal, unit, n_ckpt, call in runs:
        before = launched(kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es, st = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launched = launched(kernel) - before
        require(n_launched > 0, f"{name}: no kernel launch")
        require(rt.LAST_ROUTE["backend"] == route
                and rt.LAST_ROUTE["impl"] == "cuda",
                f"{name}: route {rt.LAST_ROUTE}")
        require(Es.shape == (st.sigma.shape[0], n_ckpt)
                and bool(torch.isfinite(Es).all()),
                f"{name}: series {tuple(Es.shape)}, finite "
                f"{bool(torch.isfinite(Es).all())}")
        E_re = model.energy(st.sigma)
        if hasattr(model, "resid_m") or (hasattr(model, "loss_table")
                                         and E_re.dtype.is_floating_point):
            # a replica composite's float32 physical E, or the xentr
            # perceptron's float32 E: the JAX package's check,
            # 1e-4 * max(1, |E|)
            err = float((E_re.double() - st.E.double()).abs().max())
            require(err <= 1e-4 * max(1.0, float(E_re.abs().max())),
                    f"{name}: |E - energy| = {err}")
        elif st.E.dtype.is_floating_point:
            # float32 E accumulated over ~1e5 moves at |E| ~ 1e4 (one ulp
            # is 1e-3): 1e-4 per spin
            err = float((E_re.double() - st.E.double()).abs().max())
            require(err <= 1e-4 * model.N, f"{name}: |E - energy| = {err}")
        else:
            err = 0.0
            require(torch.equal(E_re, st.E), f"{name}: E != energy(sigma)")
        if route == "kernel-sweep":      # the fields of the last launch
            require(rt.LAST_ROUTE["aux"] == "kernel"
                    and torch.equal(st.aux, model.local_fields(st.sigma)),
                    f"{name}: aux from {rt.LAST_ROUTE['aux']} differs from "
                    f"local_fields(sigma)")
        chains = st.sigma.shape[0]
        rec = {"run": name, "seconds": dt, "launches": n_launched,
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
                  f"{n_launched} launches)  [{card}]")
        else:
            print(f"{name}: {dt:.2f} s, {n_launched} launches  [{card}]")
    torch.cuda.synchronize()
    return records, {name: launched(k) for name, k in kernels.items()}


def rrg_path(card):
    """The RRG main path (the factor table's samplers) on GraphRRG(10^4,
    3)."""
    import rrrmc_tpu_torch as rt

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    mn = rt.GraphRRGNormal(N_MAIN, 3, seed=SEED, device=DEV)
    iters_met, iters_rrr, iters_bkl = ITERS_MET, ITERS_RRR, ITERS_BKL
    wtm_samples, wtm_step = WTM_SAMPLES, float(N_MAIN)
    runs = [
        ("standardMC", m, "kernel-site", "site", iters_met, "moves", 10,
         lambda: rt.standardMC(m, BETA, iters_met, step=iters_met // 10,
                               chains=CHAINS, seed=1, backend="kernel",
                               device=DEV)),
        ("rrrMC", m, "kernel-rejfree-sparse", "rejfree_sparse", iters_rrr,
         "moves", 10,
         lambda: rt.rrrMC(m, BETA, iters_rrr, step=iters_rrr // 10,
                          chains=CHAINS, seed=2, device=DEV)),
        ("bklMC", m, "kernel-rejfree-sparse", "rejfree_classes",
         iters_bkl, "virtual iterations", 10,
         lambda: rt.bklMC(m, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=3, device=DEV)),
        ("wtmMC", m, "kernel-rejfree-sparse", "rejfree_sparse",
         int(wtm_samples * wtm_step), "virtual iterations", wtm_samples,
         lambda: rt.wtmMC(m, BETA, wtm_samples, step=wtm_step,
                          chains=CHAINS, seed=4, device=DEV)),
        ("bklMC GraphRRGNormal", mn, "kernel-rejfree-sparse",
         "rejfree_sparse", iters_bkl, "virtual iterations", 10,
         lambda: rt.bklMC(mn, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=5, device=DEV)),
    ]
    return _drive(runs, card, {"site_metropolis": "site",
                               "rejfree_sparse": "rejfree_sparse",
                               "rejfree_classes": "rejfree_classes"})


def ea_path(card):
    """The EA-3D benchmark line and the samplers on its lattice, plus the
    site-sweep route of sweepMC on GraphRRG(10^4, 3)."""
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch import bench

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
        ("sweepMC EA-3D L=16 (bench)", lat, "kernel-sweep", "sweep", None,
         None, 1, run_bench),
        ("rrrMC EA-3D L=16", lat, "kernel-rejfree-sparse", "rejfree_sparse",
         iters_rrr, "moves", 8,
         lambda: rt.rrrMC(lat, BETA, iters_rrr, step=iters_rrr // 8,
                          chains=CHAINS, seed=12, device=DEV)),
        ("bklMC EA-3D L=16", lat, "kernel-rejfree-sparse",
         "rejfree_classes", iters_bkl, "virtual iterations", 10,
         lambda: rt.bklMC(lat, BETA, iters_bkl, step=iters_bkl // 10,
                          chains=CHAINS, seed=13, device=DEV)),
        ("wtmMC EA-3D L=16", lat, "kernel-rejfree-sparse", "rejfree_sparse",
         wtm_samples * n, "virtual iterations", wtm_samples,
         lambda: rt.wtmMC(lat, BETA, wtm_samples, step=float(n),
                          chains=CHAINS, seed=14, device=DEV)),
        ("sweepMC GraphRRG (site sweeps)", rrg, "kernel-site-sweep", "site",
         RRG_SWEEPS, "sweeps", 10,
         lambda: rt.sweepMC(rrg, BETA, RRG_SWEEPS, step=RRG_SWEEPS // 10,
                            chains=CHAINS, seed=15, device=DEV)),
    ]
    records, counts = _drive(runs, card,
                             {"sweep_checkerboard": "sweep",
                              "rejfree_lattice": "rejfree_sparse",
                              "rejfree_classes": "rejfree_classes",
                              "site_metropolis": "site"})
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
    beside bklMC on the sparse graph (the class kernel, whose draws differ:
    the two are printed side by side), same seed. Returns the run records,
    the path's launch counts and the launches of each run."""
    import rrrmc_tpu_torch as rt

    b4 = 4.0
    n1 = sk1.N
    runs = [
        ("sweepMC GraphSK(1024)", sk1, "kernel-sk-sweep", "sk_sweep",
         SK_SWEEPS * n1, "attempted flips", 10,
         lambda: rt.sweepMC(sk1, BETA, SK_SWEEPS, step=SK_SWEEPS // 10,
                            chains=8192, seed=21)),
        ("sweepMC GraphSK(8192)", sk8, "kernel-sk-sweep", "sk_sweep",
         SK8_SWEEPS * sk8.N, "attempted flips", 10,
         lambda: rt.sweepMC(sk8, BETA, SK8_SWEEPS, step=SK8_SWEEPS // 10,
                            chains=2048, seed=22, device=DEV)),
        ("bklMC GraphSK(1024) beta=4", sk1, "kernel-rejfree-dense",
         "rejfree_dense", SK_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(sk1, b4, SK_ITERS_BKL, step=SK_ITERS_BKL // 10,
                          chains=CHAINS, seed=23)),
        ("wtmMC GraphSK(1024) beta=4", sk1, "kernel-rejfree-dense",
         "rejfree_dense", SK_WTM_SAMPLES * n1, "virtual iterations",
         SK_WTM_SAMPLES,
         lambda: rt.wtmMC(sk1, b4, SK_WTM_SAMPLES, step=float(n1),
                          chains=CHAINS, seed=24, device=DEV)),
        ("rrrMC GraphSK(1024)", sk1, "kernel-rejfree-dense",
         "rejfree_dense", SK_ITERS_RRR, "moves", 8,
         lambda: rt.rrrMC(sk1, BETA, SK_ITERS_RRR, step=SK_ITERS_RRR // 8,
                          chains=CHAINS, seed=25, device=DEV)),
        ("bklMC GraphSKNormal(4096) beta=4", skn, "kernel-rejfree-dense",
         "rejfree_dense", SKN_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(skn, b4, SKN_ITERS_BKL, step=SKN_ITERS_BKL // 10,
                          chains=128, seed=26, device=DEV)),
        ("bklMC densify(GraphRRG(10^4)) beta=4", drrg, "kernel-rejfree-dense",
         "rejfree_dense", DRRG_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(drrg, b4, DRRG_ITERS_BKL,
                          step=DRRG_ITERS_BKL // 10, chains=CHAINS, seed=27,
                          device=DEV)),
        ("bklMC GraphRRG(10^4) beta=4 (sparse)", rrg,
         "kernel-rejfree-sparse", "rejfree_classes", DRRG_ITERS_BKL,
         "virtual iterations", 10,
         lambda: rt.bklMC(rrg, b4, DRRG_ITERS_BKL, step=DRRG_ITERS_BKL // 10,
                          chains=CHAINS, seed=27, device=DEV)),
    ]
    records, counts = _drive(runs, card,
                             {"sk_sweep": "sk_sweep",
                              "rejfree_dense": "rejfree_dense",
                              "rejfree_classes": "rejfree_classes"})
    d, s = records[-2], records[-1]
    print(f"one factor table, bklMC beta=4 on GraphRRG(10^4): dense race E/N "
          f"{d['E_per_spin']!r} mean z/N {d['mean_z_over_n']!r}; sparse class "
          f"kernel E/N {s['E_per_spin']!r} mean z/N "
          f"{s['mean_z_over_n']!r}  [{card}]")
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
        # float32 E: within 1e-4 per spin, and for the xentr perceptron,
        # whose E is of order P, 1e-4 * max(1, |E|)
        tol = (1e-4 * max(1.0, float(r.E.abs().max()))
               if hasattr(model, "loss_table") else 1e-4 * model.N)
        require(max(errs) <= tol, f"EO {name}: |E - energy| {errs}")
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
    reset_launches("eo_sparse", "eo_dense")
    records, results, per_entry = [], {}, {}
    for name, model, route, entry, chains, moves, seed, row in runs:
        if row is not None:
            chains, moves = rows[row]["chains"], EO_ROW_MOVES[row]
        rec, r = _eo_run(name, model, route, chains, moves, seed,
                         lambda: launched(("eo_sparse", "eo_dense")),
                         card)
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
    return records, {"eo_sparse+eo_lattice": launched("eo_sparse"),
                     "eo_dense+eo_stream": launched("eo_dense")}, per_entry


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

    route, kernel, B = "kernel-rejfree-pspin", "rejfree_pspin", HYPER_CHAINS
    bkl_b, rrr_b, n = PS_BETA_BKL, PS_BETA_RRR, ps.N
    runs = [
        ("bklMC GraphPSpin3(7500, 3) beta=1.5", ps, route, kernel,
         PS_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(ps, bkl_b, PS_ITERS_BKL, step=PS_ITERS_BKL // 10,
                          chains=B, seed=51)),
        ("rrrMC GraphPSpin3(7500, 3) beta=1.0", ps, route, kernel,
         PS_ITERS_RRR, "moves", 10,
         lambda: rt.rrrMC(ps, rrr_b, PS_ITERS_RRR, step=PS_ITERS_RRR // 10,
                          chains=B, seed=52)),
        ("wtmMC GraphPSpin3(7500, 3) beta=1.5", ps, route, kernel,
         PS_WTM_SAMPLES * n, "virtual iterations", PS_WTM_SAMPLES,
         lambda: rt.wtmMC(ps, bkl_b, PS_WTM_SAMPLES, step=float(n),
                          chains=B, seed=53)),
        ("bklMC GraphPSpin3(7500, 3) beta=1.5, 1024 chains", ps, route, kernel,
         PS_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(ps, bkl_b, PS_ITERS_BKL, step=PS_ITERS_BKL // 10,
                          chains=CHAINS, seed=54)),
    ]
    records, counts = _drive(runs, card, {"rejfree_pspin": kernel})
    row = _physics_rows()["eo_pspin7500"]
    reset_launches("eo_pspin")
    rec, _ = _eo_run("GraphPSpin3(7500, 3)", ps, "kernel-eo-pspin",
                     row["chains"], EO_ROW_MOVES["eo_pspin7500"], 55,
                     lambda: launched("eo_pspin"), card)
    _check_row(rec, "eo_pspin7500", row["best_E_per_spin"])
    return records + [rec], {**counts, "eo_pspin": launched("eo_pspin")}


def sat_path(card, sat):
    """The K-SAT path: bklMC, wtmMC and rrrMC at beta=4 through the public
    API (the race launch count set to 0 just before them), then
    extremal_opt (the EO launch count set to 0 just before it), whose mean
    best energy over the chains must lie within SAT_EO_RTOL of the sat_eo
    row's. Returns the run records and the launches of both kernel
    entries."""
    import rrrmc_tpu_torch as rt

    route, kernel = "kernel-rejfree-sat", "rejfree_sat"
    B, beta, n = HYPER_CHAINS, SAT_BETA, sat.N
    runs = [
        ("bklMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, kernel,
         SAT_ITERS_BKL, "virtual iterations", 10,
         lambda: rt.bklMC(sat, beta, SAT_ITERS_BKL,
                          step=SAT_ITERS_BKL // 10, chains=B, seed=61)),
        ("wtmMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, kernel,
         SAT_WTM_SAMPLES * n, "virtual iterations", SAT_WTM_SAMPLES,
         lambda: rt.wtmMC(sat, beta, SAT_WTM_SAMPLES, step=float(n),
                          chains=B, seed=62)),
        ("rrrMC GraphSAT(10^4, 3, 4.2) beta=4", sat, route, kernel,
         SAT_ITERS_RRR, "moves", 10,
         lambda: rt.rrrMC(sat, beta, SAT_ITERS_RRR,
                          step=SAT_ITERS_RRR // 10, chains=B, seed=63)),
    ]
    records, counts = _drive(runs, card, {"rejfree_sat": kernel})
    row = _sat_eo_row()
    reset_launches("eo_sat")
    rec, r = _eo_run("GraphSAT(10^4, 3, 4.2)", sat, "kernel-eo-sat",
                     row["chains"], SAT_EO_MOVES, 64,
                     lambda: launched("eo_sat"), card)
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
    return records + [rec], {**counts, "eo_sat": launched("eo_sat")}


def _perc_law(card, beta=PERC_BETA):
    """The law check on the card: bklMC at beta on GraphPercStep,
    GraphPercLinear and GraphPercXEntr(PERC_LAW_N, PERC_LAW_P), whose
    time-averaged E (the last three quarters of the checkpoints) must equal
    the exact Boltzmann mean over the 2^N states within max(5 standard
    errors, 0.05), the JAX package's rule (tests/test_perc_pallas.py).
    Each record carries the race launches of its own run."""
    import torch
    import rrrmc_tpu_torch as rt

    n = PERC_LAW_N
    states = 2 * ((torch.arange(2 ** n, device=DEV)[:, None]
                   >> torch.arange(n, device=DEV)) & 1).to(torch.int8) - 1
    out = []
    for name, model in (
            ("GraphPercStep", rt.GraphPercStep(n, PERC_LAW_P,
                                               seed=PERC_LAW_SEED)),
            ("GraphPercLinear", rt.GraphPercLinear(n, PERC_LAW_P,
                                                   seed=PERC_LAW_SEED)),
            ("GraphPercXEntr", rt.GraphPercXEntr(n, PERC_LAW_P, PERC_LAM,
                                                 seed=PERC_LAW_SEED))):
        E = model.to_physical(model.energy(states)).double()
        w = torch.exp(-beta * (E - E.min()))
        exact = float((w * E).sum() / w.sum())
        launches0 = launched("rejfree_perc")
        Es, _ = rt.bklMC(model, beta, PERC_LAW_ITERS,
                         step=PERC_LAW_ITERS // 200, chains=PERC_CHAINS,
                         seed=71)
        require(rt.LAST_ROUTE["backend"] == "kernel-rejfree-perc"
                and rt.LAST_ROUTE["impl"] == "cuda",
                f"perceptron law {name}: route {rt.LAST_ROUTE}")
        tail = Es[:, Es.shape[1] // 4:].double()
        got = float(tail.mean())
        sem = float(tail.std()) / (tail.shape[0] * 3.0) ** 0.5
        print(f"bklMC law {name}({n}, {PERC_LAW_P}) beta={beta}: "
              f"mean E {got:.5f}, exact {exact:.5f}, standard error "
              f"{sem:.5f}  [{card}]")
        require(abs(got - exact) < max(5 * sem, 0.05),
                f"perceptron law {name}: {got} against {exact} ({sem})")
        out.append({"run": f"bklMC law {name}({n}, {PERC_LAW_P})",
                    "launches": launched("rejfree_perc") - launches0,
                    "mean_E": got, "exact_E": exact, "sem": sem})
    return out


def perc_path(card, percs):
    """The perceptron path through the public API (scripts/bench_all.py's
    perc_comm_section, 256 chains at beta = 1) with every perceptron launch
    count set to 0 just before it: per family bklMC and rrrMC, and wtmMC on
    step (`_drive`: route, series, E == energy(sigma) exactly for step and
    linear, within 1e-4 max(1, |E|) for xentr); extremal_opt(tau=1.4) on
    step and xentr for PERC_EO_MOVES moves (`_eo_run`); the Metropolis row,
    standardMC(backend="torch"), which runs no kernel. Then, after the
    counts are read, the law check at toy size (`_perc_law`). Returns the
    run records and the launches of both kernel entries on the path."""
    import torch
    import rrrmc_tpu_torch as rt

    route, kernel = "kernel-rejfree-perc", "rejfree_perc"
    B, beta = PERC_CHAINS, PERC_BETA
    runs = []
    for seed, (fam, m) in enumerate(percs.items()):
        label = f"{PERC_NAMES[fam]}({PERC_N}, {PERC_P})"
        runs += [
            (f"bklMC {label} beta=1", m, route, kernel, PERC_ITERS_BKL,
             "virtual iterations", 10,
             lambda m=m, seed=seed: rt.bklMC(
                 m, beta, PERC_ITERS_BKL, step=PERC_ITERS_BKL // 10,
                 chains=B, seed=81 + seed)),
            (f"rrrMC {label} beta=1", m, route, kernel, PERC_ITERS_RRR,
             "moves", 10,
             lambda m=m, seed=seed: rt.rrrMC(
                 m, beta, PERC_ITERS_RRR, step=PERC_ITERS_RRR // 10,
                 chains=B, seed=84 + seed))]
    step = percs["step"]
    runs.append((f"wtmMC GraphPercStep({PERC_N}, {PERC_P}) beta=1", step,
                 route, kernel, PERC_WTM_SAMPLES * step.N,
                 "virtual iterations", PERC_WTM_SAMPLES,
                 lambda: rt.wtmMC(step, beta, PERC_WTM_SAMPLES,
                                  step=float(step.N), chains=B, seed=87)))
    kernels = ("rejfree_perc", "eo_perc")
    torch.cuda.synchronize()
    reset_launches(*kernels)
    records, _ = _drive(runs, card, {"rejfree_perc": kernel})
    for seed, fam in enumerate(("step", "xentr")):
        rec, _ = _eo_run(f"{PERC_NAMES[fam]}({PERC_N}, {PERC_P})", percs[fam],
                         "kernel-eo-perc", B, PERC_EO_MOVES, 88 + seed,
                         lambda: launched("eo_perc"), card)
        records.append(rec)
    # the Metropolis row: the generic torch route, no kernel
    for fam, m in percs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Es, st = rt.standardMC(m, beta, PERC_ITERS_MET,
                               step=PERC_ITERS_MET // 10, chains=B, seed=90)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(rt.LAST_ROUTE["backend"] == "torch"
                and Es.shape == (B, 10) and bool(torch.isfinite(Es).all()),
                f"standardMC {fam}: route {rt.LAST_ROUTE}, series "
                f"{tuple(Es.shape)}")
        err = float((m.energy(st.sigma).double() - st.E.double()).abs()
                    .max())
        require(err <= (1e-4 * max(1.0, float(st.E.abs().max()))
                        if fam == "xentr" else 0.0),
                f"standardMC {fam}: |E - energy| = {err}")
        rate = PERC_ITERS_MET * B / dt
        print(f"standardMC {PERC_NAMES[fam]}({PERC_N}, {PERC_P}) beta=1 "
              f"(torch route): {rate:.4g} moves*chains/s ({dt:.2f} s), E/N "
              f"{float(Es[:, -1].double().mean()) / m.N:.5f}  [{card}]")
        records.append({"run": f"standardMC {PERC_NAMES[fam]}",
                        "seconds": dt,
                        "launches": 0, "chains": B, "rate": rate,
                        "rate_unit": "moves*chains/s", "energy_err": err})
    torch.cuda.synchronize()
    launches = {k: launched(k) for k in kernels}
    return records + _perc_law(card), launches


def _paper_rows() -> dict:
    """The first trajectory points of paper_quant_results.json (the JAX
    package's QIsing and REIsing runs at gamma=2): per engine, the sweeps or
    moves per chain, the mean observable over the chains and its standard
    error."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "paper_quant_results.json"
    d = json.loads(path.read_text())
    q, r = d["QIsing"], d["REIsing"]["gammas"]["2.0"]
    return {"QIsing met": q["met_kernel"]["traj"][0],
            "QIsing rrr": q["rrr_kernel"]["traj"][0],
            "REIsing met": r["met_kernel"]["traj"][0],
            "REIsing rrr": r["rrr_kernel"]["traj"][0]}


def _mean_sem(x):
    x = x.double()
    return float(x.mean()), float(x.std()) / x.numel() ** 0.5


def replica_path(card, qskt, skre, qrrg, rerrg, qnt, qeat):
    """The replica path through the public API, every replica launch count
    set to 0 just before it: QIsing on GraphQSKT(1024, 16) with 1024 chains
    (sweepMC_quant and rrrMC, the paper's engines, then bklMC and wtmMC),
    REIsing on GraphSKRE(1024, 5) with 1024 chains (sweepMC_replica and
    rrrMC at gamma=2, sweepMC_replica at gamma 3, 4 and 5), Quant and RE
    over GraphRRG(1000, 3) (rrrMC, bklMC) and the float bases (bklMC), 128
    chains. Each run checks its route, the CUDA implementation and
    |E - energy| <= 1e-4 max(1, |E|) (`_drive`). The QIsing and REIsing
    (gamma=2) runs' observables are held to the paper rows within
    REPLICA_RTOL. Returns the run records, the path's launch counts and the
    launches of each kernel entry."""
    import rrrmc_tpu_torch as rt
    race = ("rejfree_replica", "rejfree_replica_sparse")

    states = {}

    def keep(name, out):
        states[name] = out[1]
        return out

    dr, sp, sw = ("kernel-rejfree-replica-dense",
                  "kernel-rejfree-replica-sparse", "kernel-replica-sweep")
    nq, nr, B = qskt.N, skre[2.0].N, CHAINS
    runs = [
        ("sweepMC_quant QSKT(1024, 16)", qskt, sw, "replica_sweep",
         Q_SWEEPS * nq, "attempted flips", 5,
         lambda: keep("QIsing met", rt.sweepMC_quant(
             qskt, Q_BETA, Q_SWEEPS, step=Q_SWEEPS // 5, chains=B,
             seed=71))),
        ("rrrMC QSKT(1024, 16)", qskt, dr, race, Q_RRR, "moves", 4,
         lambda: keep("QIsing rrr", rt.rrrMC(
             qskt, Q_BETA, Q_RRR, step=Q_RRR // 4, chains=B, seed=72))),
        ("bklMC QSKT(1024, 16)", qskt, dr, race, Q_ITERS_BKL,
         "virtual iterations", 10,
         lambda: rt.bklMC(qskt, Q_BETA, Q_ITERS_BKL,
                          step=Q_ITERS_BKL // 10, chains=B, seed=73)),
        ("wtmMC QSKT(1024, 16)", qskt, dr, race, Q_WTM_SAMPLES * nq,
         "virtual iterations", Q_WTM_SAMPLES,
         lambda: rt.wtmMC(qskt, Q_BETA, Q_WTM_SAMPLES, step=float(nq),
                          chains=B, seed=74)),
        ("sweepMC_replica SKRE(1024, 5) gamma=2", skre[2.0], sw,
         "replica_sweep", RE_SWEEPS * nr, "attempted flips", 1,
         lambda: keep("REIsing met", rt.sweepMC_replica(
             skre[2.0], RE_BETA, RE_SWEEPS, step=RE_SWEEPS, chains=B,
             seed=75))),
        ("rrrMC SKRE(1024, 5) gamma=2", skre[2.0], dr, race, RE_RRR,
         "moves", 4,
         lambda: keep("REIsing rrr", rt.rrrMC(
             skre[2.0], RE_BETA, RE_RRR, step=RE_RRR // 4, chains=B,
             seed=76))),
    ] + [
        (f"sweepMC_replica SKRE(1024, 5) gamma={g:g}", skre[g], sw,
         "replica_sweep", RE_GRID_SWEEPS * nr, "attempted flips", 1,
         lambda g=g: rt.sweepMC_replica(skre[g], RE_BETA, RE_GRID_SWEEPS,
                                        step=RE_GRID_SWEEPS, chains=B,
                                        seed=77))
        for g in RE_GAMMAS[1:]
    ] + [
        (f"{fn.__name__} {label}", m, sp, race, iters, unit, 10,
         lambda fn=fn, m=m, iters=iters: fn(m, SP_BETA, iters,
                                            step=iters // 10,
                                            chains=SP_CHAINS, seed=78))
        for m, label in ((qrrg, "Quant(RRG(1000, 3), M=8)"),
                         (rerrg, "RE(RRG(1000, 3), M=8)"))
        for fn, iters, unit in ((rt.rrrMC, SP_ITERS_RRR, "moves"),
                                (rt.bklMC, SP_ITERS_BKL,
                                 "virtual iterations"))
    ] + [
        ("bklMC QSKNormalT(1024, 16)", qnt, dr, race, FLT_ITERS_BKL,
         "virtual iterations", 10,
         lambda: rt.bklMC(qnt, Q_BETA, FLT_ITERS_BKL,
                          step=FLT_ITERS_BKL // 10, chains=SP_CHAINS,
                          seed=79)),
        ("bklMC QEAT(8, 3, M=8)", qeat, sp, race, FLT_ITERS_BKL,
         "virtual iterations", 10,
         lambda: rt.bklMC(qeat, Q_BETA, FLT_ITERS_BKL,
                          step=FLT_ITERS_BKL // 10, chains=SP_CHAINS,
                          seed=80)),
    ]
    records, counts = _drive(runs, card, {"rejfree_replica": race,
                                          "replica_sweep": "replica_sweep"})
    rows = _paper_rows()
    re2 = skre[2.0]
    qe = qskt.Qenergy
    re_obs = lambda s: re2.REenergies(s).mean(1) / re2.Nk  # noqa: E731
    # (paper row, its run, the observable: Qenergy, or the mean replica
    # energy per spin as paper_quant.py's _re_obs_batch)
    for key, run, fn in (
            ("QIsing met", "sweepMC_quant QSKT(1024, 16)", qe),
            ("QIsing rrr", "rrrMC QSKT(1024, 16)", qe),
            ("REIsing met", "sweepMC_replica SKRE(1024, 5) gamma=2", re_obs),
            ("REIsing rrr", "rrrMC SKRE(1024, 5) gamma=2", re_obs)):
        mean, sem = _mean_sem(fn(states[key].sigma))
        row = rows[key]
        ref, ref_sem = row["obs_mean"], row["obs_sem"]
        if key.startswith("RE"):
            ref, ref_sem = ref[0], ref_sem[0]
        print(f"  physics row {key} ({row['iters']} iterations a chain): "
              f"port {mean:.5f} (standard error {sem:.5f}), JAX package "
              f"{ref:.5f} ({ref_sem:.5f})  [{card}]")
        next(r for r in records if r["run"] == run).update(
            observable=mean, observable_sem=sem, row=key,
            row_observable=ref, row_sem=ref_sem)
        require(abs(mean - ref) <= REPLICA_RTOL * abs(ref),
                f"{key}: {mean} against the paper row's {ref}")
    per_run = {r["run"]: r["launches"] for r in records}
    dense = sum(v for k, v in per_run.items()
                if k.startswith(("rrrMC QSKT", "bklMC QSKT", "wtmMC QSKT",
                                 "rrrMC SKRE", "bklMC QSKNormalT")))
    sparse = sum(v for k, v in per_run.items() if "RRG" in k or "QEAT" in k)
    return records, counts, {"rejfree_replica": dense,
                             "rejfree_replica_sparse": sparse,
                             "replica_sweep": counts["replica_sweep"]}


def replica_refusals(card):
    """No fallback: the race kernel refuses a composite whose state exceeds
    shared memory (GraphQSKT(4096, 32): 131 072 spins, 401 536 bytes with
    its int16 base fields; GraphQSKT(4096, 16) fits in 204 864), the sweep
    kernel a composite over a sparse base, and the race kernel, asked for,
    a Double that is not a Quant / RE composite; each raises, none runs a
    plain version."""
    import rrrmc_tpu_torch as rt

    big = rt.GraphQSKT(4096, 32, Q_GAMMA, Q_BETA, seed=1)
    sparse = rt.GraphQuant(SP_NK, SP_M, 1.0, 1.0,
                           rt.GraphRRG(SP_NK, 3, (-1, 1), seed=11))
    dbl = rt.GraphRRGNormalDiscretized(SP_NK, 3, (-1, 0, 1), seed=1)
    for what, call, err in (
            ("rrrMC on GraphQSKT(4096, 32)",
             lambda: rt.rrrMC(big, Q_BETA, 10, chains=8), NotImplementedError),
            ("sweepMC_quant on Quant(RRG)",
             lambda: rt.sweepMC_quant(sparse, 1.0, 1, chains=8), ValueError),
            ("bklMC(backend='kernel') on GraphRRGNormalDiscretized",
             lambda: rt.bklMC(dbl, 1.0, 10, chains=8, backend="kernel"),
             NotImplementedError)):
        try:
            call()
        except err as e:
            print(f"refused as it must be: {what}: {e}  [{card}]")
        else:
            raise AssertionError(f"{what} ran: no fallback allowed")


def _factor_row(graph: str, beta: float) -> dict:
    """The JAX package's equilibrated-factor row for (graph, beta) on the
    sparse race kernel (bench_all_results.json `factors_sparse`)."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "bench_all_results.json"
    rows = json.loads(path.read_text())["factors_sparse"]
    return next(r for r in rows if r["graph"] == graph and r["beta"] == beta)


def factors_path(card):
    """The north star's experiment: equilibrated_factors on GraphRRG(10^4,
    3, +-J, seed=167), built and run with no device argument, at beta=3
    with 128 chains, every launch count set to 0 just before it. Each row
    must have run its CUDA kernel (kernel-site, kernel-rejfree-sparse) for
    at least FACTORS_TARGET_S / 2, with finite positive factors and z/N in
    (0, 1]; E_per_spin_eq must lie within FACTORS_EQ_TOL of the JAX row's.
    Each row's E/N and z/N are printed beside the JAX row's and not held:
    rows at beta >= 3 still relax while measured, so they depend on the
    row's length. Returns (records, the launch counts)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.experiments import equilibrated_factors

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED)
    ref = _factor_row("rrg_pmJ", FACTORS_BETA)
    torch.cuda.synchronize()
    reset_launches("site", "rejfree_sparse")
    t0 = time.perf_counter()
    r = equilibrated_factors(m, FACTORS_BETA, chains=FACTORS_CHAINS,
                             target_s=FACTORS_TARGET_S)
    dt = time.perf_counter() - t0
    counts = {"site_metropolis": launched("site"),
              "rejfree_sparse": launched("rejfree_sparse")}
    require(all(n > 0 for n in counts.values()),
            f"factors: launch counts {counts}")
    want = {"standard": "kernel-site", "rrr": "kernel-rejfree-sparse",
            "bkl": "kernel-rejfree-sparse", "wtm": "kernel-rejfree-sparse"}
    records = []
    for name, row in r["rows"].items():
        f = r["factors_vs_rrr"][name]
        require(row["backend"] == want[name] and row["impl"] == "cuda",
                f"factors {name}: route {row['backend']} {row['impl']}")
        require(row["wall_s"] >= FACTORS_TARGET_S / 2,
                f"factors {name}: {row['wall_s']} s measured")
        require(math.isfinite(f) and f > 0, f"factors {name}: factor {f}")
        zn = row.get("mean_z_over_n")
        require(zn is None or 0 < zn <= 1, f"factors {name}: z/N {zn}")
        jr = ref["rows"][name]
        print(f"factors beta={FACTORS_BETA} {name}: factor {f:.6g} "
              f"(JAX {ref['factors_vs_rrr'][name]:.6g}), "
              f"{row['iters_per_s']:.6g} iterations/s a chain over "
              f"{row['wall_s']:.3f} s, E/N {row['E_per_spin']:.5f} "
              f"(JAX {jr['E_per_spin']:.5f}), z/N "
              f"{zn if zn is None else f'{zn:.6f}'} (JAX "
              f"{jr.get('mean_z_over_n')})  [{card}]")
        records.append({"run": f"equilibrated_factors {name}",
                        "seconds": row["wall_s"], "chains": FACTORS_CHAINS,
                        "E_per_spin": row["E_per_spin"],
                        "rate": row["iters_per_s"] * FACTORS_CHAINS,
                        "rate_unit": "nominal iterations*chains/s",
                        **({"mean_z_over_n": zn} if zn is not None else {})})
    diff = r["E_per_spin_eq"] - ref["E_per_spin_eq"]
    print(f"factors beta={FACTORS_BETA}: E_per_spin_eq "
          f"{r['E_per_spin_eq']:.6f}, JAX {ref['E_per_spin_eq']:.6f}, "
          f"difference {diff:+.6f} (bound {FACTORS_EQ_TOL}); equilibration "
          f"{r['equil_wall_s']:.2f} s, {r['equil_moves_per_chain']:.0f} "
          f"moves a chain; path {dt:.1f} s, launches {json.dumps(counts)}"
          f"  [{card}]")
    require(abs(diff) <= FACTORS_EQ_TOL,
            f"factors: E_per_spin_eq off the JAX row's by {diff}")
    return records, counts


def generic_path(card):
    """The generic torch paths of rrrMC, bklMC and wtmMC on the card:
    GraphRRG(1000, 3) +-J, 128 chains at beta=2, equilibrated by kernel
    bklMC; from those spins each sampler with backend="torch" and on its
    kernel route. The generic runs must report the route "torch" and an
    energy equal to energy(sigma). Both runs start from the same spins, so
    each chain's second-half E/N is compared chain by chain: the mean of
    the chains' differences within 5 standard errors of those differences;
    and as a control, generic rrrMC at LE_FAULT_BETA * beta must fail that
    check against the kernel route at beta. Then rrrMC (generic: no race
    kernel takes a Double) on GraphRRGNormalDiscretized(1000, 3, (-1, 1)),
    E within 1e-4
    max(1, |E|); a bklMC hook that stops the run at its first call; and
    stats_overlaps with bklMC (generic: a snapshot observer) on
    GraphRRG(1000, 3), 16 chains, 2 disorders, q2 and x2 finite and in
    [0, 1]. Last, the snapshot stream at the north star's width
    (`wide_snapshots`). Returns (records, the race kernel's launch
    count)."""
    import numpy as np
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.experiments import stats_overlaps

    X = rt.GraphRRG(GEN_N, 3, (-1, 1), seed=SEED)
    torch.cuda.synchronize()
    reset_launches("rejfree_sparse")
    t_path = time.perf_counter()
    eq = GEN_EQ_SWEEPS * GEN_N
    _, st = rt.bklMC(X, GEN_BETA, eq, step=eq, chains=GEN_CHAINS, seed=1,
                     backend="kernel")
    C0 = st.sigma
    step_w = 10.0 * GEN_N
    runs = {
        "rrrMC": lambda b: rt.rrrMC(X, GEN_BETA, GEN_ITERS_RRR,
                                    step=GEN_ITERS_RRR // 20,
                                    chains=GEN_CHAINS, seed=2, C0=C0,
                                    backend=b),
        "bklMC": lambda b: rt.bklMC(X, GEN_BETA, GEN_ITERS_BKL,
                                    step=GEN_ITERS_BKL // 20,
                                    chains=GEN_CHAINS, seed=3, C0=C0,
                                    backend=b),
        "wtmMC": lambda b: rt.wtmMC(X, GEN_BETA, GEN_WTM_SAMPLES,
                                    step=step_w, chains=GEN_CHAINS, seed=4,
                                    C0=C0, backend=b)}

    def halves(Es):
        """Each chain's mean E/N over the second half of its series."""
        return Es[:, Es.shape[1] // 2:].double().mean(1) / GEN_N

    def gap(label, h, h_kernel):
        """The mean of the chains' differences of two runs from C0 and 5
        standard errors of it (the spread of C0 cancels chain by chain),
        printed."""
        d = h - h_kernel
        diff, bnd = float(d.mean()), 5 * float(d.std()) / d.numel() ** 0.5
        print(f"generic {label}: E/N torch {float(h.mean()):.5f}, kernel "
              f"{float(h_kernel.mean()):.5f}, chain by chain difference "
              f"{diff:.6f} (bound {bnd:.6f})  [{card}]")
        return diff, bnd

    records = []
    kernel_halves = {}
    for name, call in runs.items():
        out = {}
        for backend in ("torch", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Es, s = call(backend)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            route = rt.LAST_ROUTE["backend"]
            want = "torch" if backend == "torch" else "kernel-rejfree-sparse"
            require(route == want, f"generic {name} {backend}: route {route}")
            require(Es.shape == (GEN_CHAINS, 20)
                    and bool(torch.isfinite(Es).all())
                    and torch.equal(X.energy(s.sigma), s.E),
                    f"generic {name} {backend}: series or energy")
            out[backend] = (halves(Es), dt, int(s.accepted.sum()))
        (h, ta, na), (kernel_halves[name], tb, _) = out["torch"], \
            out["kernel"]
        print(f"generic {name}: torch {ta:.2f} s, "
              f"{na / GEN_CHAINS:.0f} moves a chain, kernel {tb:.2f} s  "
              f"[{card}]")
        diff, bnd = gap(name, h, kernel_halves[name])
        require(abs(diff) <= bnd, f"generic {name}: E/N differs from the "
                                  f"kernel route's by {diff} > {bnd}")
        records.append({"run": f"{name} backend=torch", "seconds": ta,
                        "chains": GEN_CHAINS, "E_per_spin": float(h.mean()),
                        "difference": diff, "bound": bnd,
                        "moves_per_chain": na / GEN_CHAINS,
                        "moves_rate": na / ta, "energy_err": 0.0})
    Es, s = rt.rrrMC(X, LE_FAULT_BETA * GEN_BETA, GEN_ITERS_RRR,
                     step=GEN_ITERS_RRR // 20, chains=GEN_CHAINS, seed=12,
                     C0=C0, backend="torch")
    require(rt.LAST_ROUTE["backend"] == "torch"
            and torch.equal(X.energy(s.sigma), s.E), "generic control")
    diff, bnd = gap(f"rrrMC at {LE_FAULT_BETA} beta (control)", halves(Es),
                    kernel_halves["rrrMC"])
    require(abs(diff) > bnd, f"generic check: rrrMC at {LE_FAULT_BETA} beta "
                             f"passes it ({diff} <= {bnd})")
    records.append({"run": f"rrrMC backend=torch at {LE_FAULT_BETA} beta "
                           f"(control)", "chains": GEN_CHAINS,
                    "difference": diff, "bound": bnd})

    dbl = rt.GraphRRGNormalDiscretized(GEN_N, 3, (-1, 1), seed=SEED)
    t0 = time.perf_counter()
    Es, s = rt.rrrMC(dbl, GEN_BETA, GEN_ITERS_RRR, step=GEN_ITERS_RRR // 20,
                     chains=GEN_CHAINS, seed=5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = float((dbl.energy(s.sigma).double() - s.E.double()).abs().max())
    require(rt.LAST_ROUTE["backend"] == "torch"
            and err <= 1e-4 * max(1.0, float(s.E.abs().max()))
            and bool(torch.isfinite(Es).all()),
            f"generic rrrMC on a Double: route {rt.LAST_ROUTE['backend']}, "
            f"|E - energy| {err}")
    print(f"generic rrrMC GraphRRGNormalDiscretized({GEN_N}, 3): E/N "
          f"{float(Es[:, -1].double().mean()) / GEN_N:.5f}, |E - energy| "
          f"{err:.3g}, {dt:.2f} s  [{card}]")
    records.append({"run": "rrrMC GraphRRGNormalDiscretized backend=torch",
                    "seconds": dt, "chains": GEN_CHAINS,
                    "E_per_spin": float(Es[:, -1].double().mean()) / GEN_N,
                    "energy_err": err})

    calls = []
    Es, s = rt.bklMC(X, GEN_BETA, 10 ** 8, step=10 ** 6, chains=GEN_CHAINS,
                     seed=6, C0=C0, chunk_moves=64,
                     hook=lambda it, model, state: calls.append(it) or False)
    require(len(calls) == 1 and 0 < calls[0] < 10 ** 8
            and bool((Es[:, -1] == 0).all())
            and torch.equal(X.energy(s.sigma), s.E),
            f"generic bklMC hook: calls {calls}")
    print(f"generic bklMC hook: stopped at iteration {calls[0]} of 10^8 "
          f"after one chunk  [{card}]")

    t0 = time.perf_counter()
    ov = stats_overlaps(
        lambda d: rt.GraphRRG(GEN_N, 3, (-1, 1), seed=d), rt.bklMC,
        GEN_BETA, GEN_OV_ITERS, chains=GEN_OV_CHAINS,
        n_disorder=GEN_OV_DISORDER, seed=SEED)
    dt = time.perf_counter() - t0
    require(rt.LAST_ROUTE["backend"] == "torch", "stats_overlaps route")
    for k in ("q2_mean", "x2_mean"):
        v = ov[k][1:] if k == "q2_mean" else ov[k]
        require(bool(np.all(np.isfinite(v)) and np.all((v >= 0) & (v <= 1))),
                f"stats_overlaps {k} {v}")
    print(f"stats_overlaps bklMC GraphRRG({GEN_N}, 3), {GEN_OV_CHAINS} "
          f"chains, {GEN_OV_DISORDER} disorders: t {ov['t'].tolist()}, q2 "
          f"{np.round(ov['q2_mean'], 4).tolist()}, x2 "
          f"{np.round(ov['x2_mean'], 4).tolist()}, {dt:.2f} s  [{card}]")
    records.append(wide_snapshots(card))
    torch.cuda.synchronize()
    counts = {"rejfree_sparse": launched("rejfree_sparse")}
    require(counts["rejfree_sparse"] > 0, "generic path: no race launch")
    print(f"generic path: {time.perf_counter() - t_path:.1f} s, launches "
          f"{json.dumps(counts)}  [{card}]")
    return records, counts


def wide_snapshots(card) -> dict:
    """Generic bklMC with the configuration observer on GraphRRG(WIDE_N,
    3) +-J, WIDE_CHAINS chains: the [chunk, B, N] snapshot stream must be
    cut to STREAM_BYTES (one hook call a chunk, as many chunks as the
    slowest chain's moves need at the cut chunk), the device memory the
    call takes must stay within STREAM_BYTES + WIDE_SLACK_BYTES, and each
    snapshot's energy must equal the energy series of the same call
    without the observer, with the same final spins."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.experiments import config_series_observer
    from rrrmc_tpu_torch.samplers import bkl

    W = rt.GraphRRG(WIDE_N, 3, (-1, 1), seed=SEED)
    chunk = bkl.STREAM_BYTES // (WIDE_CHAINS * (WIDE_N + 8))
    kw = dict(step=WIDE_ITERS // WIDE_CKPT, chains=WIDE_CHAINS, seed=7,
              backend="torch")
    Es, s1 = rt.bklMC(W, GEN_BETA, WIDE_ITERS, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hooks = []
    t0 = time.perf_counter()
    snaps, s2 = rt.bklMC(W, GEN_BETA, WIDE_ITERS,
                         observer=config_series_observer(),
                         hook=lambda it, m, st: hooks.append(it) or True,
                         **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    moves = int(s2.accepted.max())
    require(rt.LAST_ROUTE["backend"] == "torch" and chunk < 1024
            and len(hooks) == -(-moves // chunk) and len(hooks) >= 2,
            f"wide snapshots: chunk {chunk}, {len(hooks)} chunks for "
            f"{moves} moves")
    require(peak <= bkl.STREAM_BYTES + WIDE_SLACK_BYTES,
            f"wide snapshots: {peak} bytes at the peak")
    require(snaps.shape == Es.shape + (WIDE_N,)
            and snaps.dtype == torch.int8, "wide snapshots: shape")
    filled = (snaps != 0).any(-1)
    E_snap = W.to_physical(W.energy(snaps.reshape(-1, WIDE_N))).reshape(
        Es.shape)
    require(bool(filled[:, :-1].all()) and torch.equal(E_snap[filled],
                                                       Es[filled])
            and torch.equal(s1.sigma, s2.sigma)
            and torch.equal(W.energy(s2.sigma), s2.E),
            "wide snapshots: the snapshots' energies against the series")
    print(f"wide snapshots GraphRRG({WIDE_N}, 3), {WIDE_CHAINS} chains: "
          f"chunk {chunk} moves, {len(hooks)} chunks for {moves} moves, "
          f"peak {peak / 2 ** 20:.1f} MiB over the call (stream budget "
          f"{bkl.STREAM_BYTES / 2 ** 20:.0f} MiB; uncut "
          f"{1024 * WIDE_CHAINS * (WIDE_N + 8) / 2 ** 20:.0f} MiB), "
          f"{int(filled.sum())} snapshots equal to the series, {dt:.2f} s  "
          f"[{card}]")
    return {"run": f"bklMC snapshots GraphRRG({WIDE_N}) backend=torch",
            "seconds": dt, "chains": WIDE_CHAINS, "chunk": chunk,
            "chunks": len(hooks), "moves_per_chain_max": moves,
            "peak_bytes": peak}


def _le_models(device=None):
    """The wrapper path's LE model, its flat copy and the TLE model, built
    with no device argument unless one is given."""
    import rrrmc_tpu_torch as rt

    base = rt.GraphRRG(LE_NK, 3, (-1, 1), seed=LE_SEED, device=device)
    le = rt.GraphLocalEntropy(LE_NK, LE_M, LE_GAMMA, LE_BETA, base)
    tle = rt.GraphTopologicalLocalEntropy(LE_NK, LE_M, TLE_GAMMA, TLE_LAMBDA,
                                          LE_BETA, base)
    return le, rt.flatten(le), tle


def _checked(name, model, call, route, card, n_ckpt=None, kernel=False):
    """One sampler call through the public API, and its checks: LAST_ROUTE
    names `route` (impl "cuda" for a kernel route), the series is finite
    (of n_ckpt checkpoints where given), and the running E equals
    energy(sigma): exactly for int32 energies, within 1e-4 * max(1, |E|)
    for float32 ones. Returns (record, Es, state)."""
    import torch
    import rrrmc_tpu_torch as rt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Es, st = call()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(rt.LAST_ROUTE)
    require(got["backend"] == route
            and (not kernel or got.get("impl") == "cuda"),
            f"{name}: route {got}, expected {route}")
    require(bool(torch.isfinite(Es).all())
            and (n_ckpt is None or Es.shape == (st.sigma.shape[0], n_ckpt)),
            f"{name}: series {tuple(Es.shape)}")
    E_re = model.energy(st.sigma)
    if E_re.dtype.is_floating_point:
        err = float((E_re.double() - st.E.double()).abs().max())
        require(err <= 1e-4 * max(1.0, float(E_re.abs().max())),
                f"{name}: |E - energy| = {err}")
    else:
        err = 0.0
        require(torch.equal(E_re, st.E), f"{name}: E != energy(sigma)")
    rec = {"run": name, "route": route, "seconds": dt,
           "chains": st.sigma.shape[0], "energy_err": err,
           "E_per_spin": float(st.E.double().mean()) / model.N}
    print(f"{name}: route {route}, E/N {rec['E_per_spin']:.5f}, "
          f"|E - energy| {err:.3g}, {dt:.2f} s  [{card}]")
    return rec, Es, st


def wrapper_path(card):
    """The local-entropy, topological-LE and committee models on the card,
    through the public API with every launch count of the site, sparse
    race, sparse EO and replica race kernels set to 0 just before the path
    and read just after:

    - LE over GraphRRG(1000, 3), M = 8, 128 chains: kernel bklMC on
      flatten(LE) equilibrates LE_EQ_SWEEPS sweeps; from there rrrMC, bklMC
      and wtmMC on LE itself (the generic path, about LE_MOVES moves a
      chain) against the same calls on flatten(LE) (the sparse race
      kernel): both start from the same spins, so the second-half E/N is
      compared chain by chain, the mean difference within 5 standard
      errors of the chains' differences; and as a control, generic rrrMC
      at LE_FAULT_BETA * beta must fail that check against the kernel
      route at beta; LEenergies + the star's energy == E; then on
      flatten(LE) standardMC (the site kernel), bklMC (the sparse race),
      extremal_opt(tau=1.4) (the sparse EO kernel) and sweepMC (the
      site-sweep route), and sweepMC on LE itself (the composite masks,
      centre slots included, route "torch");
    - TLE, bench_all.py's tle_rrg_sweep row: sweepMC on the composite
      masks (sweeps/s and attempted flips * chains/s printed), then
      TLE_BKL_MOVES generic bklMC moves;
    - the committee rows, 256 chains at beta=1: standardMC, rrrMC and
      bklMC on the generic path, the exact int32 invariant, moves *
      chains/s printed.

    The replica race kernel must not launch (LE and TLE take the generic
    path, as in the JAX package). Returns (records, the path's launch
    counts)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.samplers.moves import acceptance_weights
    from rrrmc_tpu_torch.samplers.sweep import composite_masks

    kernels = {"site_metropolis": "site", "rejfree_sparse": "rejfree_sparse",
               "eo_sparse": "eo_sparse",
               "rejfree_replica": ("rejfree_replica",
                                   "rejfree_replica_sparse")}
    le, fle, tle = _le_models()
    require(le.resid_m.base.J.device.type == "cuda"
            and fle.J.device.type == "cuda", "LE without a device is not on "
                                             "the card")
    torch.cuda.synchronize()
    reset_launches(*kernels.values())
    t_path = time.perf_counter()
    N, B, beta = le.N, LE_CHAINS, LE_BETA
    eq = LE_EQ_SWEEPS * N
    rec, _, st = _checked(
        "bklMC flatten(LE) equilibration", fle,
        lambda: rt.bklMC(fle, beta, eq, step=eq, chains=B, seed=1),
        "kernel-rejfree-sparse", card, 1, kernel=True)
    records = [rec]
    C0 = st.sigma
    # z/N of the equilibrated spins: a bkl move takes N/z iterations
    zn = float(acceptance_weights(fle.delta_all(C0, fle.init_aux(C0)),
                                  beta).mean())
    iters = int(LE_MOVES / zn)
    step_w = iters / LE_CKPT
    runs = {
        "rrrMC": lambda m: rt.rrrMC(m, beta, LE_MOVES,
                                    step=LE_MOVES // LE_CKPT, chains=B,
                                    seed=2, C0=C0),
        "bklMC": lambda m: rt.bklMC(m, beta, iters, step=iters // LE_CKPT,
                                    chains=B, seed=3, C0=C0),
        "wtmMC": lambda m: rt.wtmMC(m, beta, LE_CKPT, step=step_w,
                                    chains=B, seed=4, C0=C0)}

    def halves(Es):
        """Each chain's mean E/N over the second half of its series."""
        return Es[:, Es.shape[1] // 2:].double().mean(1) / N

    def gap(label, h, h_kernel):
        """The mean of the chains' differences of two runs from C0 and 5
        standard errors of it (the spread of C0 cancels chain by chain),
        printed."""
        d = h - h_kernel
        diff, bound = float(d.mean()), 5 * float(d.std()) / d.numel() ** 0.5
        print(f"wrapper {label}: E/N LE (generic) {float(h.mean()):.5f}, "
              f"flatten(LE) (kernel) {float(h_kernel.mean()):.5f}, chain "
              f"by chain difference {diff:.6f} (bound {bound:.6f})  "
              f"[{card}]")
        return diff, bound

    kernel_halves = {}
    for name, call in runs.items():
        out = {}
        for label, model, route in (("LE", le, "torch"),
                                    ("flatten(LE)", fle,
                                     "kernel-rejfree-sparse")):
            rec, Es, st = _checked(f"{name} {label}", model,
                                   lambda: call(model), route, card,
                                   LE_CKPT, kernel=model is fle)
            if model is le:
                rec["moves_per_chain"] = float(st.accepted.double().mean())
            records.append(rec)
            out[label] = (halves(Es), st)
        (h, st_g), (kernel_halves[name], _) = out["LE"], out["flatten(LE)"]
        diff, bound = gap(name, h, kernel_halves[name])
        require(abs(diff) <= bound, f"wrapper {name}: E/N differs from "
                                    f"flatten(LE)'s by {diff} > {bound}")
        parts = le.LEenergies(st_g.sigma).sum(1) + le.inner_m.to_physical(
            le.inner_m.energy(st_g.sigma))
        err = float((parts.double() - st_g.E.double()).abs().max())
        require(err <= 1e-4 * max(1.0, float(st_g.E.abs().max())),
                f"wrapper {name}: LEenergies + star != E ({err})")

    rec, Es, _ = _checked(
        f"rrrMC LE at {LE_FAULT_BETA} beta (control)", le,
        lambda: rt.rrrMC(le, LE_FAULT_BETA * beta, LE_MOVES,
                         step=LE_MOVES // LE_CKPT, chains=B, seed=12, C0=C0),
        "torch", card, LE_CKPT)
    records.append(rec)
    diff, bound = gap(f"rrrMC at {LE_FAULT_BETA} beta (control)",
                      halves(Es), kernel_halves["rrrMC"])
    require(abs(diff) > bound, f"wrapper check: rrrMC at {LE_FAULT_BETA} "
                               f"beta passes it ({diff} <= {bound})")

    it_met, it_bkl = LE_ITERS_MET, LE_ITERS_BKL
    kernel_runs = [
        ("standardMC flatten(LE)", fle, "kernel-site",
         lambda: rt.standardMC(fle, beta, it_met, step=it_met // 10,
                               chains=B, seed=5, backend="kernel"), 10),
        ("bklMC flatten(LE)", fle, "kernel-rejfree-sparse",
         lambda: rt.bklMC(fle, beta, it_bkl, step=it_bkl // 10, chains=B,
                          seed=6), 10),
        ("sweepMC flatten(LE)", fle, "kernel-site-sweep",
         lambda: rt.sweepMC(fle, beta, LE_SWEEPS, step=LE_SWEEPS // 2,
                            chains=B, seed=7), 2)]
    for name, model, route, call, n_ckpt in kernel_runs:
        rec, _, _ = _checked(name, model, call, route, card, n_ckpt,
                             kernel=True)
        records.append(rec)
    rec, _ = _eo_run("flatten(LE)", fle, "kernel-eo-sparse", B, LE_EO_MOVES,
                     8, lambda: launched("eo_sparse"), card)
    records.append(rec)
    masks = composite_masks(le)
    require(masks is not None and masks.shape[0] % (LE_M + 1) == 0,
            "LE: no composite masks over every slot")
    rec, _, _ = _checked(
        "sweepMC LE (composite masks)", le,
        lambda: rt.sweepMC(le, beta, LE_SWEEPS, step=LE_SWEEPS // 2,
                           chains=B, seed=9), "torch", card, 2)
    require(rt.LAST_ROUTE.get("n_masks") == masks.shape[0],
            f"sweepMC LE: {rt.LAST_ROUTE}")
    records.append(rec)

    rec, _, _ = _checked(
        "sweepMC TLE (composite masks)", tle,
        lambda: rt.sweepMC(tle, beta, TLE_SWEEPS, step=TLE_SWEEPS // 2,
                           chains=B, seed=10), "torch", card, 2)
    rec.update(sweeps_per_s=TLE_SWEEPS / rec["seconds"],
               flips_chains_per_s=TLE_SWEEPS * tle.N * B / rec["seconds"])
    print(f"tle_rrg_sweep: {rec['sweeps_per_s']:.4g} sweeps/s, "
          f"{rec['flips_chains_per_s']:.4g} flips*chains/s ({B} chains, "
          f"N = {tle.N}, {masks.shape[0]} masks a sweep)  [{card}]")
    records.append(rec)
    stop = lambda *a: False   # noqa: E731 (one chunk of moves, then stop)
    rec, _, _ = _checked(
        "bklMC TLE", tle,
        lambda: rt.bklMC(tle, beta, 10 ** 9, step=10 ** 9, chains=B, seed=11,
                         chunk_moves=TLE_BKL_MOVES, hook=stop),
        "torch", card)
    records.append(rec)

    for fn, K1, K2 in COMM_ROWS:
        m = getattr(rt, fn)(K1, K2, COMM_P, seed=COMM_SEED)
        require(m.xi.device.type == "cuda", f"{fn} is not on the card")
        label = f"{fn}({K1}, {K2}, {COMM_P})"
        kw = dict(chains=COMM_CHAINS, seed=COMM_SEED)
        for name, call, moves in (
                ("standardMC", lambda: rt.standardMC(
                    m, COMM_BETA, COMM_ITERS_MET,
                    step=COMM_ITERS_MET // 4, **kw), COMM_ITERS_MET),
                ("rrrMC", lambda: rt.rrrMC(
                    m, COMM_BETA, COMM_ITERS_RRR,
                    step=COMM_ITERS_RRR // 4, **kw), COMM_ITERS_RRR),
                ("bklMC", lambda: rt.bklMC(
                    m, COMM_BETA, 10 ** 9, step=10 ** 9,
                    chunk_moves=COMM_BKL_MOVES, hook=stop, **kw),
                 COMM_BKL_MOVES)):
            rec, _, st = _checked(f"{name} {label}", m, call, "torch", card)
            require(st.E.dtype == torch.int32, f"{label}: E not int32")
            rec.update(rate=moves * COMM_CHAINS / rec["seconds"],
                       rate_unit="moves*chains/s")
            print(f"{name} {label}: {rec['rate']:.4g} moves*chains/s "
                  f"({moves} moves)  [{card}]")
            records.append(rec)

    torch.cuda.synchronize()
    counts = {name: launched(k) for name, k in kernels.items()}
    for name in ("site_metropolis", "rejfree_sparse", "eo_sparse"):
        require(counts[name] > 0, f"wrapper path: {name} not launched")
    require(counts["rejfree_replica"] == 0,
            "wrapper path: LE or TLE took the replica race kernel")
    print(f"wrapper path: {time.perf_counter() - t_path:.1f} s, launches "
          f"{json.dumps(counts)}  [{card}]")
    return records, counts


def pt_betas(device=None):
    """The PT path's ladder: beta_k = PT_BETA0 + PT_DBETA k, k < PT_T."""
    import torch

    return PT_BETA0 + PT_DBETA * torch.arange(PT_T, dtype=torch.float64,
                                              device=device)


def pt_site_case(model, card, row):
    """The site kernel at the PT path's shape: PT_T rungs of PT_CHAINS
    chains (chain t * PT_CHAINS + b at beta_t, 32 distinct betas read
    chain by chain), N moves on the sweep schedule (one permutation, as a
    round of the path walks it), against its plain version; its time is
    printed beside row 1's scalar case `row`."""
    import torch
    from rrrmc_tpu_torch.ops.site import _perm_of

    betas = pt_betas().repeat_interleave(PT_CHAINS)
    sites = torch.as_tensor(_perm_of(SEED, 0, model.N).astype("int32"),
                            device=DEV)
    c = site_case(model, f"RRG+-J, {PT_T} betas per chain (PT)", card,
                  B=PT_T * PT_CHAINS, sites=sites, betas=betas)
    require(c["diverged"] == 0 and c["max_abs_err"] == 0.0,
            f"site kernel with a beta per chain: {c['diverged']} chains "
            f"diverge, max abs err {c['max_abs_err']}")
    print(f"site_metropolis {PT_T} betas per chain: {c['ms']:.3f} ms beside "
          f"row 1's one beta {row['ms']:.3f} ms ({row['moves']} moves, "
          f"{row['B']} chains) [{card}]")
    return c


def _pair_acceptance(ranks, T: int):
    """[T - 1] accepted share of each adjacent pair's attempts: pair
    (k, k + 1) swapped at round r (parity r % 2) where the slot that held
    rank k + 1 holds rank k."""
    import torch

    n, _, B = ranks.shape
    start = torch.arange(T, dtype=ranks.dtype, device=ranks.device)
    prev = torch.cat([start[None, :, None].expand(1, T, B), ranks[:-1]])
    slot_now = ranks.argsort(dim=1)            # [n, T(rank), B]: slot
    slot_prev = prev.argsort(dim=1)
    out = []
    for k in range(T - 1):
        rounds = torch.arange(k % 2, n, 2, device=ranks.device)
        hit = slot_now[rounds, k] == slot_prev[rounds, k + 1]
        out.append(float(hit.double().mean()) if rounds.numel() else 0.0)
    return out


def _column_means(series):
    """[C] per-column time averages of a [rounds, C] series, and their mean
    and standard error."""
    m = series.double().mean(0)
    return float(m.mean()), float(m.std()) / m.numel() ** 0.5


def pt_path(card):
    """parallel_tempering at full width: GraphRRG(10^4, 3, +-J, seed 167),
    PT_T rungs beta_k = 1 + 0.02 k, PT_CHAINS chains a rung (1024 chains),
    PT_SWEEPS sweeps a round, PT_ROUNDS rounds, one site-kernel launch a
    round (counts reset just before it). Holds the exact int32 energy on
    every chain, ranks a permutation of every column after every round,
    E/N by rung non-increasing within 3 standard errors (of the columns'
    time averages over the second half), every adjacent pair's swap
    acceptance above 0; and the law at beta = 1 on the ladder continued
    to PT_LAW_ROUNDS rounds (`pt_law`). Prints the wall time, the
    attempted flips * chains / s, launches and host syncs a round, the
    pairs' acceptance and the device busy share of PT_TRACE_ROUNDS rounds
    under profiling.trace. Returns (records, counts, the model)."""
    import torch
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.utils import profiling

    X = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED)
    betas = pt_betas().tolist()
    T, B, N = PT_T, PT_CHAINS, X.N
    torch.cuda.synchronize()
    reset_launches("site")
    t0 = time.perf_counter()
    Es, ranks, st = rt.parallel_tempering(X, betas, PT_ROUNDS,
                                          sweeps_per_round=PT_SWEEPS,
                                          chains=B, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched("site")
    route = dict(rt.LAST_ROUTE)
    require(route["backend"] == "kernel-site-tempering"
            and route["impl"] == "cuda", f"pt: route {route}")
    require(launches == PT_ROUNDS, f"pt: {launches} launches for "
                                   f"{PT_ROUNDS} rounds")
    require(Es.shape == ranks.shape == (PT_ROUNDS, T, B)
            and bool(torch.isfinite(Es).all()), f"pt: series {Es.shape}")
    require(st.E.dtype == torch.int32 and torch.equal(
        X.energy(st.sigma.reshape(T * B, N)).view(T, B), st.E),
        "pt: E != energy(sigma)")
    want = torch.arange(T, dtype=ranks.dtype, device=ranks.device)
    require(bool((ranks.sort(dim=1).values == want[None, :, None]).all()),
            "pt: ranks are not permutations")
    ebr = rt.energies_by_rank(Es, ranks)[PT_ROUNDS // 2:] / N
    rung = [_column_means(ebr[:, k]) for k in range(T)]
    for k in range(T - 1):
        (a, sa), (b, sb) = rung[k], rung[k + 1]
        require(b <= a + 3 * math.hypot(sa, sb),
                f"pt: E/N rises from rung {k} ({a}) to {k + 1} ({b})")
    acc = _pair_acceptance(ranks, T)
    require(min(acc) > 0, f"pt: a pair never swapped: {acc}")
    flips = PT_ROUNDS * PT_SWEEPS * N * T * B / wall
    print(f"pt GraphRRG({N}, 3) T={T} x {B} chains, {PT_SWEEPS} sweeps x "
          f"{PT_ROUNDS} rounds: {wall:.2f} s, {flips:.4g} attempted "
          f"flips*chains/s, {launches / PT_ROUNDS:g} site launches a round "
          f"[{card}]")
    print(f"pt E/N by rung (second half): "
          f"{[round(m, 5) for m, _ in rung]}  [{card}]")
    print(f"pt swap acceptance by pair: {[round(a, 4) for a in acc]}  "
          f"[{card}]")

    law, st = pt_law(X, betas, Es, ranks, st, card)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            t1 = time.perf_counter()
            rt.parallel_tempering(X, betas, PT_TRACE_ROUNDS,
                                  sweeps_per_round=PT_SWEEPS, chains=B,
                                  state=st)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t1
        trace_bytes = os.path.getsize(os.path.join(logdir, "trace.json"))
    dev = profiling.device_summary(prof)
    busy = dev["device_us"] / (1e6 * traced)
    print(f"pt trace of {PT_TRACE_ROUNDS} rounds: {traced * 1e3:.1f} ms, "
          f"device busy {busy:.3f}, {dev['kernels'] / PT_TRACE_ROUNDS:g} "
          f"kernels, {dev['launch_calls'] / PT_TRACE_ROUNDS:g} launch calls "
          f"and {dev['host_syncs'] / PT_TRACE_ROUNDS:g} host syncs a round "
          f"(trace.json of {trace_bytes} bytes written)  [{card}]")

    rec = {"run": "parallel_tempering", "seconds": wall, "chains": T * B,
           "rate": flips, "rate_unit": "attempted flips*chains/s",
           "launches": launches, "launches_per_round": launches / PT_ROUNDS,
           "host_syncs_per_round": dev["host_syncs"] / PT_TRACE_ROUNDS,
           "launch_calls_per_round": dev["launch_calls"] / PT_TRACE_ROUNDS,
           "device_busy": busy, "pair_acceptance": acc,
           "E_per_spin_by_rung": [m for m, _ in rung],
           "law": law}
    return [rec], {"site_metropolis": launches}, X


def pt_law(X, betas, Es, ranks, st, card):
    """The law at beta = 1, below beta_c: the ladder of `pt_path` (its
    series Es, ranks and state st after PT_ROUNDS rounds) continued to
    PT_LAW_ROUNDS rounds (a continued run equals one longer call), and
    sweepMC at beta_0 over PT_LAW_ROUNDS * PT_SWEEPS sweeps on PT_T *
    PT_CHAINS chains, E read every PT_SWEEPS sweeps. Rung 0's E/N over the
    second half (the columns' time averages) must equal sweepMC's within 5
    hypot of their standard errors; sweepMC at PT_CONTROL_BETA (PT_ROUNDS *
    PT_SWEEPS sweeps) must fail that check. The same comparison after
    PT_ROUNDS rounds, where both runs still age, is printed beside it.
    Returns (the record, the ladder's final state)."""
    import torch
    import rrrmc_tpu_torch as rt

    N, C = X.N, PT_T * PT_CHAINS
    Es2, ranks2, st = rt.parallel_tempering(
        X, betas, PT_LAW_ROUNDS - PT_ROUNDS, sweeps_per_round=PT_SWEEPS,
        chains=PT_CHAINS, state=st)
    rung0 = rt.energies_by_rank(torch.cat([Es, Es2]),
                                torch.cat([ranks, ranks2]))[:, 0] / N

    def second_half(series, L):
        return _column_means(series[L // 2:L])

    def ref(beta, rounds, seed):
        return rt.sweepMC(X, beta, rounds * PT_SWEEPS, step=PT_SWEEPS,
                          chains=C, seed=seed)[0].t() / N
    E_ref = ref(betas[0], PT_LAW_ROUNDS, SEED + 1)
    rec = {}
    for L in (PT_ROUNDS, PT_LAW_ROUNDS):
        (a, sa), (b, sb) = second_half(rung0, L), second_half(E_ref, L)
        rec[str(L)] = {"pt": (a, sa), "sweepMC": (b, sb),
                       "difference": abs(a - b),
                       "five_se": 5 * math.hypot(sa, sb)}
        note = "" if L == PT_LAW_ROUNDS else ", not held: both still age"
        print(f"pt law after {L} rounds: rung 0 E/N {a:.6f} +- {sa:.6f}, "
              f"sweepMC at beta {betas[0]:g} {b:.6f} +- {sb:.6f}, "
              f"|difference| {abs(a - b):.6f} (bound "
              f"{5 * math.hypot(sa, sb):.6f}{note})  [{card}]")
    law = rec[str(PT_LAW_ROUNDS)]
    require(law["difference"] <= law["five_se"],
            f"pt law: rung 0 against sweepMC: {law}")
    (a, sa) = law["pt"]
    c, sc = second_half(ref(PT_CONTROL_BETA, PT_ROUNDS, SEED + 3),
                        PT_ROUNDS)
    ctl = {"sweepMC": (c, sc), "difference": abs(a - c),
           "five_se": 5 * math.hypot(sa, sc)}
    print(f"pt law control: sweepMC at beta {PT_CONTROL_BETA:g} {c:.6f} +- "
          f"{sc:.6f}, |difference| {abs(a - c):.6f} (bound "
          f"{ctl['five_se']:.6f})  [{card}]")
    require(ctl["difference"] > ctl["five_se"],
            f"pt law control: sweepMC at {PT_CONTROL_BETA} passes: {ctl}")
    rec["control"] = ctl
    return rec, st


def et_gammas():
    """The ET path's Gamma ladder."""
    return [ET_GAMMA0 + ET_DGAMMA * k for k in range(ET_T)]


def et_path(card):
    """tempered_ensembles with sweep_kernel on ET_T flattened slots
    flatten(GraphQuant(ET_NK, ET_M, Gamma_k, beta=ET_BETA, base)), base
    GraphRRG(1000, 3, +-J, seed 13), ET_CHAINS chains, ET_ROUNDS rounds
    (one sweep of N moves a slot a round: one site-kernel launch). Holds E
    within 1e-4 max(1, |E|) of each slot's energy(sigma), walkers
    permutations and every adjacent pair swapping. Returns (records,
    counts)."""
    import torch
    import rrrmc_tpu_torch as rt

    base = rt.GraphRRG(ET_NK, 3, (-1, 1), seed=ET_SEED)
    models = [rt.flatten(rt.GraphQuant(ET_NK, ET_M, g, ET_BETA, base))
              for g in et_gammas()]
    torch.cuda.synchronize()
    reset_launches("site")
    t0 = time.perf_counter()
    Es, walkers, st = rt.tempered_ensembles(
        models, [ET_BETA] * ET_T, ET_ROUNDS, chains=ET_CHAINS, seed=SEED,
        kernel=rt.sweep_kernel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched("site")
    require(rt.LAST_ROUTE["backend"] == "kernel-site-sweep"
            and rt.LAST_ROUTE["impl"] == "cuda",
            f"et: slot route {rt.LAST_ROUTE}")
    require(launches == ET_T * ET_ROUNDS, f"et: {launches} launches")
    errs = []
    for m, slot in zip(models, st.slots):
        e = float((m.energy(slot.sigma).double() - slot.E.double()).abs()
                  .max())
        errs.append(e)
        require(e <= 1e-4 * max(1.0, float(slot.E.abs().max())),
                f"et: |E - energy| {e}")
    want = torch.arange(ET_T, dtype=walkers.dtype, device=walkers.device)
    require(bool((walkers.sort(dim=1).values == want[None, :, None]).all()),
            "et: walkers are not permutations")
    acc = _pair_acceptance(_walker_ranks(walkers), ET_T)
    require(min(acc) > 0, f"et: a pair never swapped: {acc}")
    print(f"et {ET_T} x flatten(GraphQuant({ET_NK}, {ET_M}, Gamma, "
          f"{ET_BETA:g})), Gamma {[round(g, 4) for g in et_gammas()]}, "
          f"{ET_CHAINS} chains, {ET_ROUNDS} rounds: {wall:.2f} s, "
          f"{launches} launches, |E - energy| {max(errs):.3g}, pair "
          f"acceptance {[round(a, 4) for a in acc]}  [{card}]")
    return [{"run": "tempered_ensembles sweep_kernel", "seconds": wall,
             "chains": ET_CHAINS * ET_T, "launches": launches,
             "pair_acceptance": acc, "energy_err": max(errs),
             "E_phys_by_slot": Es[ET_ROUNDS // 2:].double().mean(
                 dim=(0, 2)).tolist()}], {"site_metropolis": launches}


def _walker_ranks(walkers):
    """Walkers [n, T, B] (walker id held by each slot) as the rank table
    `_pair_acceptance` reads: slot s "holds rank" walker[s], so a swap of
    slots (k, k + 1) shows as the exchange of their walker ids' slots."""
    return walkers.argsort(dim=1).to(walkers.dtype)


def shard_path(card, X):
    """Sharding, disorder, distribution and checkpoints on the card:
    sample_sharded(standardMC) over a mesh of the card repeated 4 times
    against the unsharded call; sample_disorder(bklMC) over 4 RRG
    instances against the sequential calls; a one-rank NCCL group's
    sample_distributed(sweepMC) and parallel tempering against the
    unsharded runs; a PT state saved mid-run, loaded and continued against
    the run continued in memory and against one uninterrupted call. Each
    must be EQUAL. Returns the launches of the kernels it ran."""
    import socket

    import torch
    import torch.distributed as tdist
    import rrrmc_tpu_torch as rt
    from rrrmc_tpu_torch.parallel import distributed as dist
    from rrrmc_tpu_torch.parallel.mesh import (make_mesh, sample_disorder,
                                               sample_sharded)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    torch.cuda.synchronize()
    reset_launches("site", "rejfree_sparse")
    t0 = time.perf_counter()
    mesh = make_mesh({"chains": 4}, devices=[DEV] * 4)
    kw = dict(step=SHARD_ITERS // 10, chains=CHAINS, seed=SEED,
              backend="kernel")
    a_Es, a_st = sample_sharded(rt.standardMC, X, mesh, BETA, SHARD_ITERS,
                                **kw)
    b_Es, b_st = rt.standardMC(X, BETA, SHARD_ITERS, **kw)
    require(rt.LAST_ROUTE["backend"] == "kernel-site"
            and same((a_Es, a_st.sigma, a_st.E, a_st.accepted),
                     (b_Es, b_st.sigma, b_st.E, b_st.accepted)),
            "sample_sharded(standardMC) differs from the unsharded run")
    print(f"sample_sharded(standardMC) over 4 shards of the card: equal to "
          f"the unsharded run ({CHAINS} chains, {SHARD_ITERS} moves)  "
          f"[{card}]")

    models = [rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=s) for s in range(4)]
    dkw = dict(step=DISORDER_ITERS // 10, chains=HYPER_CHAINS)
    Es_d, st_d = sample_disorder(rt.bklMC, models, BETA, DISORDER_ITERS,
                                 seed=SEED, **dkw)
    for d, m in enumerate(models):
        st = rt.init_state(m, HYPER_CHAINS, SEED + 104729 * d)
        Es, st2 = rt.bklMC(m, BETA, DISORDER_ITERS, state=st, **dkw)
        require(rt.LAST_ROUTE["backend"] == "kernel-rejfree-sparse"
                and same((Es_d[d], st_d.sigma[d]), (Es, st2.sigma)),
                f"sample_disorder(bklMC) instance {d} differs")
    print(f"sample_disorder(bklMC) over 4 GraphRRG({N_MAIN}, 3) instances: "
          f"equal to the sequential calls  [{card}]")

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        require(tdist.get_backend() == "nccl", "one-rank group not on NCCL")
        gmesh = dist.global_mesh()
        skw = dict(step=5, chains=CHAINS, seed=SEED)
        Es, st = dist.sample_distributed(rt.sweepMC, X, BETA, 20, mesh=gmesh,
                                         **skw)
        Es0, st0 = rt.sweepMC(X, BETA, 20, **skw)
        require(same((dist.fetch_global(Es, gmesh), st.sigma),
                     (Es0, st0.sigma)), "NCCL sample_distributed differs")
        betas = pt_betas().tolist()
        pkw = dict(sweeps_per_round=2, chains=PT_CHAINS, seed=SEED)
        a = rt.parallel_tempering(X, betas, 10,
                                  mesh=dist.global_mesh({"temp": 1}), **pkw)
        b = rt.parallel_tempering(X, betas, 10, **pkw)
        require(same(a[:2] + (a[2].sigma,), b[:2] + (b[2].sigma,)),
                "NCCL parallel_tempering differs")
    finally:
        tdist.destroy_process_group()
    print(f"one-rank NCCL group: sample_distributed(sweepMC) and "
          f"parallel_tempering equal their unsharded runs  [{card}]")

    betas = pt_betas().tolist()
    pkw = dict(sweeps_per_round=2, chains=PT_CHAINS)
    _, _, mid = rt.parallel_tempering(X, betas, 10, seed=SEED, **pkw)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/pt.npz"
        rt.save_state(path, mid)
        like = rt.parallel_tempering(X, betas, 0, seed=0, **pkw)[2]
        loaded = rt.load_state(path, like)
    c_mem = rt.parallel_tempering(X, betas, 10, state=mid, **pkw)
    c_load = rt.parallel_tempering(X, betas, 10, state=loaded, **pkw)
    whole = rt.parallel_tempering(X, betas, 20, seed=SEED, **pkw)
    require(same(c_mem[:2] + (c_mem[2].sigma,),
                 c_load[:2] + (c_load[2].sigma,))
            and same((whole[0][10:], whole[1][10:], whole[2].sigma),
                     c_load[:2] + (c_load[2].sigma,)),
            "a PT checkpoint's continuation differs")
    print(f"PT checkpoint saved after 10 rounds, loaded and continued for "
          f"10: equal to the run continued in memory and to one 20-round "
          f"call ({time.perf_counter() - t0:.1f} s for the shard path)  "
          f"[{card}]")
    torch.cuda.synchronize()
    return {"site_metropolis": launched("site"),
            "rejfree_sparse": launched("rejfree_sparse")}


#: the kernel modules whose launch counts scripts_path reads, each with
#: its kernels' names in ops/launch.py's LAUNCHES: every one of them runs
#: on some scoreboard row or QIsing engine
SCRIPT_KERNELS = {"site": "site", "rejfree": "rejfree_sparse",
                  "rejfree_classes": "rejfree_classes", "sweep": "sweep",
                  "sk": "sk_sweep", "rejfree_dense": "rejfree_dense",
                  "eo": "eo_sparse", "eo_dense": "eo_dense",
                  "pspin": "rejfree_pspin", "eo_pspin": "eo_pspin",
                  "sat": "rejfree_sat", "eo_sat": "eo_sat",
                  "replica": ("rejfree_replica", "rejfree_replica_sparse"),
                  "replica_sweep": "replica_sweep", "perc": "rejfree_perc",
                  "eo_perc": "eo_perc"}
#: the scoreboard sections scripts_path runs (the factor sections stay out:
#: factors_path runs equilibrated_factors)
SCRIPT_SECTIONS = ("kernels", "sat", "composite_sparse", "sparse_chains",
                   "disorder", "perc_comm")
#: QIsing's engines in scripts_path: seconds each, segment target, and the
#: generic engines' probe moves
QISING_T, QISING_SEG_S, QISING_PROBE = 2.0, 0.5, 100
#: the tempering scaling's ladder sizes and rounds in scripts_path
TEMPER_T, TEMPER_ROUNDS = (2, 32), 3


def _script(name: str):
    """scripts/<name>.py of this checkout as a module (not run)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row_routes(section, row) -> dict:
    """Each route a scoreboard row names, and the route it must be: the
    kernel route where a kernel takes the row, the generic path ("torch")
    where none does (TLE's composite masks, the committees, Metropolis on
    the perceptrons), as in the JAX file."""
    if section != "perc_comm":
        want = "torch" if row["kernel"] == "tle_rrg_sweep" else "kernel-"
        return {"route": (row["route"], want)}
    if row["family"] == "perc_step_eo":
        return {"backend": (row["backend"], "kernel-eo-perc")}
    perc = row["family"].startswith("perc_")
    return {f"{s}_backend": (row[f"{s}_backend"],
                             "kernel-rejfree-perc" if perc and s != "standard"
                             else "torch")
            for s in ("standard", "rrr", "bkl")}


def scripts_path(card):
    """The ported scripts at their published shapes and chain counts with
    short run lengths: every row of the scoreboard's kernels, sat,
    composite_sparse, sparse_chains (1024 chains), disorder and perc_comm
    sections (scripts/torch_bench_all.py's SHORT: a probe target of a
    fraction of a second, one rep), each holding its energy guard, with the
    JAX artifact's keys for its section (with ADDED_KEYS) and its kernel's
    route; QIsing's four engines for QISING_T seconds each
    (scripts/torch_paper_quant.py): every trajectory point finite, each
    engine's last point nearer the kernel Metropolis engine's last level
    than random spins' Qenergy is (the estimator undershoots from random
    spins: the other engines are still rising toward it), the kernel
    Metropolis engine falling from its first point, wall_to_target
    computed; the tempering scaling at T = 2 and 32 for 3
    rounds (scripts/torch_tempering_scaling.py). Returns the launches of
    the kernel modules, counted from 0 just before."""
    from pathlib import Path

    import torch
    import rrrmc_tpu_torch as rt

    bench = _script("torch_bench_all")
    quant = _script("torch_paper_quant")
    temper = _script("torch_tempering_scaling")
    jax_rows = json.loads((Path(__file__).resolve().parent
                           / "bench_all_results.json").read_text())
    torch.cuda.synchronize()
    reset_launches(*SCRIPT_KERNELS.values())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/scoreboard.json"
        for section in SCRIPT_SECTIONS:
            ts = time.perf_counter()
            res = bench.run(section, out, torch.device(DEV), bench.SHORT,
                            log=lambda s: None)
            key = bench.SECTIONS[section][0]
            require(res["device"] == card, f"scoreboard device "
                                           f"{res['device']!r}")
            for row in res[key]:
                rid = row.get("kernel", row.get("family"))
                ref = [r for r in jax_rows[key]
                       if r.get("kernel", r.get("family")) == rid]
                require(bool(ref), f"{section} {rid}: no JAX row")
                want = set(ref[0]) | bench.ADDED_KEYS.get(key, set())
                require(set(row) == want, f"{section} {rid}: keys differ "
                                          f"from the JAX row's by "
                                          f"{sorted(set(row) ^ want)}")
                for what, (got, need) in _row_routes(section, row).items():
                    require(got.startswith(need) if need == "kernel-"
                            else got == need,
                            f"{section} {rid}: {what} {got}, not {need}")
            if section == "kernels":
                require([r["kernel"] for r in res[key]]
                        == list(bench.KERNEL_ROWS), "kernels rows missing")
            print(f"scoreboard {section}: {len(res[key])} rows, keys and "
                  f"routes held, {time.perf_counter() - ts:.1f} s  [{card}]")
    q = quant.qising(QISING_T, CHAINS, 654789, device=torch.device(DEV),
                     seg_target_s=QISING_SEG_S, probe_torch=QISING_PROBE,
                     log=lambda s: None)
    X = rt.GraphQSKT(Q_NK, Q_M, Q_GAMMA, Q_BETA, seed=Q_SEED, device=DEV)
    start = float(X.Qenergy(rt.init_state(X, CHAINS, 654789,
                                          device=DEV).sigma)
                  .double().mean())
    level = q["target_deep_Qenergy"]
    for eng in ("met_kernel", "rrr_kernel", "met_torch", "rrr_torch"):
        traj = q[eng]["traj"]
        vals = [p["obs_mean"] for p in traj]
        # random spins' Qenergy lies far below the equilibrium level (the
        # estimator's undershoot): the kernel Metropolis engine, past that
        # transient after its first point, falls; every engine has moved
        # from the random start toward that engine's level
        require(all(math.isfinite(v) for v in vals)
                and abs(vals[-1] - level) < abs(start - level)
                and (eng != "met_kernel"
                     or (len(vals) > 1 and vals[-1] < vals[0])),
                f"QIsing {eng}: Qenergy {vals} from {start}, level {level}")
        print(f"QIsing {eng}: {q[eng]['rate_iters_per_s']:.4g} iterations "
              f"a second, Qenergy {start:.4f} (random spins) -> "
              f"{vals[0]:.4f} -> {vals[-1]:.4f} over {len(traj)} points, "
              f"wall_to_target {q['wall_to_target_s'][eng]}  [{card}]")
    require(set(q["wall_to_target_s"]) == {"met_kernel", "rrr_kernel",
                                           "met_torch", "rrr_torch"}
            and q["wall_to_target_s"]["rrr_torch"] is not None,
            f"QIsing wall_to_target {q['wall_to_target_s']}")
    ladder_rows = temper.run(TEMPER_ROUNDS, device=torch.device(DEV),
                          ladders=TEMPER_T, log=lambda s: None)["rows"]
    for r in ladder_rows:
        require(r["swap_acc_mean"] > 0 and r["round_s"] > 0,
                f"tempering scaling T={r['T']}: {r}")
        print(f"tempering scaling T={r['T']}: {r['round_s'] * 1e3:.2f} ms a "
              f"round, {r['round_per_slot_s'] * 1e3:.3f} ms a slot, first "
              f"call {r['first_call_s']:.3f} s, swap_acc_mean "
              f"{r['swap_acc_mean']:.3f}  [{card}]")
    torch.cuda.synchronize()
    counts = {m: launched(k) for m, k in SCRIPT_KERNELS.items()}
    for m, n in counts.items():
        require(n > 0, f"scripts path: no {m} kernel launch")
    print(f"scripts path: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(counts)}  [{card}]")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import rrrmc_tpu_torch as rt   # fails in a directory without the repo
    from rrrmc_tpu_torch.bench import card_line
    from rrrmc_tpu_torch.ops import cuda_build, rejfree

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    # the ptxas report first: the build time stays in the output's tail
    build_log = cuda_build.build_info["log"]
    print(build_log.strip())
    print(f"kernel build: {build_s:.1f} s ({cuda_build.build_info['path']})")

    m = rt.GraphRRG(N_MAIN, 3, (-1, 1), seed=SEED, device=DEV)
    mn = rt.GraphRRGNormal(N_MAIN, 3, seed=SEED, device=DEV)
    cases = [site_case(m, "RRG+-J", card),
             site_case(mn, "RRGNormal", card, n_moves=SITE_MOVES // 4)]
    cases.append(pt_site_case(m, card, cases[0]))
    cases += site_cases(card)

    def moves(mode):
        return RACE_MOVES if mode == "bkl" else CMP_MOVES

    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(m, "RRG+-J", mode, card,
                                  n_moves=moves(mode)))
        cases.append(rejfree_case(mn, "RRGNormal", mode, card,
                                  n_moves=CMP_MOVES))
    class_cases = classes_cases(card)
    lat = rt.GraphEA(16, 3, (-1, 1), seed=42, device=DEV)
    field = dataclasses.replace(lat, h=torch.as_tensor(
        np.random.default_rng(SEED).integers(-2, 3, lat.N),
        dtype=lat.h.dtype, device=DEV))
    fixed = rt.GraphEA(16, 3, (-1.5, 0.5), seed=42, device=DEV)
    cases.append(sweep_case(lat, "EA3D-L16+-J", 8192, card))
    cases.append(sweep_case(field, "EA3D-L16+-J fields", CHAINS, card))
    cases.append(sweep_case(fixed, "EA3D-L16 (-1.5,0.5) exp", CHAINS, card))
    # the kernel's other shapes and lane layouts: a ragged batch, an EA-2D
    # lattice, one chain a lane on +-J couplings, four chains a lane on the
    # exp path (every site's |J| sum 120 <= 127, max |half| 120 > 64)
    cases.append(sweep_case(lat, "EA3D-L16+-J ragged", SITE_RAGGED_B, card))
    cases.append(sweep_case(rt.GraphEA(64, 2, (-1, 1), seed=42, device=DEV),
                            "EA2D-L64+-J", CHAINS, card))
    # D = 4 and 1: the kernel's run-time-D instantiation
    cases.append(sweep_case(rt.GraphEA(8, 4, (-1, 1), seed=42, device=DEV),
                            "EA4D-L8+-J", CHAINS, card))
    cases.append(sweep_case(rt.GraphEA(4096, 1, (-1, 1), seed=42,
                                       device=DEV),
                            "EA1D-L4096+-J", CHAINS, card))
    cases.append(sweep_case(lat, "EA3D-L16+-J one chain a lane", CHAINS, card,
                            one_lane=True))
    cases.append(sweep_case(rt.GraphEA(16, 3, (-20, 20), seed=42, device=DEV),
                            "EA3D-L16 (-20,20) exp", CHAINS, card))
    lanes = {c["sweep_plan"]["lanes"] for c in cases
             if c["kernel"] == "sweep_checkerboard"}
    require(lanes == {"1 chain", "4 chains"}, f"sweep lanes held: {lanes}")
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(lat, "EA3D-L16+-J", mode, card,
                                  kernel="rejfree_lattice",
                                  n_moves=moves(mode)))

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
    # each row's equilibrium case: its chains after one main-path
    # checkpoint of warm sweeps (sweepMC's step), at the main path's
    # acceptance; and a ragged B
    cases.append(sk_case(sk1, "GraphSK(1024) equilibrium", 8192,
                         SK_CMP_SWEEPS, card, "sk_sweep",
                         warm=SK_SWEEPS // 10))
    cases.append(sk_case(sk8, "GraphSK(8192) equilibrium", 2048,
                         SK8_CMP_SWEEPS, card, "sk_sweep_hbm",
                         warm=SK8_SWEEPS // 10))
    cases.append(sk_case(sk1, "GraphSK(1024) ragged", SK_RAGGED_B, 1, card,
                         "sk_sweep"))
    cases.append(sk_case(sk1, "GraphSK(1024) small", SMALL_B, 1, card,
                         "sk_sweep"))
    # near-frozen chains (beta = 40 after 50 sweeps): spans with at most
    # kRowFlips flips in a block take the row-by-row commit, with 4-field
    # loads (N = 1024) and single ones (N = 1101)
    for model, n in ((sk1, 1024), (rt.GraphSK(1101, seed=4, device=DEV),
                                   1101)):
        cases.append(sk_case(model, f"GraphSK({n}) frozen", CHAINS, 1, card,
                             "sk_sweep", warm=50, beta=FROZEN_BETA))
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(sk1, "GraphSK(1024)", mode, card,
                                  kernel="rejfree_dense", beta=4.0,
                                  n_moves=moves(mode)))
    cases.append(rejfree_case(drrg, "densify(GraphRRG(10^4))", "bkl", card,
                              kernel="rejfree_stream", beta=4.0))
    cases.append(rejfree_case(skn, "GraphSKNormal(4096)", "bkl", card,
                              kernel="rejfree_stream", B=128, beta=4.0,
                              n_moves=CMP_MOVES, exact=True))

    rrgn7 = rt.GraphRRGNormal(N_MAIN, 3, seed=7, device=DEV)
    ea8 = rt.GraphEA(8, 3, (-1, 1), seed=42, device=DEV)
    cases.append(eo_case(rrg7, "GraphRRG(10^4)", CHAINS, card, "eo_sparse",
                         warps=4))
    cases.append(eo_case(rrgn7, "GraphRRGNormal(10^4)", CHAINS, card,
                         "eo_sparse", warps=4))
    cases.append(eo_case(ea8, "GraphEA(8, 3)", CHAINS, card, "eo_lattice",
                         warps=1))
    cases.append(eo_case(sk1, "GraphSK(1024)", CHAINS, card, "eo_dense",
                         warps=1))
    cases.append(eo_case(drrg, "densify(GraphRRG(10^4))", CHAINS, card,
                         "eo_stream", warps=8))
    cases.append(eo_case(skn, "GraphSKNormal(4096)", 512, card,
                         "eo_stream", warps=4))

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
                                      B=HYPER_CHAINS, beta=beta,
                                      n_moves=moves(mode)))
        cases.append(eo_case(model, label, HYPER_CHAINS, card, f"eo_{kind}",
                             warps=32))
    cases += eo_route_cases(card, rrg7, rrgn7, ps)
    cases += eo_dense_sat_route_cases(card, sk1, drrg, skn, sat)

    # the replica composites, built with no device given: the card is the
    # default
    qskt = rt.GraphQSKT(Q_NK, Q_M, Q_GAMMA, Q_BETA, seed=Q_SEED)
    skre = {g: rt.GraphSKRE(RE_NK, RE_M, g, RE_BETA, seed=RE_SEED)
            for g in RE_GAMMAS}
    qrrg = rt.GraphQuant(SP_NK, SP_M, 1.0, 1.0,
                         rt.GraphRRG(SP_NK, 3, (-1, 1), seed=11))
    rerrg = rt.GraphRobustEnsemble(SP_NK, SP_M, 2.0, 1.0,
                                   rt.GraphRRG(SP_NK, 3, (-1, 1), seed=12))
    qnt = rt.GraphQSKNormalT(Q_NK, Q_M, Q_GAMMA, Q_BETA, seed=Q_SEED)
    qeat = rt.GraphQEAT(8, 3, SP_M, 0.5, Q_BETA, seed=13)
    require(qskt.resid_m.base.J.device.type == "cuda"
            and qeat.resid_m.base.J.device.type == "cuda",
            "the replica builders without a device are not on the card")
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(replica_race_case(qskt, "QSKT(1024, 16)", mode, card,
                                       "rejfree_replica", CHAINS, Q_BETA,
                                       moves(mode)))
    cases.append(replica_race_case(skre[2.0], "SKRE(1024, 5) gamma=2", "rrr",
                                   card, "rejfree_replica", CHAINS, RE_BETA,
                                   CMP_MOVES))
    cases.append(replica_race_case(qnt, "QSKNormalT(1024, 16)", "bkl", card,
                                   "rejfree_replica", SP_CHAINS, Q_BETA,
                                   CMP_MOVES))
    for model, label in ((qrrg, "Quant(RRG(1000, 3), M=8)"),
                         (rerrg, "RE(RRG(1000, 3), M=8)")):
        for mode in ("bkl", "wtm", "rrr"):
            cases.append(replica_race_case(
                model, label, mode, card, "rejfree_replica_sparse",
                SP_CHAINS, SP_BETA,
                moves(mode) if model is qrrg else CMP_MOVES))
    cases.append(replica_race_case(qeat, "QEAT(8, 3, M=8)", "bkl", card,
                                   "rejfree_replica_sparse", SP_CHAINS,
                                   Q_BETA, CMP_MOVES))
    cases.append(replica_sweep_case(qskt, "QSKT(1024, 16)", CHAINS, Q_BETA,
                                    card))
    cases.append(replica_sweep_case(skre[2.0], "SKRE(1024, 5) gamma=2",
                                    CHAINS, RE_BETA, card))
    cases.append(replica_sweep_case(qnt, "QSKNormalT(1024, 16)", SP_CHAINS,
                                    Q_BETA, card))
    cases.append(replica_sweep_case(qskt, "QSKT(1024, 16) equilibrium",
                                    CHAINS, Q_BETA, card,
                                    warm=Q_SWEEPS // 5))
    cases.append(replica_sweep_case(qskt, "QSKT(1024, 16) ragged",
                                    REPLICA_RAGGED_B, Q_BETA, card))
    cases.append(replica_sweep_case(qskt, "QSKT(1024, 16) small",
                                    SMALL_B, Q_BETA, card))
    # replica blocks whose rows are not 16-byte multiples: the ring with
    # 4-byte J loads and 4-spin span loads (Nk = 1100), the star with
    # single bytes (Nk = 1101)
    cases.append(replica_sweep_case(
        rt.GraphQSKT(1100, 4, Q_GAMMA, Q_BETA, seed=Q_SEED, device=DEV),
        "QSKT(1100, 4)", REPLICA_RAGGED_B, Q_BETA, card))
    cases.append(replica_sweep_case(
        rt.GraphSKRE(1101, 3, 2.0, RE_BETA, seed=RE_SEED, device=DEV),
        "SKRE(1101, 3) gamma=2", REPLICA_RAGGED_B, RE_BETA, card))
    # the path's gamma = 5 sweeps after their 100: nearly frozen, the
    # row-by-row commit
    cases.append(replica_sweep_case(skre[5.0], "SKRE(1024, 5) gamma=5 frozen",
                                    CHAINS, RE_BETA, card,
                                    warm=RE_GRID_SWEEPS))
    replica_refusals(card)
    # flatten(LE), the wrapper path's flat model: float couplings, centre
    # spins of degree M = 8 (K = 8), on the site, sparse race and sparse EO
    # kernels at the path's chains
    _, fle, _ = _le_models(DEV)
    label = f"flatten(LE(RRG({LE_NK}, 3), M={LE_M}))"
    cases.append(site_case(fle, label, card, SITE_CMP_MOVES, B=LE_CHAINS))
    for mode in ("bkl", "wtm", "rrr"):
        cases.append(rejfree_case(fle, label, mode, card, B=LE_CHAINS,
                                  beta=LE_BETA, n_moves=CMP_MOVES))
    cases.append(eo_case(fle, label, LE_CHAINS, card, "eo_sparse"))
    cases += fused_cases(card)
    cases += dense_fused_cases(card, sk1, drrg, skn)

    # the perceptrons (scripts/bench_all.py's perc_comm_section), built with
    # no device given: the card is the default
    percs = {"step": rt.GraphPercStep(PERC_N, PERC_P, seed=PERC_SEED),
             "linear": rt.GraphPercLinear(PERC_N, PERC_P, seed=PERC_SEED),
             "xentr": rt.GraphPercXEntr(PERC_N, PERC_P, PERC_LAM,
                                        seed=PERC_SEED)}
    require(all(m.xi.device.type == "cuda" for m in percs.values()),
            "the perceptron builders without a device are not on the card")
    for fam, model in percs.items():
        label = f"{PERC_NAMES[fam]}({PERC_N}, {PERC_P})"
        xentr = fam == "xentr"
        for mode in ("bkl", "wtm", "rrr"):
            cases.append(rejfree_case(
                model, label, mode, card, kernel="rejfree_perc",
                B=PERC_CHAINS, beta=PERC_BETA,
                n_moves=RACE_MOVES if fam == "step" and mode == "bkl"
                else CMP_MOVES,
                ops=lambda moves, applied, mode=mode, xentr=xentr: _ops_perc(
                    PERC_N, PERC_P, moves, mode, xentr)))
        cases.append(eo_case(
            model, label, PERC_CHAINS, card, "eo_perc",
            ops=lambda moves, bins, groups, xentr=xentr: _ops_perc(
                PERC_N, PERC_P, moves, "eo", xentr, bins, groups)))
    # the perceptron EO kernel with its pattern bits in global memory
    wide = rt.GraphPercStep(PERC_N, 4 * PERC_P + 3, seed=PERC_SEED)
    cases.append(eo_case(
        wide, f"GraphPercStep({PERC_N}, {wide.P})", 64, card, "eo_perc",
        ops=lambda moves, bins, groups: _ops_perc(
            PERC_N, wide.P, moves, "eo", False, bins, groups),
        n_moves=EO_ROUTE_MOVES))
    cases += hyper_fused_cases(card)

    rrg_records, rrg_counts = rrg_path(card)
    ea_records, ea_counts = ea_path(card)
    sk_records, sk_counts, sk_launches = dense_path(card, sk1, sk8, skn,
                                                    drrg, rrg7)
    eo_records, eo_counts, eo_launches = eo_path(card, rrg7, rrgn7, ea8,
                                                 sk1, drrg, skn)
    ps_records, ps_counts = pspin_path(card, ps)
    sat_records, sat_counts = sat_path(card, sat)
    rep_records, rep_counts, rep_launches = replica_path(
        card, qskt, skre, qrrg, rerrg, qnt, qeat)
    perc_records, perc_counts = perc_path(card, percs)
    factor_records, factor_counts = factors_path(card)
    generic_records, generic_counts = generic_path(card)
    wrapper_records, wrapper_counts = wrapper_path(card)
    pt_records, pt_counts, rrg = pt_path(card)
    et_records, et_counts = et_path(card)
    shard_counts = shard_path(card, rrg)
    script_counts = scripts_path(card)
    print(json.dumps({"paths": {"RRG": rrg_counts, "EA-3D": ea_counts,
                                "dense SK": sk_counts, "EO": eo_counts,
                                "PSpin3": ps_counts, "K-SAT": sat_counts,
                                "replica": rep_counts,
                                "perceptron": perc_counts,
                                "factors": factor_counts,
                                "generic": generic_counts,
                                "wrappers": wrapper_counts,
                                "tempering": pt_counts,
                                "ensembles": et_counts,
                                "shards": shard_counts,
                                "scripts": script_counts},
                      "runs": rrg_records + ea_records + sk_records
                      + eo_records + ps_records + sat_records
                      + rep_records + perc_records + factor_records
                      + generic_records + wrapper_records + pt_records
                      + et_records}))
    launches_classes = rrg_counts["rejfree_classes"]
    require(launches_classes > 0 and ea_counts["rejfree_classes"] > 0,
            "the class kernel: not launched on the RRG and EA-3D paths")
    launches = {"site_metropolis": rrg_counts["site_metropolis"],
                "rejfree_sparse": rrg_counts["rejfree_sparse"],
                "rejfree_lattice": ea_counts["rejfree_lattice"],
                "sweep_checkerboard": ea_counts["sweep_checkerboard"],
                **sk_launches, **eo_launches, **ps_counts, **sat_counts,
                **rep_launches, **perc_counts}
    regs = registers(build_log)
    sweep_instantiations(build_log, card)
    site_sweep_instantiations(build_log, card)
    eo_instantiations(build_log, card)
    spills = spill_bytes(build_log)
    local = fused_local_bytes()
    for fn, n in local.items():
        require(n == 0 and (not build_log or spills.get(fn) == 0),
                f"{fn}: {spills.get(fn)} spill bytes (ptxas), {n} local "
                f"bytes a thread")
    print(f"fused race kernels' most spill bytes (ptxas; null: not built in "
          f"this run): {json.dumps({fn: spills.get(fn) for fn in local})}, "
          f"most local bytes a thread over every instantiation: "
          f"{json.dumps(local)}  [{card}]")
    seen = {}
    for c in cases:
        if c.get("plan"):
            seen.setdefault(c["kernel"], set()).add(
                (c["plan"]["threads"], c["plan"]["field"],
                 c["plan"].get("patterns", c["plan"].get("saved", "-"))))
    print(f"fused launches (T, field, patterns) held to their plain "
          f"versions: {json.dumps({k: sorted(v) for k, v in seen.items()})}"
          f"  [{card}]")
    # every block size the rule picks on the paths, every resident type of
    # the sparse, dense and replica kernels (for the dense one at both
    # block sizes), both memories of the dense kernel's rrr saved fields and
    # both pattern memories of the perceptron kernel were held
    every = set(rejfree.FUSED_THREADS)
    for source, entries, fields, memories in (
            ("rejfree_sparse.cu", ("rejfree_sparse", "rejfree_lattice",
                                   "rejfree_pspin"),
             {"int8", "int16", "int32", "float32"}, {"-"}),
            ("rejfree_dense.cu", ("rejfree_dense", "rejfree_stream"),
             {"int8", "int16", "int32", "float32"},
             {"none", "shared", "global"}),
            ("rejfree_replica.cu", ("rejfree_replica",
                                    "rejfree_replica_sparse"),
             {"int8", "int16", "int32", "float32"}, {"-"}),
            ("rejfree_sat.cu", ("rejfree_sat",), {"int16"}, {"-"}),
            ("rejfree_perc.cu", ("rejfree_perc",), {"int16"},
             {"shared", "global"})):
        got = set().union(*(seen.get(e, set()) for e in entries))
        for what, want, have in (
                ("block sizes", every, {t for t, _, _ in got}),
                ("field types", fields, {f for _, f, _ in got}),
                ("pattern memories", memories, {m for _, _, m in got})):
            require(want <= have, f"{source}: {what} {sorted(have)} held, "
                                  f"not all of {sorted(want)}")
        if source == "rejfree_dense.cu":
            pairs = {(t, f) for t in every for f in fields}
            require(pairs <= {(t, f) for t, f, _ in got},
                    f"{source}: (T, field) {sorted(got)} held, not every "
                    f"pair of {sorted(pairs)}")
        if source == "rejfree_perc.cu":
            for m in memories:
                require(every <= {t for t, _, mm in got if mm == m},
                        f"{source}: patterns in {m} memory not held at "
                        f"every block size")

    # every route, key type and pattern memory of the redesigned EO
    # kernels was held to its plain version
    eo_seen = {(c["eo_plan"].get("warps"), c["eo_plan"].get("key"),
                c["eo_plan"].get("patterns"), c["kernel"])
               for c in cases if c.get("eo_plan")}
    from rrrmc_tpu_torch.ops import eo as eo_ops
    sparse = ("eo_sparse", "eo_lattice", "eo_pspin")
    dense = ("eo_dense", "eo_stream")
    for what, want, have in (
            ("eo_sparse.cu warps a chain", set(eo_ops.EO_WARPS),
             {w for w, _, _, k in eo_seen if k in sparse}),
            ("eo_sparse.cu key types", {"int8", "int16", "int32", "float32"},
             {t for _, t, _, k in eo_seen if k in sparse}),
            ("eo_dense.cu warps a chain", set(eo_ops.EO_WARPS),
             {w for w, _, _, k in eo_seen if k in dense}),
            ("eo_dense.cu key types", {"int8", "int16", "int32", "float32"},
             {t for _, t, _, k in eo_seen if k in dense}),
            ("eo_sat.cu warps a chain", set(eo_ops.EO_WARPS),
             {w for w, _, _, k in eo_seen if k == "eo_sat"}),
            ("eo_sat.cu key types", {"uint8", "uint16"},
             {t for _, t, _, k in eo_seen if k == "eo_sat"}),
            ("eo_sparse.cu PSpin3 warps", set(eo_ops.EO_WARPS),
             {w for w, _, _, k in eo_seen if k == "eo_pspin"}),
            ("eo_perc.cu pattern memories", {"shared", "global"},
             {m for _, _, m, k in eo_seen if k == "eo_perc"})):
        print(f"{what} held to the plain version: {sorted(have)}  [{card}]")
        require(want <= have, f"{what}: {sorted(have)} held, not all of "
                              f"{sorted(want)}")

    kernels = []
    for name, (replaces, source, function) in ENTRIES.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]   # times: the first case (race: bkl mode)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"rrrmc_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "registers": regs.get(function),
            **({"plan": head["plan"]} if head.get("plan") else {}),
            **({"eo_plan": head["eo_plan"],
                "bound_two_calls_ms": head["bound_two_calls_ms"],
                "tie_groups_a_move": head["tie_groups_a_move"]}
               if "bound_two_calls_ms" in head else {}),
            **({"site_plan": head["site_plan"],
                "beta_per_chain_ms": next(c["ms"] for c in mine
                                          if "(PT)" in c["case"]),
                "tempering_launches": pt_counts["site_metropolis"]}
               if "site_plan" in head else {}),
            **({"sweep_plan": head["sweep_plan"],
                "equilibrium_ms": next((c["ms"] for c in mine
                                        if c.get("warm")), None)}
               if "sweep_plan" in head else {})})
        require(launches[name] > 0, f"{name}: not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"class kernel": {
        "source": "rrrmc_tpu_torch/csrc/rejfree_classes.cu",
        "replaces": None, "launches": launches_classes,
        "cases": [{k: c[k] for k in ("case", "B", "moves", "ms", "ms_full",
                                     "plain_ms", "bound_ms", "bound_by")}
                  for c in class_cases],
        "plan": class_cases[0]["classes_plan"]}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
