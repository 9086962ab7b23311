"""One rank of scripts/torch_multihost_eff.py (the JAX package's
scripts/_multihost_worker.py on the PyTorch port): joins a P-rank
torch.distributed group (NCCL on the cards, one card a rank; gloo on the
host, each rank pinned to its own core), runs the weak-scaling workloads
through parallel/distributed.py, and writes rank 0's measured rates to the
JSON file named by its argument.

    python scripts/_torch_multihost_worker.py RANK P PORT OUT
        [--device cpu] [--chains-per-rank C] [--sweeps S] [--pt-rounds R]
        [--pt-sweeps S] [--pt-chains C] [--reps R]

Workloads, constant a rank (weak scaling), on GraphEA(6, 3, +-J, seed=3)
(N = 216), beta 1.5:
  * chains: chain-sharded sweepMC, `chains-per-rank` chains a rank, no
    communication inside the run; one fetch_global (an all_gather) after;
  * pt: parallel tempering with 2 rungs a rank, the ladder sharded over
    the ranks (beta from 0.5 to 2.0): one all_gather a round.
Each is warmed with the same arguments, then timed best of `reps`, each
rep ending in a gather of its energies on every rank. Rank 0 also writes
the chain workload's final energies, gathered, so two worlds of the same
total chains can be compared.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import script_device
from rrrmc_tpu_torch.parallel import distributed as dist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chains-per-rank", type=int, default=64)
    ap.add_argument("--sweeps", type=int, default=2400)
    ap.add_argument("--pt-rounds", type=int, default=3)
    ap.add_argument("--pt-sweeps", type=int, default=1600)
    ap.add_argument("--pt-chains", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--L", type=int, default=6)
    args = ap.parse_args(argv)
    cpu = script_device(args.device, "_torch_multihost_worker").type == "cpu"
    if cpu:
        try:
            os.sched_setaffinity(0, {args.rank % os.cpu_count()})
        except (AttributeError, OSError):
            pass
        torch.set_num_threads(1)
    dist.initialize(f"127.0.0.1:{args.port}", args.nprocs, args.rank,
                    backend="gloo" if cpu else "nccl")
    try:
        P = tdist.get_world_size()
        mesh = dist.global_mesh()
        dev = mesh.devices[mesh.local_positions()[0]]
        X = rt.GraphEA(args.L, 3, (-1, 1), seed=3, device=dev)
        chains = args.chains_per_rank * P

        def sampled(seed, state=None):
            kw = {"state": state} if state is not None else {}
            return dist.sample_distributed(
                rt.sweepMC, X, 1.5, args.sweeps, step=args.sweeps,
                chains=chains, mesh=mesh, seed=seed, **kw)[1]

        st = sampled(5)
        dist.fetch_global(st.E, mesh)            # warm, and a barrier
        dt = float("inf")
        for rep in range(args.reps):
            t0 = time.perf_counter()
            st = sampled(6 + rep, st)
            E_all = dist.fetch_global(st.E, mesh)
            dt = min(dt, time.perf_counter() - t0)
        route = rt.LAST_ROUTE.get("backend")
        chains_rate = chains * args.sweeps * X.N / dt

        mesh_t = dist.global_mesh({"temp": P})
        betas = np.linspace(0.5, 2.0, 2 * P)

        def tempered(seed):
            _, ranks, _ = rt.parallel_tempering(
                X, betas, args.pt_rounds, sweeps_per_round=args.pt_sweeps,
                chains=args.pt_chains, seed=seed, mesh=mesh_t, axis="temp")
            return dist.fetch_global(ranks, mesh_t, dim=1)

        tempered(7)                              # warm, and a barrier
        dtp = float("inf")
        for rep in range(args.reps):
            t0 = time.perf_counter()
            tempered(8 + rep)
            dtp = min(dtp, time.perf_counter() - t0)
        pt_route = rt.LAST_ROUTE.get("backend")
        pt_rate = (2 * P * args.pt_chains * args.pt_rounds * args.pt_sweeps
                   * X.N / dtp)
        if tdist.get_rank() == 0:
            with open(args.out, "w") as f:
                json.dump({"nprocs": P, "backend": tdist.get_backend(),
                           "chains": chains,
                           "chains_flips_per_s": chains_rate,
                           "chains_route": route,
                           "pt_rungs": 2 * P, "pt_flips_per_s": pt_rate,
                           "pt_route": pt_route,
                           "chains_E": E_all.cpu().tolist()}, f)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
