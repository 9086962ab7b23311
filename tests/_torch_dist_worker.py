"""Subprocess worker of tests/test_torch_distributed.py: joins a
torch.distributed gloo group from MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK, runs chain-sharded sweepMC and parallel tempering with its
temperature axis over the ranks, and writes rank 0's gathered results to
the JSON file named by its argument. It imports the PyTorch port only."""

import json
import sys

import torch
import torch.distributed as tdist

import rrrmc_tpu_torch as pt
from rrrmc_tpu_torch.parallel import distributed as dist


def main():
    out = sys.argv[1]
    torch.set_num_threads(1)
    dist.initialize()
    world = tdist.get_world_size()
    X = pt.GraphEA(4, 2, (-1, 1), seed=3, device="cpu")

    mesh = dist.global_mesh()
    Es, st = dist.sample_distributed(pt.sweepMC, X, 1.5, 40, step=10,
                                     chains=16, mesh=mesh, seed=5)
    route = pt.LAST_ROUTE["backend"]
    Es_g = dist.fetch_global(Es, mesh)
    E_g = dist.fetch_global(st.E, mesh)
    sig_g = dist.fetch_global(st.sigma, mesh)

    mesh_t = dist.global_mesh({"temp": world})
    betas = torch.linspace(0.5, 2.0, 8).tolist()
    EsP, ranks, pst = pt.parallel_tempering(X, betas, 6, sweeps_per_round=2,
                                            chains=4, seed=7, mesh=mesh_t)
    EsP_g = dist.fetch_global(EsP, mesh_t, dim=1)
    ranks_g = dist.fetch_global(ranks, mesh_t, dim=1)
    sigP_g = dist.fetch_global(pst.sigma, mesh_t)
    if tdist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump({"route": route, "Es": Es_g.tolist(),
                       "E": E_g.tolist(), "sigma": sig_g.tolist(),
                       "EsP": EsP_g.tolist(), "ranks": ranks_g.tolist(),
                       "sigmaP": sigP_g.tolist(),
                       "local_T": int(EsP.shape[1])}, f)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
