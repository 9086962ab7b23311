"""The port's torch.distributed runs (rrrmc_tpu_torch/parallel/
distributed.py): two spawned CPU processes join a gloo group, run
chain-sharded sweepMC and parallel tempering with the temperature axis
over the ranks, and the gathered results must equal the same runs
unsharded in this process bit for bit, as tests/test_distributed.py holds
the JAX package. Every wait has a time limit, and a worker still running
at it is killed."""

import json
import os
import socket
import subprocess
import sys

import torch

import rrrmc_tpu_torch as pt

#: seconds the workers may take (they take a few)
WORKER_TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_bit_exact(tmp_path):
    out = tmp_path / "dist_out.json"
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=repo_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, worker, str(out)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append((p.returncode, so.decode()[-2000:],
                         se.decode()[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _, _ in logs), logs
    got = json.loads(out.read_text())

    X = pt.GraphEA(4, 2, (-1, 1), seed=3, device="cpu")
    Es, st = pt.sweepMC(X, 1.5, 40, step=10, chains=16, seed=5,
                        device="cpu")
    assert got["route"] == pt.LAST_ROUTE["backend"] == "kernel-sweep"
    assert torch.equal(torch.tensor(got["Es"]), Es)
    assert torch.equal(torch.tensor(got["E"], dtype=st.E.dtype), st.E)
    assert torch.equal(torch.tensor(got["sigma"], dtype=torch.int8),
                       st.sigma)

    betas = torch.linspace(0.5, 2.0, 8).tolist()
    EsP, ranks, pst = pt.parallel_tempering(X, betas, 6, sweeps_per_round=2,
                                            chains=4, seed=7, device="cpu")
    assert got["local_T"] == 4
    assert torch.equal(torch.tensor(got["EsP"]), EsP)
    assert torch.equal(torch.tensor(got["ranks"], dtype=torch.int32), ranks)
    assert torch.equal(torch.tensor(got["sigmaP"], dtype=torch.int8),
                       pst.sigma)


def test_one_rank_group_equals_unsharded():
    """A one-rank gloo group (the card's one-rank NCCL run, on the host):
    sample_distributed(sweepMC) and parallel tempering over the temperature
    axis equal their unsharded runs, and fetch_global returns the whole."""
    import torch.distributed as tdist
    from rrrmc_tpu_torch.parallel import distributed as dist

    dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        X = pt.GraphRRG(16, 3, (-1, 1), seed=2, device="cpu")
        mesh = dist.global_mesh()
        Es, st = dist.sample_distributed(pt.sweepMC, X, 1.5, 20, step=5,
                                         chains=8, mesh=mesh, seed=4)
        Es0, st0 = pt.sweepMC(X, 1.5, 20, step=5, chains=8, seed=4,
                              device="cpu")
        assert torch.equal(dist.fetch_global(Es, mesh), Es0)
        assert torch.equal(st.sigma, st0.sigma)
        mesh_t = dist.global_mesh({"temp": 1})
        a = pt.parallel_tempering(X, [0.5, 1.0, 2.0], 5, chains=4, seed=3,
                                  mesh=mesh_t)
        b = pt.parallel_tempering(X, [0.5, 1.0, 2.0], 5, chains=4, seed=3,
                                  device="cpu")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    finally:
        tdist.destroy_process_group()
