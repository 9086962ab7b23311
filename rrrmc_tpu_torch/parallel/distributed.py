"""Multi-process runs on torch.distributed (the JAX package's
rrrmc_tpu/parallel/distributed.py).

`initialize` joins a process group: NCCL on CUDA (one card a rank), gloo
on the CPU. `global_mesh` is a Mesh with one position a rank. Chains are
keyed by their global id (`MCState.chain0`, ops/prng.py), so a run sharded
over ranks gives exactly the unsharded run on the kernel routes: each rank
builds the unsharded start (cheap at state scale) and keeps its slice. The
chains need no communication; parallel tempering with its temperature axis
over ranks gathers one packed tensor a swap round
(parallel/tempering.py), and `fetch_global` gathers a result.

NCCL refuses two ranks on one card, so one card runs a one-rank NCCL
group; a CUDA machine without NCCL is an error, not a switch to gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..samplers.common import MCState, init_state
from .mesh import Mesh, copy_generator, leaves, to_device, tree_map


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> None:
    """Join the process group. The arguments default to MASTER_ADDR:
    MASTER_PORT, WORLD_SIZE and RANK. backend: "nccl" where CUDA is
    available (each rank on card rank % device_count), else "gloo"; NCCL
    missing on a CUDA machine raises."""
    addr = coordinator_address or (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("initialize: CUDA is available but this "
                               "torch has no NCCL")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)


def global_mesh(axis_sizes: Optional[dict] = None) -> Mesh:
    """A Mesh with one position a rank (rank r at flat position r, on its
    device); default one 'chains' axis."""
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"chains": world}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {axis_sizes} != {world} ranks")
    nccl = dist.get_backend() == "nccl"
    n_dev = torch.cuda.device_count() if nccl else 1
    devs = np.empty(world, dtype=object)
    devs[:] = [torch.device("cuda", r % n_dev) if nccl
               else torch.device("cpu") for r in range(world)]
    return Mesh(devices=devs.reshape(sizes), axis_names=tuple(axis_sizes),
                ranks=np.arange(world).reshape(sizes))


def _my_slice(mesh: Mesh, axis: str, n: int) -> tuple:
    """(lo, hi) of this rank's part of a leading axis of n along `axis`."""
    pos = mesh.local_positions()
    if len(pos) != 1:
        raise ValueError("a distributed mesh holds one position a rank")
    k, m = mesh.index(pos[0], axis), mesh.size(axis)
    if n % m:
        raise ValueError(f"{n} does not split into {m} shards")
    return k * (n // m), (k + 1) * (n // m)


def shard_global(tree, mesh: Mesh, axis: str = "chains"):
    """This rank's shard of a tree whose tensors are whole and equal on
    every rank: the leading axis cut along `axis` (0-d tensors whole), on
    this rank's device, generators copied there; an MCState's chain0 moves
    to the shard's first chain."""
    dev = mesh.devices[mesh.local_positions()[0]]
    lead = next(x for x in leaves(tree) if x.ndim)
    lo, hi = _my_slice(mesh, axis, lead.shape[0])

    def cut(x):
        if isinstance(x, torch.Generator):
            return copy_generator(x, dev)
        return (x if x.ndim == 0 else x[lo:hi]).to(dev).contiguous()
    out = tree_map(cut, tree)
    if isinstance(out, MCState):
        out = dataclasses.replace(out, chain0=tree.chain0 + lo)
    return out


def init_state_distributed(model, chains: int, seed: int, mesh: Mesh,
                           axis: str = "chains") -> MCState:
    """This rank's shard of init_state(model, chains, seed): built whole on
    the rank's device, then cut, so its chains equal the unsharded ones."""
    dev = mesh.devices[mesh.local_positions()[0]]
    whole = init_state(to_device(model, dev), chains, seed, device=dev)
    return shard_global(whole, mesh, axis)


def sample_distributed(sampler, model, *args, chains: int, mesh: Mesh,
                       axis: str = "chains", seed: int = 0, **kw):
    """Run a sampler with the chains sharded over the ranks of `mesh`:
    each rank runs its shard (its `init_state_distributed`, or its cut of
    a whole `state=`, or a shard `state=` of its own size as a previous
    call returned). Returns the rank's (Es, state); `fetch_global` joins
    them."""
    dev = mesh.devices[mesh.local_positions()[0]]
    model = to_device(model, dev)
    state = kw.pop("state", None)
    kw.pop("device", None)
    lo, hi = _my_slice(mesh, axis, chains)
    if state is None:
        state = init_state_distributed(model, chains, seed, mesh, axis)
    elif state.sigma.shape[0] == chains and hi - lo != chains:
        state = shard_global(state, mesh, axis)
    return sampler(model, *args, chains=hi - lo, state=state, **kw)


def fetch_global(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The whole of a tensor sharded over the ranks of `mesh` (one mesh
    axis of size > 1), on every rank: the ranks' parts (one all_gather),
    joined along `dim` in mesh order."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    order = [int(mesh.ranks[p]) for p in mesh.positions()]
    return torch.cat([parts[r] for r in order], dim=dim)
