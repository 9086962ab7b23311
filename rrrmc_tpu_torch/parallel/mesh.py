"""Chain and disorder sharding over a mesh of torch devices (the JAX
package's rrrmc_tpu/parallel/mesh.py).

Chains are independent, so sharding is data parallelism: a shard is a
slice of the chain axis with the model copied to its device, and nothing
moves between shards while they run. A `Mesh` is an array of torch devices
with named axes; a device may repeat, so one card (or the CPU) can hold
several shards, run one after another. Each position also names the
process rank that owns it: every position is this process's in a mesh
from `make_mesh`, one position a rank in `distributed.global_mesh`.

Bit-exact shards. The kernels key chain b's Philox stream by (seed,
chain0 + b) (ops/prng.py), and `MCState.chain0` carries a shard's first
global chain, so on the kernel routes a shard draws what its chains draw
unsharded. Each shard also starts from a copy of the unsharded state's
generator, so it draws the same kernel seeds and site schedules. The
generic torch routes draw [B]-shaped uniforms from one generator, so a
shard of them is a valid chain but not the unsharded one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..samplers.common import LAST_ROUTE, MCState, init_state


def process_rank() -> int:
    """This process's rank in the torch.distributed group (0 without
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on named axes: devices[i0, i1, ...] is a torch.device, and
    ranks[i0, i1, ...] the process rank that owns that position."""
    devices: np.ndarray
    axis_names: tuple
    ranks: np.ndarray

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: Optional[str]) -> int:
        """Positions along `axis` (1 for None or an axis the mesh lacks)."""
        return self.shape.get(axis, 1)

    def index(self, pos: tuple, axis: Optional[str]) -> int:
        """The index of position `pos` along `axis` (0 for None or an
        axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return pos[self.axis_names.index(axis)]

    def positions(self) -> list:
        """Every position, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def local_positions(self) -> list:
        """The positions this process owns, in row-major order."""
        me = process_rank()
        return [p for p in self.positions() if int(self.ranks[p]) == me]

    def is_local(self) -> bool:
        """True when this process owns every position."""
        return len(self.local_positions()) == self.devices.size

    def along(self, axis: str) -> list:
        """The devices at index 0, 1, ... along `axis` (index 0 on the
        other axes)."""
        k = self.axis_names.index(axis)
        return [self.devices[tuple(i if a == k else 0
                                   for a in range(self.devices.ndim))]
                for i in range(self.devices.shape[k])]


def make_mesh(axis_sizes: Optional[dict] = None, *, devices=None) -> Mesh:
    """A Mesh over `devices` (default: every CUDA device), all owned by
    this process; default axes one 'chains' axis.

    axis_sizes: ordered {axis_name: size} whose product is the number of
    devices, e.g. {"temp": 2, "chains": 4}. Devices may repeat:
    make_mesh({"chains": 4}, devices=["cuda"] * 4) cuts four shards on one
    card, [torch.device("cpu")] * 4 on the host."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                               "devices= for the host)")
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {"chains": len(devices)}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {axis_sizes} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(devices=arr.reshape(sizes), axis_names=tuple(axis_sizes),
                ranks=np.full(sizes, process_rank(), dtype=np.int64))


# ---- trees: dataclasses, tuples and lists of tensors and generators ----

def tree_map(fn, tree, kinds=(torch.Tensor, torch.Generator)):
    """fn applied to every leaf of `kinds` (by default the tensors and
    generators) of a tree of frozen dataclasses, tuples and lists; other
    leaves (ints, floats, None) are kept."""
    if isinstance(tree, kinds):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), kinds)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, kinds) for x in tree)
    return tree


def copy_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on `device` at `gen`'s state (a CUDA state on another
    card continues the same Philox stream; the CPU and the card draw
    different streams)."""
    out = torch.Generator(device=device)
    out.set_state(gen.get_state())
    return out


def to_device(tree, device):
    """Every tensor of `tree` on `device` (generators copied there)."""
    device = torch.device(device)

    def put(x):
        if isinstance(x, torch.Generator):
            return copy_generator(x, device)
        return x.to(device)
    return tree_map(put, tree)


def shard_leading(tree, mesh: Mesh, axis: str = "chains") -> list:
    """The shards of `tree` along `axis`: shard k holds slice k of every
    tensor's leading axis (0-d tensors whole) on the k-th device along the
    axis; generators are copied to it, and an MCState's chain0 is moved to
    its shard's first chain."""
    devs = mesh.along(axis)
    n = len(devs)
    out = []
    for k, dev in enumerate(devs):
        def cut(x, k=k, dev=dev):
            if isinstance(x, torch.Generator):
                return copy_generator(x, dev)
            if x.ndim == 0:
                return x.to(dev)
            if x.shape[0] % n:
                raise ValueError(f"leading axis {x.shape[0]} does not "
                                 f"split into {n} shards")
            m = x.shape[0] // n
            return x[k * m:(k + 1) * m].to(dev).contiguous()
        shard = tree_map(cut, tree)
        if isinstance(shard, MCState):
            shard = dataclasses.replace(
                shard, chain0=tree.chain0 + k * (tree.sigma.shape[0] // n))
        out.append(shard)
    return out


def replicate(tree, mesh: Mesh) -> list:
    """A copy of `tree` (e.g. the model) on every position's device, in
    row-major order."""
    return [to_device(tree, mesh.devices[p]) for p in mesh.positions()]


def stack_models(models: Sequence):
    """Same-shape disorder realizations with every tensor stacked on a
    leading axis (the analog of the reference's per-seed loops,
    scripts/scripts.jl:83-149, as one tree). Static metadata must agree."""
    return _combine(list(models), torch.stack)


def concat_trees(trees: Sequence, device=None):
    """Trees of one structure joined along every tensor's leading axis on
    `device` (the first tree's when None); 0-d tensors and generators are
    the first tree's."""
    return _combine(list(trees), torch.cat, device)


def _combine(trees: list, join, device=None):
    first = trees[0]
    if device is None:
        t = next(leaves(first), None)
        device = t.device if t is not None else None
    if torch.is_tensor(first):
        if first.ndim == 0 and join is torch.cat:
            return first.to(device)
        return join([x.to(device) for x in trees])
    if isinstance(first, torch.Generator):
        return first
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        kw = {}
        for f in dataclasses.fields(first):
            if not f.init:
                continue
            vals = [getattr(t, f.name) for t in trees]
            if torch.is_tensor(vals[0]) or dataclasses.is_dataclass(
                    vals[0]) or isinstance(vals[0], (tuple, list)):
                kw[f.name] = _combine(vals, join, device)
            elif isinstance(vals[0], torch.Generator):
                kw[f.name] = (vals[0] if join is torch.cat
                              else tuple(vals))
            elif f.name != "chain0" or join is torch.stack:
                if any(v != vals[0] for v in vals[1:]):
                    raise ValueError(f"{f.name}: static fields differ "
                                     f"across trees: {vals}")
                kw[f.name] = vals[0]
            else:   # the shards' first chains: the first shard's
                kw[f.name] = vals[0]
        return dataclasses.replace(first, **kw)
    if isinstance(first, (tuple, list)):
        return type(first)(_combine([t[i] for t in trees], join, device)
                           for i in range(len(first)))
    return first


def leaves(tree, kinds=(torch.Tensor,)):
    """The leaves of `kinds` (by default the tensors) of a tree, in the
    order in which tree_map visits them."""
    if isinstance(tree, kinds):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if f.init:
                yield from leaves(getattr(tree, f.name), kinds)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from leaves(x, kinds)


def sample_sharded(sampler, model, mesh: Mesh, *args, chains: int,
                   chain_axis: str = "chains", **kw):
    """Run any sampler with the chain axis cut into the mesh's shards along
    `chain_axis`, one sampler call a shard on its device (in turn, as the
    shards of one card), and the results joined on the first device.

    The state (`state=`, else init_state(model, chains, seed, C0) on the
    first device, seed default 0 as in the JAX package) is cut by
    `shard_leading`, so on a kernel route the result equals the unsharded
    call bit for bit (module docstring). Returns what the sampler returns,
    every tensor joined along its leading (chain) axis; the state's
    generator is the first shard's, its chain0 the whole batch's."""
    devs = mesh.along(chain_axis)
    n = len(devs)
    if chains % n:
        raise ValueError(f"{chains} chains do not split into {n} shards")
    state = kw.pop("state", None)
    seed = kw.pop("seed", 0)
    C0 = kw.pop("C0", None)
    kw.pop("device", None)
    if state is None:
        state = init_state(to_device(model, devs[0]), chains, seed, C0,
                           device=devs[0])
    shards = shard_leading(state, mesh, chain_axis)
    outs = [sampler(to_device(model, dev), *args, chains=chains // n,
                    state=st, **kw) for dev, st in zip(devs, shards)]
    out = concat_trees(outs, devs[0])
    if isinstance(out, tuple):
        out = tuple(dataclasses.replace(x, chain0=state.chain0)
                    if isinstance(x, MCState) else x for x in out)
    LAST_ROUTE["shards"] = n
    return out


def sample_disorder(sampler, models: Sequence, *args, chains: int,
                    mesh: Optional[Mesh] = None, axis: str = "disorder",
                    seed: int = 0, **kw):
    """Run one sampler over many disorder realizations: one sampler call an
    instance on every route (the JAX package's kernel mode), instance d
    from init_state(models[d], chains, seed + 104729 d) (or slice d of a
    stacked `state=`) on its model's device, or with `mesh` on the device
    of its block along `axis` (D a multiple of the axis' size).

    Returns the sampler's results stacked on a leading D axis on the first
    instance's device: (Es [D, chains, n_ckpt], state) for the MCMC
    samplers, an EOResult of [D, ...] tensors for extremal_opt; a stacked
    state's generator is the tuple of the instances'. LAST_ROUTE is the
    last instance's, with "disorder_instances": D."""
    models = list(models)
    D = len(models)
    if mesh is not None:
        devs = mesh.along(axis)
        if D % len(devs):
            raise ValueError(f"{D} instances do not split over "
                             f"{len(devs)} devices")
        models = [to_device(m, devs[d * len(devs) // D])
                  for d, m in enumerate(models)]
    stacked = kw.pop("state", None)
    kw.pop("device", None)
    results = []
    for d, m in enumerate(models):
        dev = next(leaves(m)).device
        if stacked is None:
            st = init_state(m, chains, seed + 104729 * d, device=dev)
        else:
            st = _instance(stacked, d, dev)
        results.append(sampler(m, *args, chains=chains, state=st,
                               seed=seed + 104729 * d + 1, **kw))
    out = stack_models(results)
    LAST_ROUTE["disorder_instances"] = D
    return out


def _instance(stacked: MCState, d: int, device) -> MCState:
    """Instance d of a stacked MCState, on `device`."""
    gens = stacked.generator
    gen = gens[d] if isinstance(gens, tuple) else gens
    st = dataclasses.replace(stacked, generator=gen)
    return to_device(tree_map(lambda x: x if isinstance(x, torch.Generator)
                              else x[d], st), device)
