"""Checkpoint and resume of sampler states (the JAX package's
rrrmc_tpu/utils/checkpoint.py).

A state (MCState, PTState, ETState, EOResult, or any tree of frozen
dataclasses, tuples and lists of tensors, generators and ints) is saved as
one .npz: leaf i of the tree in field order as `leaf_i` (a generator as
its `get_state()` bytes, an int such as a chain offset as a 0-d int64
array), `n_leaves`, and `structure`, the tree's types, field names and
kinds of leaf as text. No code is pickled:
`load_state` needs a template of the same structure (a fresh `init_state`
of the same model and chain count, say), which also fixes the devices and
dtypes. A state saved and loaded continues exactly as the state
it was saved from: spins, aux, energies, counters and every generator's
position in its stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.mesh import leaves, tree_map


#: what a checkpoint stores: tensors, generators and ints (chain offsets,
#: counters), in the order of parallel/mesh.py's tree walkers
KINDS = (torch.Tensor, torch.Generator, int)


def _structure(tree) -> str:
    """The tree's shape as text: dataclass types with their fields, tuples
    and lists with their lengths, the kinds of the leaves."""
    if torch.is_tensor(tree):
        return "T"
    if isinstance(tree, torch.Generator):
        return "G"
    if isinstance(tree, int):
        return "I"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree).__name__ + "(" + ",".join(
            f"{f.name}={_structure(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "[" + ",".join(_structure(x) for x in tree) + "]"
    return "-"


def save_state(path: str, state) -> None:
    """Dump a sampler state (MCState, PTState, ETState, EOResult, ...) to
    the .npz `path`."""
    parts = list(leaves(state, KINDS))
    arrays = {"n_leaves": np.asarray(len(parts)),
              "structure": np.asarray(_structure(state))}
    for i, x in enumerate(parts):
        if isinstance(x, torch.Generator):
            arrays[f"leaf_{i}"] = x.get_state().numpy()
        elif isinstance(x, int):
            arrays[f"leaf_{i}"] = np.asarray(x, dtype=np.int64)
        else:
            arrays[f"leaf_{i}"] = x.detach().cpu().numpy()
    np.savez(path, **arrays)


def load_state(path: str, like):
    """The state saved at `path`, in the structure of `like` (same sampler,
    model and chain count), each tensor on the template's device in its
    dtype and each generator on the template generator's device. Raises
    ValueError where the checkpoint's structure (types, fields, leaves)
    or a shape differs from the template's."""
    data = np.load(path)
    parts = list(leaves(like, KINDS))
    n = int(data["n_leaves"])
    want = _structure(like)
    if str(data["structure"]) != want:
        raise ValueError(f"checkpoint structure {data['structure']} != "
                         f"template {want}")
    if n != len(parts):
        raise ValueError(f"checkpoint has {n} leaves, template has "
                         f"{len(parts)}")
    out = []
    for i, x in enumerate(parts):
        raw = data[f"leaf_{i}"]
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(torch.from_numpy(raw.copy()))
            out.append(g)
        elif isinstance(x, int):
            out.append(int(raw))
        else:
            if tuple(raw.shape) != tuple(x.shape):
                raise ValueError(f"leaf {i}: shape {tuple(raw.shape)} != "
                                 f"template {tuple(x.shape)}")
            out.append(torch.from_numpy(raw.copy()).to(device=x.device,
                                                       dtype=x.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), like, KINDS)
