"""The launch-plan seam of the port's kernels: what every wrapper in ops/
needs to plan and account for a launch beside its kernel's own rule.

- `facts`: an instantiation's occupancy facts from the library's C entry,
  and `sm_count` / `max_smem`, a card's multiprocessors and the most
  dynamic shared bytes a block may opt in to. Each is asked once a process
  for each key: the facts hold for one library and one device.
- `PLANS`: the last plan of each kernel, by the kernel's name, written by
  `record`; `LAUNCHES`: the launches of each kernel since the process
  started, counted by `launched` (a reader takes differences or sets an
  entry to 0).
- `require_smem`: the one refusal of a chain whose state does not fit in
  a block's shared memory.

Each kernel's choice of plan stays in its module, a pure function of the
facts it is handed (ops/site.py::site_plan, ops/sweep.py::sweep_plan,
ops/rejfree.py::fused_plan, ops/eo.py::eo_plan, ...).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Optional

import torch

#: the last plan of each kernel ("site", "sweep", "rejfree_sparse",
#: "rejfree_classes", "eo_sparse", ...): its block size or warps, resident
#: type, shared bytes, blocks per SM, registers and local bytes a thread
PLANS: dict = {}
#: launches of each kernel, by the same names (`launched`)
LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def facts(entry: str, head: tuple, threads: Optional[int],
          need: Optional[int], device: int) -> tuple:
    """The five ints the library's C entry writes, asked as
    entry(threads, *head, need, device, out[5]) (`threads` the block's
    threads, chains or warps, as the entry takes them; None where it takes
    none, and likewise `need`). A plan's entries give an instantiation's
    [blocks per SM, registers, local bytes, static shared bytes, most
    dynamic shared bytes] at `need` dynamic bytes."""
    from .cuda_build import check, library

    out = (ctypes.c_int * 5)()
    args = ((() if threads is None else (threads,)) + tuple(head)
            + (() if need is None else (need,)))
    check(getattr(library(), entry)(*args, device, out), entry)
    return tuple(out)


def info(entry: str, head: tuple, device: int) -> Callable:
    """info(T, need) of a plan rule: `facts` of `entry` with `head` at T
    and `need` dynamic bytes on `device`."""
    return lambda t, need: facts(entry, head, t, need, device)


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The multiprocessors of CUDA device `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_smem(entry: str, device: int) -> int:
    """The most dynamic shared bytes a block of a kernel may opt in to on
    `device`, from the library's C entry entry(device)."""
    from .cuda_build import library

    return int(getattr(library(), entry)(device))


def launched(kernel: str, err: int) -> None:
    """Count a launch of `kernel` in LAUNCHES; raise on the cudaError_t
    `err` it returned instead."""
    from .cuda_build import check

    check(err, f"{kernel} launch")
    LAUNCHES[kernel] += 1


def record(kernel: str, plan: dict) -> dict:
    """Keep `plan` as the last plan of `kernel` in PLANS; returns it."""
    PLANS[kernel] = plan
    return plan


def require_smem(smem: int, cap: int, N: int, what: str) -> None:
    """Raise NotImplementedError when a chain's resident state (`smem`
    bytes) exceeds the shared memory a block may have (`cap`)."""
    if smem > cap:
        raise NotImplementedError(
            f"the {what} kernel keeps a chain's state in shared memory: "
            f"N={N} needs {smem} bytes, a block may have {cap}")
