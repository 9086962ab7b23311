"""Work floor of the sparse race kernel (csrc/rejfree_sparse.cu, with
race.cuh) running BKL over the window.

Operations: a move applies one flip, which needs at least one random draw
(the site's; the skip's is not counted), the flipped spin, its energy and
the K neighbours' fields (one add each): K + 3. The iterations a move
stands for, the race's passes over the N sites, Philox rounds and the
z sums are not counted: a class-based selection does none of them.
Bytes: each block reads and writes its chains' int8 spins once, their
energy and flip counter (4 bytes each), and reads the [N, K] int32
neighbour and coupling tables once; fields and coordinates are not counted.
"""

KERNELS = r"rejfree_sparse_kernel"


def floor(ctx):
    run, w = ctx["run"], ctx["work"]
    N, K = run.arrays["N"], run.arrays["K"]
    B = int(run.traffic["chains"])
    if w.get("moves") is None:
        return None
    ops = (K + 3) * w["moves"]
    nbytes = ctx["blocks"] * (2 * B * N + 16 * B + 8 * N * K)
    return {"ops": ops, "bytes": nbytes}
