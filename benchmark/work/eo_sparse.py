"""Work floor of the sparse tau-EO kernel (csrc/eo_sparse.cu on
eo_chain.cuh and eo_group.cuh) over the window.

Operations: every move flips one spin, which needs at least one random
draw (the rank's), the spin, its energy and the K neighbours' fields (one
add each): K + 3. Ranking the sites, the tie race and Philox rounds are
not counted.
Bytes: each block reads and writes its chains' int8 spins once, writes
their best spins once, reads and writes their energy and writes their best
energy and its move (4 bytes each), and reads the [N, K] int32 neighbour
and coupling tables once.
"""

KERNELS = r"eo_chain_kernel<[^>]*SparseFlip"


def floor(ctx):
    run, w = ctx["run"], ctx["work"]
    N, K = run.arrays["N"], run.arrays["K"]
    B = int(run.traffic["chains"])
    ops = (K + 3) * w["moves"]
    nbytes = ctx["blocks"] * (3 * B * N + 16 * B + 8 * N * K)
    return {"ops": ops, "bytes": nbytes}
