"""Work floor of the single-site Metropolis kernel (csrc/site.cu: the
resident and global moves and the per-launch cut) over the window.

Operations: each attempted flip needs at least a random draw, the energy
change of its site (one product) and the test (one comparison): 3; each
applied flip at least its spin, its energy and the K neighbours' fields
(one add each; an implementation that recomputes a site's field instead
pays K at every attempt, which is more, since no more flips are applied
than attempted): K + 2. Philox rounds, site-schedule draws and the cut are
not counted.
Bytes: each block reads and writes its chains' int8 spins once, their
energy and flip counter (4 bytes each), and reads the [N, K] int32
neighbour and coupling tables once. The resident fields are not counted: a
correct implementation can derive them from the spins.
"""

KERNELS = r"site_(resident|global|cut)_kernel"


def floor(ctx):
    run, w = ctx["run"], ctx["work"]
    N, K = run.arrays["N"], run.arrays["K"]
    B = int(run.traffic["chains"])
    if w.get("applied_flips") is None:
        return None
    ops = 3 * w["attempted_flips"] + (K + 2) * w["applied_flips"]
    nbytes = ctx["blocks"] * (2 * B * N + 16 * B + 8 * N * K)
    return {"ops": ops, "bytes": nbytes}
