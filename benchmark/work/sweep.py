"""Work floor of the checkerboard sweep kernel (csrc/sweep.cu) over the
window.

Operations: each attempted flip needs at least a random draw, the energy
change of its site (one product) and the test (one comparison): 3. The
route counts no applied flips, so their field updates are not counted;
nor are Philox rounds or the fields' recomputation at the end of a call.
Bytes: each block reads and writes its chains' int8 spins once and their
int32 energy, and reads the [D, L^D] int32 couplings once.
"""

KERNELS = r"(?<![a-z_])sweep_kernel"


def floor(ctx):
    run, w = ctx["run"], ctx["work"]
    N, K = run.arrays["N"], run.arrays["K"]
    B = int(run.traffic["chains"])
    ops = 3 * w["attempted_flips"]
    nbytes = ctx["blocks"] * (2 * B * N + 8 * B + 4 * N * (K // 2))
    return {"ops": ops, "bytes": nbytes}
