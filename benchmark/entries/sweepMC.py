"""Entry adapter of `sweepMC(backend="kernel")`: on an even-L integer EA
lattice, the checkerboard kernel (csrc/sweep.cu), one launch a checkpoint,
then `init_aux` at the end of each call. The route counts no applied
flips (`accepted` stays as it was), so the view has none.

Traffic keys: beta, chains, block (sweeps a block), step (sweeps a
checkpoint), anneal (sweeps of the set-up's warm-up, one call).
"""

import rrrmc_tpu_torch as pt


def _view(st, Es):
    return {"sigma": st.sigma, "E": st.E, "aux": st.aux, "series": Es}


def prepare(run, sigma0):
    t = run.traffic
    st = pt.init_state(run.model, int(t["chains"]), seed=run.seed, C0=sigma0,
                       device=run.device)
    n = int(t["anneal"])
    Es, st = pt.sweepMC(run.model, float(t["beta"]), n, step=n, state=st,
                        backend="kernel")
    return st, _view(st, Es)


def block(run, st):
    t = run.traffic
    Es, st = pt.sweepMC(run.model, float(t["beta"]), int(t["block"]),
                        step=int(t["step"]), state=st, backend="kernel")
    return st, _view(st, Es)


def work(run, blocks: int, flips) -> dict:
    """The window's work: attempted flips (sweeps x N x chains)."""
    t = run.traffic
    return {"attempted_flips": blocks * int(t["block"]) * run.arrays["N"]
            * int(t["chains"]), "applied_flips": None}
