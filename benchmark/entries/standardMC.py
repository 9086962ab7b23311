"""Entry adapter of `standardMC(backend="kernel")`: the single-site
Metropolis kernel (csrc/site.cu), one launch a checkpoint.

Traffic keys: beta, chains, block (moves a chain a block), step (moves a
checkpoint), anneal (moves of the set-up's anneal, one call).
"""

import rrrmc_tpu_torch as pt


def _view(st, Es):
    return {"sigma": st.sigma, "E": st.E, "aux": st.aux, "series": Es,
            "accepted": st.accepted}


def prepare(run, sigma0):
    t = run.traffic
    st = pt.init_state(run.model, int(t["chains"]), seed=run.seed, C0=sigma0,
                       device=run.device)
    n = int(t["anneal"])
    Es, st = pt.standardMC(run.model, float(t["beta"]), n, step=n, state=st,
                           backend="kernel")
    return st, _view(st, Es)


def block(run, st):
    t = run.traffic
    Es, st = pt.standardMC(run.model, float(t["beta"]), int(t["block"]),
                           step=int(t["step"]), state=st, backend="kernel")
    return st, _view(st, Es)


def work(run, blocks: int, flips: int) -> dict:
    """The window's work: attempted flips (moves x chains) and applied
    flips (the change of `accepted`)."""
    t = run.traffic
    return {"attempted_flips": blocks * int(t["block"]) * int(t["chains"]),
            "applied_flips": flips}
