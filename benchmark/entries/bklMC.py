"""Entry adapter of `bklMC(backend="kernel")`: rejection-free BKL on the
race kernel of the model's family (csrc/rejfree_sparse.cu for a sparse
Pairwise), in chunks of 1024 moves, one host sync a chunk.

Traffic keys: beta, chains, block (virtual iterations a chain a block),
step (iterations a checkpoint), anneal (iterations of the set-up's anneal,
one call).
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
    Es, st = pt.bklMC(run.model, float(t["beta"]), n, step=n, state=st,
                      backend="kernel")
    return st, _view(st, Es)


def block(run, st):
    t = run.traffic
    Es, st = pt.bklMC(run.model, float(t["beta"]), int(t["block"]),
                      step=int(t["step"]), state=st, backend="kernel")
    return st, _view(st, Es)


def work(run, blocks: int, flips: int) -> dict:
    """The window's work: virtual iterations (block x chains) and the
    applied moves (the change of `accepted`; one flip a move)."""
    t = run.traffic
    return {"iters": blocks * int(t["block"]) * int(t["chains"]),
            "moves": flips, "applied_flips": flips}
