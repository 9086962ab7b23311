"""Entry adapter of `extremal_opt(backend="kernel")`: tau-EO on the EO
kernel of the model's family (csrc/eo_sparse.cu for a sparse Pairwise or
an EA lattice), one launch a call. Each block continues from the last
block's spins and energies; its view carries the block's best energies and
configurations.

Traffic keys: tau, chains, block (moves a chain a block), anneal (moves of
the set-up's warm-up, one call).
"""

import dataclasses

import torch

import rrrmc_tpu_torch as pt


def _advance(run, st, moves: int):
    res = pt.extremal_opt(run.model, float(run.traffic["tau"]), moves,
                          state=st, backend="kernel")
    E = torch.round(res.E / run.model.scale).to(st.E.dtype)
    st = dataclasses.replace(st, sigma=res.sigma, E=E)
    return st, {"sigma": res.sigma, "E": res.E, "emin": res.Emin,
                "sigma_min": res.sigma_min}


def prepare(run, sigma0):
    t = run.traffic
    st = pt.init_state(run.model, int(t["chains"]), seed=run.seed, C0=sigma0,
                       device=run.device)
    return _advance(run, st, int(t["anneal"]))


def block(run, st):
    return _advance(run, st, int(run.traffic["block"]))


def work(run, blocks: int, flips) -> dict:
    """The window's work: moves x chains, a flip each."""
    t = run.traffic
    n = blocks * int(t["block"]) * int(t["chains"])
    return {"moves": n, "applied_flips": n}
