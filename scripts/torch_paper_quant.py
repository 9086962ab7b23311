"""The reference paper's quantum and robust-ensemble experiments on the
PyTorch port (the JAX package's scripts/paper_quant.py; RRRMC.jl
scripts/scripts.jl test_QIsing and test_REIsing): an equal-wallclock
comparison of Metropolis and rrrMC on

  * GraphQSKT(N=1024, M=16, Gamma=0.3, beta=2.0, seed=8370274), tracking
    Qenergy, and
  * GraphSKRE(N=1024, M=5, gamma, beta=0.4, seed=8370275), tracking the
    mean replica E/N and the composite E/N, for gamma in {2, 3, 4, 5}.

Each runs four engines: Metropolis on the replica sweep kernel
(sweepMC_quant / sweepMC_replica) and rrrMC on the replica race kernel,
1024 chains, and both samplers on the generic torch path (the JAX file's
XLA engines) at 64 chains. The headline is the wall-clock to a target
level: the first recorded wall second from which the chain-mean
observable stays at or below the target to the budget's end (a sustained
crossing), the target being the level the generic rrr engine ends at.

    python scripts/torch_paper_quant.py [t_limit_s] [chains] [which]
        [--out FILE] [--device cpu]

which in {qising, reising, both}. The default output is
chiprun_out/torch_paper_quant_results.json; a partial run merges into
that file. The script never writes the root paper_quant_results.json. It
runs on the card and exits non-zero without one unless given --device
cpu. A script in scripts/ needs the repo on PYTHONPATH.

Keys are the JAX file's, with the XLA engines renamed: QIsing's met_xla,
rrr_xla, chains_xla, met_factor_xla and speedup_vs_rrr_xla become
met_torch, rrr_torch, chains_torch, met_factor_torch and
speedup_vs_rrr_torch (the keys of wall_to_target_s and wall_to_deep_s
alike); REIsing's chains_xla becomes chains_torch (its generic engines
were already "met" and "rrr"). The file also holds "device", the card's
name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import rrrmc_tpu_torch as rt
from rrrmc_tpu_torch.bench import card_line, script_device

DEFAULT_OUT = "chiprun_out/torch_paper_quant_results.json"


def sync(x: torch.Tensor):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def qenergy_batch(model, sigma: torch.Tensor) -> torch.Tensor:
    """[B] Qenergy of a [B, N] batch of composites."""
    return model.Qenergy(sigma)


def re_obs_batch(model, sigma: torch.Tensor) -> torch.Tensor:
    """[B, 2]: mean replica energy per spin, composite energy per spin."""
    return torch.stack([model.REenergies(sigma).mean(dim=1) / model.Nk,
                        model.to_physical(model.energy(sigma)) / model.N],
                       dim=1)


# ---------------------------------------------------------------------------
# engines: uniform (n, state) -> (n_done, state) steppers
# ---------------------------------------------------------------------------

def eng_met_kernel(model, beta, chains, seed, device):
    """Metropolis sweeps on the replica sweep kernel (Quant or RE)."""
    def run(n, state):
        sweeps = max(1, int(round(n / model.N)))
        kw = ({"state": state} if state is not None
              else {"seed": seed, "chains": chains, "device": device})
        _, st = rt.sweepMC_quant(model, beta, sweeps, step=sweeps, **kw)
        return sweeps * model.N, st
    return run


def eng_rrr_kernel(model, beta, chains, seed, device):
    def run(n, state):
        kw = ({"state": state} if state is not None
              else {"seed": seed, "chains": chains, "device": device})
        _, st = rt.rrrMC(model, beta, int(n), step=int(n), backend="kernel",
                         **kw)
        return int(n), st
    return run


def eng_torch(sampler, model, beta, chains, seed, device):
    """A sampler on the generic torch path."""
    def run(n, state):
        kw = ({"state": state} if state is not None
              else {"seed": seed, "chains": chains, "device": device})
        _, st = sampler(model, beta, int(n), step=int(n), backend="torch",
                        **kw)
        return int(n), st
    return run


def run_engine(run, model, obs_batch, *, t_limit, probe_n,
               seg_target_s=3.0, max_segments=200):
    """Drive an engine in state-threaded segments for ~t_limit seconds of
    measured sampler wall-clock (observable evaluation excluded), recording
    the chain-mean observable trajectory against wall-clock and nominal
    iterations."""
    # probe: calibrate the segment size
    n_done, st = run(probe_n, None)
    sync(st.E)
    t0 = time.perf_counter()
    n_done, st = run(probe_n, st)
    sync(st.E)
    dt = max(time.perf_counter() - t0, 1e-3)
    n_seg = int(probe_n * max(1.0, min(seg_target_s / dt, 10_000.0)))
    traj, wall, iters = [], 0.0, 0
    st = None
    for _ in range(max_segments):
        t0 = time.perf_counter()
        n_done, st = run(n_seg, st)
        sync(st.E)
        wall += time.perf_counter() - t0
        iters += n_done
        q = obs_batch(model, st.sigma).double().cpu().numpy()
        traj.append({"iters": iters, "wall_s": wall,
                     "obs_mean": q.mean(axis=0).tolist(),
                     "obs_sem": (q.std(axis=0)
                                 / np.sqrt(q.shape[0])).tolist()})
        if wall >= t_limit:
            break
    return {"rate_iters_per_s": iters / wall, "iters": iters,
            "wall_s": wall, "traj": traj}


def wall_to_target(res, target, idx=0):
    """Earliest recorded wall second from which the chain-mean observable
    (component idx) stays <= target until the budget end (SUSTAINED
    crossing; first-touch is polluted by the quantum-energy estimator's
    transient undershoot from random starts). None if never sustained."""
    best = None
    for p in reversed(res["traj"]):
        o = p["obs_mean"]
        v = o[idx] if isinstance(o, list) else o
        if v <= target:
            best = p["wall_s"]
        else:
            break
    return best


def _last(res):
    o = res["traj"][-1]["obs_mean"]
    return o[0] if isinstance(o, list) else o


def qising(t_limit, chains_kernel, seed, *, device="cuda", Nk=1024, M=16,
           chains_torch=64, torch_limit=60.0, seg_target_s=3.0,
           probe_torch=400, log=print):
    X = rt.GraphQSKT(Nk, M, 0.3, 2.0, seed=8370274, device=device)
    obs = qenergy_batch
    out = {"model": f"QSKT N={Nk} M={M} beta=2 Gamma=0.3",
           "chains_kernel": chains_kernel, "chains_torch": chains_torch}
    kw = dict(t_limit=t_limit, seg_target_s=seg_target_s)
    out["met_kernel"] = run_engine(
        eng_met_kernel(X, 2.0, chains_kernel, seed, device), X, obs,
        probe_n=8 * X.N, **kw)
    out["rrr_kernel"] = run_engine(
        eng_rrr_kernel(X, 2.0, chains_kernel, seed + 1, device), X, obs,
        probe_n=2_000, **kw)
    kw["t_limit"] = min(t_limit, torch_limit)
    out["met_torch"] = run_engine(
        eng_torch(rt.standardMC, X, 2.0, chains_torch, seed + 2, device), X,
        obs, probe_n=probe_torch, **kw)
    out["rrr_torch"] = run_engine(
        eng_torch(rt.rrrMC, X, 2.0, chains_torch, seed + 3, device), X, obs,
        probe_n=probe_torch, **kw)
    engines = ("met_kernel", "rrr_kernel", "met_torch", "rrr_torch")
    out["met_factor_kernel"] = (out["met_kernel"]["rate_iters_per_s"]
                                / out["rrr_kernel"]["rate_iters_per_s"])
    out["met_factor_torch"] = (out["met_torch"]["rate_iters_per_s"]
                               / out["rrr_torch"]["rate_iters_per_s"])
    out["met_factor_reference_cpu"] = 15.74          # scripts.jl:778
    # headline: wall-clock to the Qenergy level the generic rrr engine
    # ends at
    target = _last(out["rrr_torch"])
    out["target_Qenergy"] = target
    out["wall_to_target_s"] = {k: wall_to_target(out[k], target)
                               for k in engines}
    wx = out["wall_to_target_s"]["rrr_torch"] or out["rrr_torch"]["wall_s"]
    wk = {k: v for k, v in out["wall_to_target_s"].items()
          if k.endswith("kernel") and v}
    if wk:
        out["speedup_vs_rrr_torch"] = {k: wx / v for k, v in wk.items()}
    # deep target: the deepest level the kernel Metropolis engine reaches;
    # None marks an engine that never gets there within its budget
    deep = _last(out["met_kernel"])
    out["target_deep_Qenergy"] = deep
    out["wall_to_deep_s"] = {k: wall_to_target(out[k], deep)
                             for k in engines}
    log(json.dumps({k: out[k] for k in
                    ("met_factor_kernel", "met_factor_torch",
                     "target_Qenergy", "wall_to_target_s")}))
    return out


def reising(t_limit, chains_kernel, seed, *, device="cuda", Nk=1024, M=5,
            gammas=(2.0, 3.0, 4.0, 5.0), chains_torch=64, torch_limit=45.0,
            seg_target_s=3.0, probe_torch=400, log=print):
    """REIsing across the reference's gamma grid (scripts.jl:878), both
    kernel engines and both generic engines."""
    ref = {2.0: 20.8, 3.0: 24.6, 4.0: 13.9, 5.0: 6.4}
    out = {"model": f"SKRE N={Nk} M={M} beta=0.4",
           "chains_kernel": chains_kernel, "chains_torch": chains_torch,
           "gammas": {}}
    for gamma in gammas:
        X = rt.GraphSKRE(Nk, M, gamma, 0.4, seed=8370275, device=device)
        kw = dict(t_limit=t_limit, seg_target_s=seg_target_s)
        row = {}
        row["met_kernel"] = run_engine(
            eng_met_kernel(X, 0.4, chains_kernel, seed, device), X,
            re_obs_batch, probe_n=8 * X.N, **kw)
        row["rrr_kernel"] = run_engine(
            eng_rrr_kernel(X, 0.4, chains_kernel, seed + 1, device), X,
            re_obs_batch, probe_n=2_000, **kw)
        kw["t_limit"] = min(t_limit, torch_limit)
        row["met"] = run_engine(
            eng_torch(rt.standardMC, X, 0.4, chains_torch, seed + 2,
                      device), X, re_obs_batch, probe_n=probe_torch, **kw)
        row["rrr"] = run_engine(
            eng_torch(rt.rrrMC, X, 0.4, chains_torch, seed + 3, device), X,
            re_obs_batch, probe_n=probe_torch, **kw)
        row["met_factor_kernel"] = (row["met_kernel"]["rate_iters_per_s"]
                                    / row["rrr_kernel"]["rate_iters_per_s"])
        row["met_factor_measured"] = (row["met"]["rate_iters_per_s"]
                                      / row["rrr"]["rate_iters_per_s"])
        row["met_factor_reference_cpu"] = ref.get(gamma)
        # headline: wall-clock to the replica-energy level the generic rrr
        # engine ends at (component 0, the mean replica E/N)
        target = _last(row["rrr"])
        row["target_repl_E"] = target
        row["wall_to_target_s"] = {
            k: wall_to_target(row[k], target)
            for k in ("met_kernel", "rrr_kernel", "met", "rrr")}
        log(json.dumps({"gamma": gamma,
                        "met_factor_kernel": row["met_factor_kernel"],
                        "met_factor_torch": row["met_factor_measured"],
                        "ref": ref.get(gamma),
                        "wall_to_target_s": row["wall_to_target_s"]}))
        out["gammas"][str(gamma)] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("t_limit", nargs="?", type=float, default=90.0)
    ap.add_argument("chains", nargs="?", type=int, default=1024)
    ap.add_argument("which", nargs="?", default="both",
                    choices=("qising", "reising", "both"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = script_device(args.device, "torch_paper_quant")
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    out = {"t_limit_s": args.t_limit}
    if os.path.exists(args.out):      # partial runs merge
        with open(args.out) as f:
            out = {**json.load(f), "t_limit_s": args.t_limit}
    out["device"] = card
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.which in ("qising", "both"):
        out["QIsing"] = qising(args.t_limit, args.chains, 654789,
                               device=device, log=log)
    if args.which in ("reising", "both"):
        out["REIsing"] = reising(min(args.t_limit, 60.0), args.chains,
                                 654790, device=device, log=log)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
