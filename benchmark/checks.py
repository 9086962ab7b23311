"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference worked out again from the spins and the
benchmark's couplings.

A view is what one call of the entry point returned, as the entry adapter
gives it: `sigma` [B, N] spins, `E` [B] energies (the model's units, whole
numbers on these couplings), and where the entry has them `aux` [B, N]
resident fields, `series` [B, K] checkpoint energies, `accepted` [B]
applied flips (cumulative), `emin` / `sigma_min` (EO's best). The numbers
compared, each with its limit (0 unless the traffic file gives one):

* energy_gap, anneal_energy_gap: the largest |E - energy(sigma)| after the
  window's last block, and after the set-up's anneal;
* field_gap: the largest |aux - fields(sigma)| after the last block;
* series_gap: "final" mixes (a checkpoint at the call's last move): the
  largest |series[:, -1] - energy(sigma)|; "before_last_move" (BKL: the
  last checkpoint holds the energy before the move that crossed the
  target): the chains whose series[:, -1] - E is no 2 s_i h_i(sigma) of any
  site i, the change that undoing one flip would make;
* idle_chains: chains that the last block left without an applied flip
  (without a changed spin where the entry counts no flips);
* parity_breaks: chains whose spins differ from the block's input in more
  sites than the block flipped, or in a number of another parity (the
  flips are the change of `accepted`, or the block's moves where the
  traffic says `flips_every_move`);
* work_ratio_gap (mixes with `work_check`): |ln R|, R = the last
  block's applied flips over those a sound chain expects, `block`
  attempted iterations a chain times z/N averaged over time (references'
  `z`: N times a uniform proposal's acceptance). work_check "time": the
  block's input and output spins are states at fixed times (Metropolis),
  so the average is their mean z. "jump" (BKL): they are the states just
  after the move that crossed the target; the state before it, at the
  target, is the time sample, and differs from them in the one site i
  whose flip back changes E by d = series[:, -1] - E. Given the output
  spins, each candidate site (2 s_i h_i = d) was that one with odds
  proportional to 1 / z of the spins with i flipped back (the candidates
  share the energy and the move's weight), so the time sample's z is
  estimated by the candidates' count over the sum of their 1 / z;
* emin_gap, emin_above: EO's best energy against energy(sigma_min), and
  the chains whose best lies above the block's first or last energy;
* anneal_idle: chains whose spins the set-up's anneal left as drawn;
* work_z (mixes with work_check "replay", whose route counts no applied
  flips, or a flip at every move): the reference's own plain sampler
  (references/<control>.py, exact energies) replays a block from the
  program's input spins of that block, and each chain's program output is
  set beside the replay's: its energy, its Hamming distance from the
  input and, for EO, its best energy. work_z is the largest |t| of the
  paired differences' means over the chains (mean over standard error),
  for the warm block, which starts from the set-up's short anneal where
  the state still relaxes fast, and for the window's last block. A block
  that does less work than it reports relaxes and decorrelates less than
  the replay.
"""

from __future__ import annotations

import math

import torch


def _i64(t: torch.Tensor) -> torch.Tensor:
    """Whole-number energies as int64; None where one is not whole."""
    if t.dtype.is_floating_point:
        r = torch.round(t.double())
        if bool((r != t.double()).any()):
            return None
        return r.long()
    return t.long()


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the chains, inf where a holds a fractional
    value."""
    ai = _i64(a)
    if ai is None:
        return math.inf
    return float((ai - b.long()).abs().max()) if ai.numel() else 0.0


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a != b).sum(1)


def compare(ref, tab, traffic: dict, *, sigma0, anneal: dict, first: dict,
            last: dict) -> dict:
    """{name: value} of every number compared (module docstring): `ref`
    the configuration's reference module and `tab` its tables, sigma0 the
    drawn spins, `anneal` the set-up's view, `first` / `last` the views
    before and after the window's last block."""
    out = {}
    E_ref = ref.energy(tab, last["sigma"])
    out["energy_gap"] = _gap(last["E"], E_ref)
    out["anneal_energy_gap"] = _gap(anneal["E"],
                                    ref.energy(tab, anneal["sigma"]))
    out["anneal_idle"] = int((hamming(sigma0, anneal["sigma"]) == 0).sum())
    if last.get("aux") is not None:
        out["field_gap"] = _gap(last["aux"], ref.fields(tab, last["sigma"]))
    mode = traffic.get("series_last")
    if mode == "final":
        out["series_gap"] = _gap(last["series"][:, -1], E_ref)
    elif mode == "before_last_move":
        d = _i64(last["series"][:, -1])
        if d is None:
            out["series_gap"] = last["series"].shape[0]
        else:
            # undoing the last flip, of site i, changes E by
            # 2 s_i h_i(sigma) = E_before - E = d
            d = d - _i64(last["E"])
            ok = (ref.delta(tab, last["sigma"]) == d[:, None]).any(1)
            out["series_gap"] = int((~ok).sum())
    ham = hamming(first["sigma"], last["sigma"])
    if last.get("accepted") is not None:
        flips = (last["accepted"].long() - first["accepted"].long())
        out["idle_chains"] = int((flips == 0).sum())
    else:
        flips = None
        out["idle_chains"] = int((ham == 0).sum())
    moves = flips
    if moves is None and traffic.get("flips_every_move"):
        moves = torch.full_like(ham, int(traffic["block"]))
    if moves is not None:
        out["parity_breaks"] = int(((ham > moves)
                                    | ((moves - ham) % 2 != 0)).sum())
    kind = traffic.get("work_check")
    if kind in ("time", "jump"):
        beta = float(traffic["beta"])
        views = (first, last)
        if kind == "time":
            zbar = float(torch.cat([ref.z(tab, v["sigma"], beta)
                                    for v in views]).mean())
        else:
            zbar = float(torch.cat([_z_before(ref, tab, v, beta)
                                    for v in views]).mean())
        expect = float(traffic["block"]) * flips.numel() * zbar / tab.N
        got = float(flips.sum())
        out["work_ratio_gap"] = (abs(math.log(got / expect))
                                 if got > 0 and expect > 0 else math.inf)
    if last.get("emin") is not None:
        out["emin_gap"] = _gap(last["emin"],
                               ref.energy(tab, last["sigma_min"]))
        lo = torch.minimum(first["E"].double(), last["E"].double())
        out["emin_above"] = int((last["emin"].double() > lo).sum())
    return out


def _z_before(ref, tab, view, beta) -> torch.Tensor:
    """[B] estimates of z of the spins before the last move of `view`
    (work_check "jump"); nan where no site is a candidate."""
    d = _i64(view["series"][:, -1]) - _i64(view["E"])
    cand = ref.delta(tab, view["sigma"]) == d[:, None]
    inv = (cand / ref.z_flipped(tab, view["sigma"], beta)).sum(1)
    return cand.sum(1) / inv


def t_stat(d: torch.Tensor) -> float:
    """|mean / standard error| of the paired differences d; 0 where all
    are 0, inf where they agree but are not 0."""
    d = d.double()
    mean = float(d.mean())
    se = float(d.std()) / math.sqrt(d.numel()) if d.numel() > 1 else 0.0
    if se == 0.0:
        return 0.0 if mean == 0.0 else math.inf
    return abs(mean) / se


def replay(ctl, ref, tab, run, pairs) -> float:
    """work_z (module docstring): `ctl` the configuration's plain samplers,
    `pairs` the (input view, output view) of each block replayed."""
    z = 0.0
    for k, (before, after) in enumerate(pairs):
        st = ctl.from_view(run, ref, tab, before, dtype=torch.int64)
        st["gen"].manual_seed(run.seed + 1 + k)
        _, again = ctl.block(run, ref, tab, st)
        stats = [lambda v: ref.energy(tab, v["sigma"]),
                 lambda v: hamming(before["sigma"], v["sigma"])]
        if after.get("sigma_min") is not None:
            stats.append(lambda v: ref.energy(tab, v["sigma_min"]))
        for f in stats:
            z = max(z, t_stat(f(after).long() - f(again).long()))
    return z


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): every value at or under its
    limit (0 where `limits` names none)."""
    rows = [[k, v, float(limits.get(k, 0))] for k, v in values.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
