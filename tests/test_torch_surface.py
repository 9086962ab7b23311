"""The port's public surface against the JAX package's: every exported name,
every exported callable's parameters and defaults, every `Graph*` builder
built from the same arguments and seed on both sides (same N, same energies
on seeded spins), and every builder driven through the five samplers on the
CPU with the running energy held to energy(sigma).

The differences by design are listed in SIGNATURE_DIFFERENCES (one line
each, also in ROADMAP.md queue 3). No builder and sampler pair is
refused: all 325 run."""

import ast
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrrmc_tpu as rt
import rrrmc_tpu_torch as pt
from rrrmc_tpu.models import replicas as jax_replicas
from rrrmc_tpu_torch.models import replicas as port_replicas

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: names of rrrmc_tpu/__init__.py the port does not carry (ROADMAP "Not to
#: port": JAX pytree registration)
NOT_PORTED = {"pytree", "static"}


def _exported(path: Path) -> list:
    """The names rrrmc_tpu/__init__.py imports, in order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name for a in node.names]
    return names


#: every public name of the JAX package but NOT_PORTED
JAX_NAMES = [n for n in _exported(ROOT / "rrrmc_tpu" / "__init__.py")
             if n not in NOT_PORTED]

#: parameters that differ by design, (callable, parameter) -> reason, one
#: line each (ROADMAP.md queue 3 lists them too). The port's only other
#: extra parameter is `device=`.
SIGNATURE_DIFFERENCES = {
    ("random_spins", "key"): "a JAX PRNG key; the port draws from `generator`",
    ("random_spins", "batch"): "the port makes a [batch, n] batch at once",
    ("random_spins", "generator"): "a torch.Generator in place of the key",
    ("MCState", "key"): "a JAX PRNG key; the port's state holds `generator`",
    ("MCState", "generator"): "host-side draws that advance in place",
    ("MCState", "chain0"): "global id of chain 0, keying a shard's streams",
    ("FullyConnected", "mm_bf16"): "TPU MXU precision flag: no counterpart",
    ("GraphRE", "N"): "dataclass field with no default: no empty star term",
    ("GraphRE", "Nk"): "dataclass field with no default, as N",
    ("GraphRE", "Mr"): "dataclass field with no default, as N",
    ("GraphTLE", "N"): "dataclass field with no default, as GraphRE's",
    ("GraphTLE", "Nk"): "dataclass field with no default, as N",
    ("GraphTLE", "Mr"): "dataclass field with no default, as N",
    ("Replicated", "N"): "dataclass field with no default, as GraphRE's",
    ("Replicated", "Nk"): "dataclass field with no default, as N",
    ("Replicated", "n_slots"): "dataclass field with no default, as N",
    ("Scaled", "N"): "dataclass field with no default, as GraphRE's",
    ("standardMC", "backend"): "default 'torch', the JAX 'xla' renamed",
    ("rrrMC", "staged_thr"): "the TPU kernel's staged-z' threshold",
    ("rrrMC", "staged_thr_fact"): "the TPU kernel's staged-z' threshold",
    ("rrrMC", "block_chains"): "the TPU chain block: one CUDA block a chain",
    ("rrrMC", "chunk_moves"): "moves a race launch, as bklMC's and wtmMC's",
    ("bklMC", "chunk_moves"): "default 1024 moves a launch, the TPU's 512",
    ("bklMC", "block_chains"): "the TPU chain block: one CUDA block a chain",
    ("wtmMC", "chunk_moves"): "default 1024 moves a launch, the TPU's 512",
    ("wtmMC", "block_chains"): "the TPU chain block: one CUDA block a chain",
    ("init_state", "seed"): "defaults to DEFAULT_SEED, as the samplers' do",
    ("sweep_kernel", "masks"): "JAX colour masks; the port's `prep` (its "
                               "prepare(model)) holds them",
    ("sweep_kernel", "prep"): "what sweep_kernel.prepare(model) built",
}


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _callables():
    out = []
    for n in JAX_NAMES:
        f = getattr(rt, n)
        if callable(f) and _params(f) is not None:
            out.append(n)
    return out


@pytest.mark.parametrize("name", JAX_NAMES)
def test_name_is_exported(name):
    assert hasattr(pt, name), f"rrrmc_tpu_torch lacks {name}"


@pytest.mark.parametrize("name", _callables())
def test_signature_matches_jax(name):
    """Each parameter of the JAX callable exists in the port's, with the
    same kind of default; the port's extra parameters are device= and the
    listed differences."""
    pj, pp = _params(getattr(rt, name)), _params(getattr(pt, name))
    assert pp is not None, name
    for p, par in pj.items():
        if (name, p) in SIGNATURE_DIFFERENCES:
            continue
        assert p in pp, f"{name}: the port lacks parameter {p}"
        dj, dp = par.default, pp[p].default
        if dj is inspect.Parameter.empty or isinstance(dj, (jnp.ndarray,
                                                            np.ndarray)):
            assert (dp is inspect.Parameter.empty) == (
                dj is inspect.Parameter.empty), f"{name}.{p}"
        else:
            assert dp == dj, f"{name}.{p}: {dp!r} != {dj!r}"
    extra = set(pp) - set(pj) - {"device"}
    extra -= {p for (n, p) in SIGNATURE_DIFFERENCES if n == name}
    assert not extra, f"{name}: undocumented extra parameters {extra}"


# ---------------------------------------------------------------------------
# the 65 exported builders, each at a small size
# ---------------------------------------------------------------------------

def _ea_file(tmp):
    L = 3
    rng = np.random.default_rng(4)
    lines = ["type: test", f"size: {L}", "name: t"]
    for x in range(L * L):
        r, c = divmod(x, L)
        for y in (r * L + (c + 1) % L, ((r + 1) % L) * L + c):
            lines.append(f"{x + 1} {y + 1} {rng.normal():.6f}")
    path = tmp / "ea.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _dev(m):
    return {"device": "cpu"} if m is pt else {}


def _fk(m, M=3, gamma=2.0, beta=1.0):
    if m is pt:
        return torch.tensor(port_replicas._fk_table(M, gamma, beta),
                            dtype=torch.float32)
    return jnp.asarray(jax_replicas._fk_table(M, gamma, beta))


def _tle_neighb(m):
    tbl = np.array([[1, 5, 6], [0, 2, 6], [1, 3, 6], [2, 4, 6], [3, 5, 6],
                    [4, 0, 6]], dtype=np.int32)
    return torch.from_numpy(tbl) if m is pt else jnp.asarray(tbl)


FIELDS = np.linspace(-1.0, 1.0, 6)

#: name -> build(module, tmp_path): the same arguments and seed on both
#: sides (device="cpu" for the port)
BUILDERS = {
    "GraphEA": lambda m, t: m.GraphEA(3, 2, (-1, 1), seed=3, **_dev(m)),
    "GraphEANormal": lambda m, t: m.GraphEANormal(3, 2, seed=5, **_dev(m)),
    "GraphEANormalDiscretized": lambda m, t: m.GraphEANormalDiscretized(
        3, 2, (-1, 1), seed=8, **_dev(m)),
    "GraphRRG": lambda m, t: m.GraphRRG(8, 3, (-1, 1), seed=7, **_dev(m)),
    "GraphRRGNormal": lambda m, t: m.GraphRRGNormal(8, 3, seed=9, **_dev(m)),
    "GraphRRGNormalDiscretized": lambda m, t: m.GraphRRGNormalDiscretized(
        8, 3, (-1, 1), seed=2, **_dev(m)),
    "GraphIsing1D": lambda m, t: m.GraphIsing1D(8, **_dev(m)),
    "GraphFields": lambda m, t: m.GraphFields(8, (0.5, 1.5), seed=11,
                                              **_dev(m)),
    "GraphFieldsNormalDiscretized": lambda m, t: (
        m.GraphFieldsNormalDiscretized(8, (-1, 1), seed=4, **_dev(m))),
    "GraphEmpty": lambda m, t: m.GraphEmpty(8, **_dev(m)),
    "GraphTwoSpin": lambda m, t: m.GraphTwoSpin(**_dev(m)),
    "GraphThreeSpin": lambda m, t: m.GraphThreeSpin(**_dev(m)),
    "GraphEAFromFile": lambda m, t: m.GraphEAFromFile(_ea_file(t), **_dev(m)),
    "GraphSK": lambda m, t: m.GraphSK(8, seed=4, **_dev(m)),
    "GraphSKNormal": lambda m, t: m.GraphSKNormal(8, seed=4, **_dev(m)),
    "GraphQT": lambda m, t: m.GraphQT(4, 3, 1.0, **_dev(m)),
    "GraphQuant": lambda m, t: m.GraphQuant(
        4, 3, 0.5, 1.0, m.GraphSK(4, seed=2, **_dev(m))),
    "GraphRE": lambda m, t: m.GraphRE(_fk(m), N=12, Nk=4, Mr=3, gamma=2.0,
                                      beta_p=1.0),
    "GraphRobustEnsemble": lambda m, t: m.GraphRobustEnsemble(
        4, 3, 2.0, 1.0, m.GraphSK(4, seed=2, **_dev(m))),
    "GraphLE": lambda m, t: m.GraphLE(4, 3, 0.5, **_dev(m)),
    "GraphLocalEntropy": lambda m, t: m.GraphLocalEntropy(
        6, 3, 0.5, 1.0, m.GraphRRG(6, 3, (-1, 1), seed=1, **_dev(m))),
    "GraphTLE": lambda m, t: m.GraphTLE(_tle_neighb(m), N=24, Nk=6, Mr=3,
                                        gammaT=0.5, lambdaT=0.3, max_deg=3),
    "GraphTopologicalLocalEntropy": lambda m, t: (
        m.GraphTopologicalLocalEntropy(
            6, 3, 0.5, 0.3, 1.0, m.GraphRRG(6, 3, (-1, 1), seed=1,
                                            **_dev(m)))),
    "GraphAF": lambda m, t: m.GraphAF(FIELDS, **_dev(m)),
    "GraphAddFields": lambda m, t: m.GraphAddFields(
        FIELDS, m.GraphRRG(6, 3, (-1, 1), seed=1, **_dev(m))),
    "GraphAddSubFields": lambda m, t: m.GraphAddSubFields(
        FIELDS, m.GraphRRG(6, 3, (-1, 1), seed=1, **_dev(m))),
    "GraphQ0T": lambda m, t: m.GraphQ0T(4, 3, 0.5, 2.0, **_dev(m)),
    "GraphQSKT": lambda m, t: m.GraphQSKT(4, 3, 0.7, 1.0, seed=2, **_dev(m)),
    "GraphQSKNormalT": lambda m, t: m.GraphQSKNormalT(4, 3, 0.7, 1.0, seed=2,
                                                      **_dev(m)),
    "GraphQEAT": lambda m, t: m.GraphQEAT(3, 2, 3, 0.5, 2.0, seed=3,
                                          **_dev(m)),
    "Graph0RE": lambda m, t: m.Graph0RE(4, 3, 1.0, 1.0, **_dev(m)),
    "GraphSKRE": lambda m, t: m.GraphSKRE(4, 3, 2.0, 1.0, seed=2, **_dev(m)),
    "GraphEARE": lambda m, t: m.GraphEARE(3, 2, 3, 1.5, 0.7, seed=3,
                                          **_dev(m)),
    "Graph0LE": lambda m, t: m.Graph0LE(4, 3, 0.5, 2.0, **_dev(m)),
    "GraphSKLE": lambda m, t: m.GraphSKLE(4, 3, 0.5, 2.0, seed=2, **_dev(m)),
    "GraphEALE": lambda m, t: m.GraphEALE(3, 2, 3, 0.5, 2.0, seed=3,
                                          **_dev(m)),
    "Graph0TLE": lambda m, t: m.Graph0TLE(4, 3, 0.5, 0.3, 2.0, **_dev(m)),
    "GraphSKTLE": lambda m, t: m.GraphSKTLE(4, 3, 0.5, 0.3, 2.0, seed=2,
                                            **_dev(m)),
    "GraphEATLE": lambda m, t: m.GraphEATLE(3, 2, 3, 0.5, 0.3, 2.0, seed=3,
                                            **_dev(m)),
    "GraphPSpin3": lambda m, t: m.GraphPSpin3(6, 2, seed=1, **_dev(m)),
    "GraphSAT": lambda m, t: m.GraphSAT(8, 3, 2.0, seed=9, **_dev(m)),
    "GraphSATRE": lambda m, t: m.GraphSATRE(8, 3, 2.0, 3, 1.0, 1.0, seed=9,
                                            **_dev(m)),
    "GraphSATLE": lambda m, t: m.GraphSATLE(8, 3, 2.0, 3, 1.0, 1.0, seed=9,
                                            **_dev(m)),
    "GraphSATTLE": lambda m, t: m.GraphSATTLE(8, 3, 2.0, 3, 1.0, 0.3, 1.0,
                                              seed=9, **_dev(m)),
    "GraphPercStep": lambda m, t: m.GraphPercStep(9, 5, seed=1, **_dev(m)),
    "GraphPercLinear": lambda m, t: m.GraphPercLinear(9, 5, seed=1,
                                                      **_dev(m)),
    "GraphPercXEntr": lambda m, t: m.GraphPercXEntr(9, 5, 1.0, seed=1,
                                                    **_dev(m)),
    "GraphQPercStepT": lambda m, t: m.GraphQPercStepT(9, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphQPercLinearT": lambda m, t: m.GraphQPercLinearT(9, 5, 3, 1.0, 1.0,
                                                          seed=1, **_dev(m)),
    "GraphPercStepRE": lambda m, t: m.GraphPercStepRE(9, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphPercLinearRE": lambda m, t: m.GraphPercLinearRE(9, 5, 3, 1.0, 1.0,
                                                          seed=1, **_dev(m)),
    "GraphPercStepLE": lambda m, t: m.GraphPercStepLE(9, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphPercLinearLE": lambda m, t: m.GraphPercLinearLE(9, 5, 3, 1.0, 1.0,
                                                          seed=1, **_dev(m)),
    "GraphCommStep": lambda m, t: m.GraphCommStep(3, 3, 5, seed=1,
                                                  **_dev(m)),
    "GraphCommReLU": lambda m, t: m.GraphCommReLU(4, 2, 5, seed=1,
                                                  **_dev(m)),
    "GraphCommQu": lambda m, t: m.GraphCommQu(4, 2, 5, seed=1, **_dev(m)),
    "GraphQCommStepT": lambda m, t: m.GraphQCommStepT(3, 3, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphQCommReLUT": lambda m, t: m.GraphQCommReLUT(4, 2, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphQCommQuT": lambda m, t: m.GraphQCommQuT(4, 2, 5, 3, 1.0, 1.0,
                                                  seed=1, **_dev(m)),
    "GraphCommStepRE": lambda m, t: m.GraphCommStepRE(3, 3, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphCommReLURE": lambda m, t: m.GraphCommReLURE(4, 2, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphCommQuRE": lambda m, t: m.GraphCommQuRE(4, 2, 5, 3, 1.0, 1.0,
                                                  seed=1, **_dev(m)),
    "GraphCommStepLE": lambda m, t: m.GraphCommStepLE(3, 3, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphCommReLULE": lambda m, t: m.GraphCommReLULE(4, 2, 5, 3, 1.0, 1.0,
                                                      seed=1, **_dev(m)),
    "GraphCommQuLE": lambda m, t: m.GraphCommQuLE(4, 2, 5, 3, 1.0, 1.0,
                                                  seed=1, **_dev(m)),
}

#: the five samplers each builder is driven through: (sampler, call)
SAMPLERS = {
    "standardMC": lambda m: pt.standardMC(m, 1.0, 40, step=10, chains=4,
                                          seed=1, device="cpu"),
    "rrrMC": lambda m: pt.rrrMC(m, 1.0, 40, step=10, chains=4, seed=1,
                                device="cpu"),
    "bklMC": lambda m: pt.bklMC(m, 1.0, 40, step=10, chains=4, seed=1,
                                device="cpu"),
    "wtmMC": lambda m: pt.wtmMC(m, 1.0, 4, step=1.0, chains=4, seed=1,
                                device="cpu"),
    "extremal_opt": lambda m: pt.extremal_opt(m, 1.4, 20, chains=4, seed=1,
                                              device="cpu"),
}


def test_every_graph_builder_is_listed():
    assert sorted(BUILDERS) == sorted(n for n in JAX_NAMES
                                      if n.startswith("Graph"))
    assert len(BUILDERS) == 65


def _close(got, want, integer: bool, rtol: float):
    """Exact for integer energies, else within rtol * max(1, |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        tol = rtol * np.maximum(1.0, np.abs(want))
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_matches_jax(name, tmp_path):
    """Same N, and the same energies on 8 seeded spin configurations:
    exact for integer couplings, within 1e-5 relative for float ones."""
    jm, pm = BUILDERS[name](rt, tmp_path), BUILDERS[name](pt, tmp_path)
    assert pm.N == jm.N
    s = np.random.default_rng(0).choice(np.array([-1, 1], np.int8),
                                        (8, pm.N))
    want = np.asarray(jax.vmap(jm.energy)(jnp.asarray(s)))
    got = pm.energy(torch.from_numpy(s))
    _close(got.numpy(), want, not got.dtype.is_floating_point, 1e-5)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_through_sampler(name, sampler, tmp_path):
    """4 chains, a few moves on the CPU: the running energy equals
    energy(sigma), exactly in int32, within 1e-4 max(1, |E|) in float32;
    for EO, Emin equals the energy of sigma_min. Every pair runs: none of
    the 325 is refused, on either side."""
    pm = BUILDERS[name](pt, tmp_path)
    out = SAMPLERS[sampler](pm)
    if sampler == "extremal_opt":
        got, sig = out.Emin, out.sigma_min
        want = pm.to_physical(pm.energy(sig))
        integer = not pm.energy(sig).dtype.is_floating_point
        assert out.E.shape == (4,) and bool(torch.isfinite(out.E).all())
    else:
        Es, st = out
        got, want = st.E, pm.energy(st.sigma)
        integer = not want.dtype.is_floating_point
        assert Es.shape[0] == 4 and bool(torch.isfinite(Es).all())
        assert got.dtype == want.dtype
    _close(got.numpy(), want.numpy(), integer, 1e-4)
