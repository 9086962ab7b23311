"""rrrmc_tpu_torch: the PyTorch + CUDA port of rrrmc_tpu, for NVIDIA Hopper.

Many-chain Monte Carlo for Ising spin models, batch-explicit: every model
method and sampler takes a [B, N] batch of chains, devices are explicit
(`device=`, CUDA when none is given: pass device="cpu" for the host), and
random draws come from explicit generators (a `torch.Generator` on the host
side, counter-based Philox inside the kernels). The single-site Metropolis,
the checkerboard sweep of EA lattices, the dense (SK) sweep, the
rejection-free race moves and the tau-EO moves (sparse, dense, and on the
PSpin3 and K-SAT hypergraphs and on the perceptrons), and the race moves
and sweeps of the replica composites (GraphQuant, GraphRobustEnsemble) run
on hand-written CUDA kernels (csrc/) for a CUDA state and on their plain
torch versions on the CPU. The other wrappers (local entropy, topological
local entropy, AddFields) and the committee machines run on the generic
torch paths, as they run on plain XLA in the JAX package; `flatten` merges
a pairwise wrapper stack into one Pairwise that the site, sparse race and
sparse EO kernels take. Parallel tempering runs its whole beta ladder as
one site-kernel launch a round (a beta per chain); `parallel.mesh` and
`parallel.distributed` shard chains, disorder and the ladder over devices
and torch.distributed ranks, bit for bit the unsharded run on the kernel
routes; `save_state` / `load_state` resume any state exactly. Names mirror
the JAX package (rrrmc_tpu), which stays the reference. This package never
imports JAX.
"""

from .core.model import Model, random_spins
from .models.pairwise import (Pairwise, make_pairwise, infer_integer_scale,
                              enumerate_pair_classes)
from .models.lattice import LatticeEA, make_lattice_ea
from .models.dense import (FullyConnected, GraphSK, GraphSKNormal, densify,
                           make_fully_connected)
from .models.pspin import PSpin3, GraphPSpin3
from .models.sat import SATModel, GraphSAT, make_sat, export_cnf
from .models.sat import GraphSATRE, GraphSATLE, GraphSATTLE
from .models.perceptron import (Perceptron, GraphPercStep, GraphPercLinear,
                                GraphPercXEntr, GraphQPercStepT,
                                GraphQPercLinearT, GraphPercStepRE,
                                GraphPercLinearRE, GraphPercStepLE,
                                GraphPercLinearLE)
from .models.committee import (
    Committee, GraphCommStep, GraphCommReLU, GraphCommQu,
    GraphQCommStepT, GraphQCommReLUT, GraphQCommQuT,
    GraphCommStepRE, GraphCommReLURE, GraphCommQuRE,
    GraphCommStepLE, GraphCommReLULE, GraphCommQuLE,
)
from .models.composite import Double, Mixed, mixed
from .models.replicas import (
    Replicated, GraphQT, four_K, transverse_mag, QuantModel, GraphQuant,
    GraphRE, REModel, GraphRobustEnsemble,
    GraphLE, GraphLocalEntropy, LEModel,
    GraphTLE, GraphTopologicalLocalEntropy, TLEModel,
    GraphAF, GraphAddFields, GraphAddSubFields, Scaled,
)
from .models.aliases import (GraphQ0T, GraphQSKT, GraphQSKNormalT, GraphQEAT,
                             Graph0RE, GraphSKRE, GraphEARE,
                             Graph0LE, GraphSKLE, GraphEALE,
                             Graph0TLE, GraphSKTLE, GraphEATLE)
from .models.flatten import flatten
from .models.graphs import (
    GraphEA, GraphEANormal, GraphEANormalDiscretized,
    GraphRRG, GraphRRGNormal, GraphRRGNormalDiscretized,
    GraphIsing1D, GraphFields, GraphFieldsNormalDiscretized,
    GraphEmpty, GraphTwoSpin, GraphThreeSpin,
    GraphEAFromFile, load_ea_instance,
)
from .samplers.metropolis import standardMC
from .samplers.sweep import sweepMC
from .samplers.dense_sweep import sweepMC_dense, sweepMC_quant, sweepMC_replica
from .samplers.rrr import rrrMC
from .samplers.bkl import bklMC
from .samplers.wtm import wtmMC
from .samplers.eo import EOResult, extremal_opt
from .samplers.common import (MCState, init_state, rebind, DEFAULT_SEED,
                              LAST_ROUTE)
from .convert import (pairwise_from_arrays, lattice_from_arrays,
                      fully_connected_from_arrays, pspin_from_arrays,
                      sat_from_arrays, perceptron_from_arrays,
                      replica_from_arrays, committee_from_arrays,
                      state_from_arrays, pt_state_from_arrays,
                      et_state_from_arrays)
from .parallel.tempering import (parallel_tempering, tempered_ensembles,
                                 energies_by_rank, sweep_kernel, PTState,
                                 ETState)
from . import observables
from . import analysis
from . import experiments
from .utils.checkpoint import save_state, load_state
from .utils import profiling

__version__ = "0.1.0"
