"""rrrmc_tpu_torch: the PyTorch + CUDA port of rrrmc_tpu, for NVIDIA Hopper.

Many-chain Monte Carlo for Ising spin models, batch-explicit: every model
method and sampler takes a [B, N] batch of chains, devices are explicit
(`device=`, CUDA when none is given: pass device="cpu" for the host), and
random draws come from explicit generators (a `torch.Generator` on the host
side, counter-based Philox inside the kernels). The single-site Metropolis,
the checkerboard sweep of EA lattices, the dense (SK) sweep, the
rejection-free race moves and the tau-EO moves (sparse, dense, and on the
PSpin3 and K-SAT hypergraphs) run on hand-written CUDA kernels (csrc/) for
a CUDA state and on their plain torch versions on the CPU. Names mirror the JAX package (rrrmc_tpu), which stays
the reference. This package never imports JAX.
"""

from .core.model import Model, random_spins
from .models.pairwise import (Pairwise, make_pairwise, infer_integer_scale,
                              enumerate_pair_classes)
from .models.lattice import LatticeEA, make_lattice_ea
from .models.dense import (FullyConnected, GraphSK, GraphSKNormal, densify,
                           make_fully_connected)
from .models.pspin import PSpin3, GraphPSpin3
from .models.sat import SATModel, GraphSAT, make_sat, export_cnf
from .models.graphs import (
    GraphEA, GraphEANormal, GraphEANormalDiscretized,
    GraphRRG, GraphRRGNormal, GraphRRGNormalDiscretized,
    GraphIsing1D, GraphFields, GraphFieldsNormalDiscretized,
    GraphEmpty, GraphTwoSpin, GraphThreeSpin,
    GraphEAFromFile, load_ea_instance,
)
from .samplers.metropolis import standardMC
from .samplers.sweep import sweepMC
from .samplers.dense_sweep import sweepMC_dense
from .samplers.rrr import rrrMC
from .samplers.bkl import bklMC
from .samplers.wtm import wtmMC
from .samplers.eo import EOResult, extremal_opt
from .samplers.common import (MCState, init_state, rebind, DEFAULT_SEED,
                              LAST_ROUTE)
from .convert import (pairwise_from_arrays, lattice_from_arrays,
                      fully_connected_from_arrays, pspin_from_arrays,
                      sat_from_arrays, state_from_arrays)
from . import observables
from . import analysis
from . import experiments

__version__ = "0.1.0"
