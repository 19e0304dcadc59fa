"""bflbm_tpu - fluctuating binary-fluid lattice-Boltzmann framework in JAX.

A JAX/XLA/Pallas rebuild of the capabilities of
MDProject/Binary-Fluctuating-Lattice-Boltzmann (AMReX + CUDA/MPI):
populations live as (19, X, Y, Z) arrays sharded over a
``jax.sharding.Mesh``, the collide-stream loop is one jitted step (a
Pallas/Triton kernel for the GPU, the plain jnp step as reference),
thermal noise is counter-based and decomposition-invariant, and the
on-device structure factors use gather-free split-re/im matmul DFTs
(``ops.rfft``; offline analysis on the host uses ``numpy.fft``).
"""

from . import config, lattice, state  # noqa: F401
from .config import LBMParams, RunConfig, preset, preset_names  # noqa: F401
from .state import SimState  # noqa: F401

__version__ = "0.1.0"
