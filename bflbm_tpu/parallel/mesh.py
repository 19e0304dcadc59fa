"""Device mesh construction for spatial domain decomposition.

The reference's only parallel strategy is spatial data parallelism:
``BoxArray.maxSize`` + ``DistributionMapping`` splits the box over MPI
ranks (main_run_job.cpp:140-143, SURVEY.md §2.6).  The equivalent here
is a ``jax.sharding.Mesh`` whose axes partition the spatial axes of the
(19, X, Y, Z) population arrays; the halo traffic rides XLA
collective-permutes (GSPMD) or explicit ppermutes (parallel/halo.py),
and multi-host meshes are handled transparently.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SPATIAL_AXES = ("x", "y", "z")


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a mesh over the spatial axes.

    mesh_shape: per-axis device counts, e.g. (4, 2, 1).  Defaults to all
    devices along x: slabs along the major-most axis, so each shard's
    local block and the exchanged boundary slabs are contiguous in
    memory, and a slab cut exchanges halos along one axis only.  NVLink
    joins every card to every other at one rate, so the layout follows
    the algorithm, not a network topology.  The reference decomposes any
    axis (BoxArray.maxSize, main_run_job.cpp:140-143); every layout is
    supported here.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n, 1, 1)
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    dev = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev, SPATIAL_AXES)


def field_spec(ndim_leading: int = 0) -> P:
    """PartitionSpec for an array with ndim_leading unsharded leading axes
    followed by (X, Y, Z) sharded over the mesh."""
    return P(*([None] * ndim_leading), *SPATIAL_AXES)


def population_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (19, X, Y, Z): replicate the population axis, shard
    space."""
    return NamedSharding(mesh, field_spec(1))


def scalar_field_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, field_spec(0))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(mesh: Mesh):
    """Shardings for the SimState pytree (f, g, key, step)."""
    from ..state import SimState

    return SimState(
        f=population_sharding(mesh),
        g=population_sharding(mesh),
        key=replicated(mesh),
        step=replicated(mesh),
    )


def shard_state(state, mesh: Mesh):
    """Place a SimState onto the mesh."""
    return jax.device_put(state, state_shardings(mesh))
