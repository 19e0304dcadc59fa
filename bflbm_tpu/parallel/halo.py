"""Manual halo-exchange step: shard_map + ppermute over the mesh.

This is the explicitly-scheduled alternative to the GSPMD path
(:mod:`bflbm_tpu.parallel.auto`): each device holds a local block of the
post-collide populations, exchanges a 2-deep halo along each sharded
mesh axis with two ``lax.ppermute`` rounds (axis-by-axis exchange covers
the D3Q19 edge diagonals automatically — SURVEY.md §7 hard part 4), then
runs the extended-block step (:func:`bflbm_tpu.ops.blocked.step_on_block`)
entirely locally.  One exchange per step replaces the reference's ~6
``FillBoundary`` calls (LBM_binary.H:553-592).

Noise normals are drawn *globally* (sharded by XLA over the same mesh)
before entering shard_map, so the noise field — and hence the entire
trajectory — is identical for every mesh layout, unlike the reference
whose per-thread RNG engines make results decomposition-dependent.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LBMParams
from ..ops import blocked, collide as collide_ops, noise as noise_ops
from ..ops import stream as stream_ops
from ..models import binary_fluid as model
from ..state import SimState
from . import mesh as mesh_lib

HALO = 2


def exchange_halo(local: jnp.ndarray, axis_name: str, ax: int,
                  halo: int = HALO) -> jnp.ndarray:
    """Append `halo`-deep neighbor slabs along local axis `ax` using two
    ppermute rounds over mesh axis `axis_name` (periodic ring)."""
    n = jax.lax.psum(1, axis_name)
    if n == 1:
        # neighbor is self: periodic wrap locally
        left = jax.lax.slice_in_dim(local, local.shape[ax] - halo,
                                    local.shape[ax], axis=ax)
        right = jax.lax.slice_in_dim(local, 0, halo, axis=ax)
        return jnp.concatenate([left, local, right], axis=ax)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # my left halo = right edge of left neighbor (data moves +1)
    right_edge = jax.lax.slice_in_dim(local, local.shape[ax] - halo,
                                      local.shape[ax], axis=ax)
    left_halo = jax.lax.ppermute(right_edge, axis_name, fwd)
    left_edge = jax.lax.slice_in_dim(local, 0, halo, axis=ax)
    right_halo = jax.lax.ppermute(left_edge, axis_name, bwd)
    return jnp.concatenate([left_halo, local, right_halo], axis=ax)


def make_halo_nsteps(mesh: Mesh, params: LBMParams, n: int,
                     donate: bool = True, noise_source: str = "threefry",
                     noise_dist: str = "clt4"):
    """n standard steps with explicit halo exchange; returns jitted
    SimState -> SimState (same trajectory as the jnp/GSPMD paths with the
    same noise_source/noise_dist, up to f32 reordering)."""
    if n < 1:
        raise ValueError("n >= 1")

    sharded_axes = tuple(mesh.shape[a] > 1 for a in mesh_lib.SPATIAL_AXES)
    axis_names = mesh_lib.SPATIAL_AXES
    pspec = P(None, *axis_names)

    def local_step(f_loc, g_loc, normals_loc):
        f_ext, g_ext = f_loc, g_loc
        for d, (name, on) in enumerate(zip(axis_names, sharded_axes)):
            if not on:
                continue
            ax = 1 + d
            f_ext = exchange_halo(f_ext, name, ax)
            g_ext = exchange_halo(g_ext, name, ax)
        return blocked.step_on_block(f_ext, g_ext, normals_loc, params,
                                     sharded_axes)

    local_step_sm = shard_map(
        local_step, mesh=mesh,
        in_specs=(pspec, pspec, pspec),
        out_specs=(pspec, pspec),
    )

    def run(state: SimState) -> SimState:
        shape = tuple(state.f.shape[1:])
        dtype = state.f.dtype

        # enter post-collide space (jnp, GSPMD-sharded automatically)
        h, xi_f, xi_g, key = model.prelude(state, params,
                                           noise_source=noise_source,
                                           noise_dist=noise_dist)
        f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g,
                                     params)

        def body(carry, _):
            f, g, key, step = carry
            key, sub = jax.random.split(key)
            if params.noise_on:
                normals = noise_ops.normal_stack(sub, step, shape, dtype,
                                                 noise_source, noise_dist)
            else:
                normals = jnp.zeros((noise_ops.N_NORMALS,) + shape, dtype)
            f, g = local_step_sm(f, g, normals)
            return (f, g, key, step + 1), None

        (f, g, key, step), _ = jax.lax.scan(
            body, (f1, g1, key, state.step + 1), None, length=n - 1)
        return SimState(f=stream_ops.stream(f), g=stream_ops.stream(g),
                        key=key, step=step)

    sh = mesh_lib.state_shardings(mesh)
    return jax.jit(run, in_shardings=(sh,), out_shardings=sh,
                   donate_argnums=(0,) if donate else ())
