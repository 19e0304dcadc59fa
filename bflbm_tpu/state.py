"""Simulation state pytree."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SimState(NamedTuple):
    """Complete, checkpointable simulation state.

    The reference carries (fold, gold, hydrovs, hydrovsbar, noise fields)
    as mutable MultiFabs (main_run_job.cpp:205-212); everything derived is
    recomputed inside the step here, so the minimal state is just the two
    population sets plus RNG bookkeeping.  f, g have shape (19, X, Y, Z)
    with the population axis leading (structure of arrays), so each
    population is a contiguous field and z is the unit-stride axis that
    coalesced GPU loads run along.
    """

    f: jax.Array
    g: jax.Array
    key: jax.Array
    step: jax.Array  # int32 scalar

    @property
    def shape(self):
        return self.f.shape[1:]

    @property
    def dtype(self):
        return self.f.dtype


def make_key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def init_state(f: jax.Array, g: jax.Array, seed: int,
               step: int = 0) -> SimState:
    return SimState(f=f, g=g, key=make_key(seed),
                    step=jnp.asarray(step, jnp.int32))
