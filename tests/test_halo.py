"""Explicit halo-exchange (shard_map + ppermute) path vs the reference
jnp path — including WITH noise, since both consume the same globally
drawn normals (decomposition-invariant noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.config import LBMParams
from bflbm_tpu.models import binary_fluid as model
from bflbm_tpu.parallel import halo as halo_par
from bflbm_tpu.parallel import mesh as mesh_lib

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _run_jnp(state, params, n):
    for _ in range(n):
        state, _ = model.step(state, params)
    return state


@pytest.mark.parametrize("mesh_shape,kBT", [
    ((1, 1, 8), 0.0),
    ((2, 2, 2), 0.0),
    ((1, 2, 4), 1e-5),
    ((2, 2, 2), 1e-5),
])
def test_halo_step_matches_jnp(mesh_shape, kBT):
    params = LBMParams(alpha0=1.5, kBT=kBT, kappa=0.1, rho_lo=0.1,
                       rho_hi=3.0)
    shape = (16, 16, 16)
    state = model.init_droplet(shape, params, dtype=jnp.float32,
                               radius=0.25)
    n = 4
    ref = _run_jnp(state, params, n)

    mesh = mesh_lib.make_mesh(mesh_shape)
    sharded = mesh_lib.shard_state(state, mesh)
    run = halo_par.make_halo_nsteps(mesh, params, n, donate=False)
    got = run(sharded)

    assert int(got.step) == n
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(ref.f),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.g), np.asarray(ref.g),
                               rtol=0, atol=2e-5)


def test_blocked_step_periodic_matches_jnp():
    """step_on_block with no halo axes == one fused stream+collide on the
    whole periodic domain."""
    from bflbm_tpu.ops import blocked, collide as collide_ops
    from bflbm_tpu.ops import stream as stream_ops

    params = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.1,
                       rho_hi=3.0)
    state = model.init_droplet((8, 8, 8), params, dtype=jnp.float64,
                               radius=0.3)
    # jnp: two steps; compare the post-collide state after step 2's
    # collide by applying collide->stream then stream^-1... simpler:
    # run blocked in post-collide space and map back.
    h, xi_f, xi_g, key = model.prelude(state, params)
    f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g, params)

    # jnp second step
    from bflbm_tpu.state import SimState

    s1 = SimState(f=stream_ops.stream(f1), g=stream_ops.stream(g1),
                  key=key, step=state.step + 1)
    key2, sub2 = jax.random.split(s1.key)
    from bflbm_tpu.ops.noise import thermal_noise
    from bflbm_tpu.ops import hydro as hydro_ops

    hbar = hydro_ops.hydrovars_bar(s1.f, s1.g, params)
    xf2, xg2 = thermal_noise(sub2, hbar.rho, hbar.phi, params)
    h2 = hydro_ops.hydrovars(s1.f, s1.g, xf2, xg2, params, hbar)
    f2_ref, g2_ref = collide_ops.collide(s1.f, s1.g, h2, xf2, xg2, params)

    # blocked path: same normals
    normals = jax.random.normal(sub2, (33,) + (8, 8, 8), jnp.float64)
    f2, g2 = blocked.step_on_block(f1, g1, normals, params,
                                   (False, False, False))
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f2_ref),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g2_ref),
                               atol=1e-12)


@pytest.mark.parametrize("dist", ["clt4", "u8"])
def test_halo_step_matches_jnp_hash_noise(dist):
    """The halo engine draws the coordinate-keyed stream like the jnp
    engine: a (4, 1, 1) mesh matches one device with noise_source="hash"
    (the multi-card comparison chip_smoke.py --four makes at 256^3)."""
    params = LBMParams(alpha0=0.0, kBT=1e-5)
    shape = (16, 8, 8)
    state = model.init_mixture(shape, params, dtype=jnp.float32)
    n = 4
    ref = state
    for _ in range(n):
        ref, _ = model.step(ref, params, noise_source="hash",
                            noise_dist=dist)
    mesh = mesh_lib.make_mesh((4, 1, 1), devices=jax.devices()[:4])
    run = halo_par.make_halo_nsteps(mesh, params, n, donate=False,
                                    noise_source="hash", noise_dist=dist)
    got = run(mesh_lib.shard_state(state, mesh))
    assert int(got.step) == n
    np.testing.assert_array_equal(np.asarray(got.key), np.asarray(ref.key))
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(ref.f),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.g), np.asarray(ref.g),
                               rtol=0, atol=2e-5)


def test_exchange_halo_ring():
    """Each shard's appended slabs are its ring neighbours' edge rows:
    the exchanged block equals a periodic slice of the global array."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = mesh_lib.make_mesh((1, 4, 1), devices=jax.devices()[:4])
    x = jnp.arange(2 * 4 * 16 * 8, dtype=jnp.float32).reshape(2, 4, 16, 8)
    got = np.asarray(shard_map(
        lambda loc: halo_par.exchange_halo(loc, "y", 2, 2),
        mesh=mesh, in_specs=P(None, "x", "y", "z"),
        out_specs=P(None, "x", "y", "z"))(x))
    xs = np.asarray(x)
    for s in range(4):
        blk = got[:, :, s * 8:(s + 1) * 8]
        want = np.take(xs, np.arange(s * 4 - 2, s * 4 + 6) % 16, axis=2)
        np.testing.assert_array_equal(blk, want)
