"""GPU step kernel with thermal noise against the jnp reference.

The kernel draws the coordinate-keyed hash stream from the same per-step
word as ``model.step(..., noise_source="hash")``, so fluctuating
trajectories agree to float32 rounding (bound 2e-5) with bitwise-equal
RNG keys (Pallas interpreter here; compiled on the card by
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.kernels import triton_step
from bflbm_tpu.models import binary_fluid as model
from bflbm_tpu.ops import noise as noise_ops

from test_triton_step import SHAPES, _compare, _params


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("alpha0,alpha1", [(0.0, 0.0), (1.5, 0.0),
                                           (0.0, 0.8), (1.5, 0.8)])
def test_step_matches_jnp_hash_noise(alpha0, alpha1, shape):
    _compare(_params(alpha0, alpha1, kBT=1e-5), shape)


@pytest.mark.parametrize("dist", ["clt4", "clt2", "u8", "bm"])
def test_noise_dist_matches_jnp(dist):
    _compare(_params(0.0, kBT=1e-5), (4, 8, 8), n=2, dist=dist)


@pytest.mark.parametrize("dist", ["clt4", "clt2", "u8", "bm"])
def test_hash_channels_per_cell(dist):
    """hash_channels on flat cell indices (the kernel's form) equals the
    (33, X, Y, Z) stack of the jnp engine, bitwise."""
    shape = (4, 5, 6)
    word, step = jnp.int32(-31337), jnp.int32(11)
    stack = np.asarray(noise_ops.hash_normal_stack(word, step, shape,
                                                   jnp.float32, dist))
    keys = noise_ops.hash_counters(word, step, noise_ops.HASH_WORDS[dist])
    x, y, z = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    cell = noise_ops.cell_index(jnp.asarray(x, jnp.int32),
                                jnp.asarray(y, jnp.int32),
                                jnp.asarray(z, jnp.int32), shape)
    chans = noise_ops.hash_channels(cell, keys, jnp.float32, dist)
    for a in range(noise_ops.N_NORMALS):
        np.testing.assert_array_equal(np.asarray(chans[a]), stack[a])


def test_hash_counters_wrap():
    """The per-draw counters are (step*64 + a) * GOLDEN in int32 wrap-around
    arithmetic, preceded by the key word."""
    word, step, n = -5, 40_000_000, 3
    keys = np.asarray(noise_ops.hash_counters(jnp.int32(word),
                                              jnp.int32(step), n))
    gold = np.uint32(0x9E3779B9)
    want = [np.uint32(word & 0xFFFFFFFF)] + [
        np.uint32(((step * 64 + a) * int(gold)) & 0xFFFFFFFF)
        for a in range(n)]
    np.testing.assert_array_equal(keys, np.asarray(want, np.uint32))


def test_kernel_noise_statistics():
    """The kernel's fluctuating step injects the FDT variance: from the
    uniform mixture, one step's ghost-mode kick has the amplitude of
    ops/noise.py (checked through the population variance)."""
    params = _params(0.0, kBT=1e-5)
    shape = (8, 16, 16)
    state = model.init_mixture(shape, params, dtype=jnp.float32)
    ref = jax.jit(lambda s: model.step(s, params, noise_source="hash")[0])
    got = jax.jit(triton_step.make_step(params, shape, interpret=True))
    a = np.asarray(ref(state).f) - np.asarray(state.f)
    b = np.asarray(got(state).f) - np.asarray(state.f)
    assert a.std() > 0
    np.testing.assert_allclose(b.std(axis=(1, 2, 3)), a.std(axis=(1, 2, 3)),
                               rtol=1e-4)
