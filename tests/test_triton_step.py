"""GPU step kernel (kernels/triton_step.py) against the jnp reference.

The kernel runs here through the Pallas interpreter; compiled for the
card it is checked by ``chip_smoke.py`` and the ``gpu``-marked test.
Deterministic cases (kBT=0) compare the same update computed in another
order: agreement to float32 rounding, bound 2e-5 (the parity bound of
chip_smoke.py).  Hash-noise cases live in tests/test_triton_noise.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.config import LBMParams
from bflbm_tpu.kernels import triton_step
from bflbm_tpu.models import binary_fluid as model

ATOL = 2e-5
SHAPES = [(8, 8, 8), (4, 16, 8), (6, 10, 12)]   # the last one is masked


def _params(alpha0, alpha1=0.0, kBT=0.0, tau=(0.5, 0.5)):
    return LBMParams(alpha0=alpha0, alpha1=alpha1, kBT=kBT, kappa=0.1,
                     rho_lo=0.1, rho_hi=3.0, tau_f=tau[0], tau_g=tau[1])


def _compare(params, shape, n=3, dist="clt4"):
    state = model.init_droplet(shape, params, dtype=jnp.float32, radius=0.3)
    ref_step = jax.jit(lambda s: model.step(
        s, params, noise_source="hash", noise_dist=dist)[0])
    k_step = jax.jit(triton_step.make_step(params, shape, noise_dist=dist,
                                           interpret=True))
    ref = got = state
    for _ in range(n):
        ref = ref_step(ref)
        got = k_step(got)
    assert int(got.step) == n
    np.testing.assert_array_equal(np.asarray(got.key), np.asarray(ref.key))
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(ref.f),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(got.g), np.asarray(ref.g),
                               rtol=0, atol=ATOL)
    return got


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("alpha0,alpha1", [(0.0, 0.0), (1.5, 0.0),
                                           (0.0, 0.8), (1.5, 0.8)])
def test_step_matches_jnp_deterministic(alpha0, alpha1, shape):
    _compare(_params(alpha0, alpha1), shape)


@pytest.mark.parametrize("tau", [(0.8, 0.8), (0.7, 1.1)])
@pytest.mark.parametrize("alpha0", [0.0, 1.5])
def test_step_matches_jnp_general_tau(tau, alpha0):
    """tau != 1/2 takes the full forward transform and relaxes every
    moment (m + (m_eq - m)/tau_bar); unequal tau_f/tau_g too."""
    _compare(_params(alpha0, tau=tau), (4, 8, 8))


@pytest.mark.parametrize("block_cells", [8, 32, 64])
def test_tiling_invariance(block_cells, monkeypatch):
    """Every tiling computes each cell the same way: results equal the
    default tiling's, with and without masked edge blocks."""
    params = _params(1.5)
    shape = (4, 6, 12)
    b = _compare(params, shape, n=2)
    monkeypatch.setattr(triton_step, "BLOCK_CELLS", block_cells)
    a = _compare(params, shape, n=2)
    np.testing.assert_allclose(np.asarray(a.f), np.asarray(b.f), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shape,block_cells,tile", [
    ((256, 256, 256), 256, (1, 256)),
    ((8, 256, 64), 256, (4, 64)),
    ((32, 32, 32), 256, (8, 32)),
    ((6, 10, 12), 256, (16, 16)),
    ((64, 64, 1024), 256, (1, 256)),
    ((4, 3, 5), 64, (4, 8)),
])
def test_tile_for(shape, block_cells, tile):
    by, bz = triton_step.tile_for(shape, block_cells)
    assert (by, bz) == tile
    for b in (by, bz):
        assert b & (b - 1) == 0          # powers of two
    assert by * bz <= block_cells


def test_exact_mass():
    """Telescoped rest population: total mass is conserved to float32
    rounding of the stored populations, step after step."""
    params = _params(1.5, kBT=1e-5)
    shape = (8, 8, 8)
    state = model.init_droplet(shape, params, dtype=jnp.float32, radius=0.3)
    step = jax.jit(triton_step.make_step(params, shape, interpret=True))
    m0 = np.asarray(state.f, np.float64).sum()
    p0 = np.asarray(state.g, np.float64).sum()
    for _ in range(10):
        state = step(state)
    m1 = np.asarray(state.f, np.float64).sum()
    p1 = np.asarray(state.g, np.float64).sum()
    assert abs(m1 - m0) / m0 < 1e-7, (m0, m1)
    assert abs(p1 - p0) / p0 < 1e-7, (p0, p1)


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp(gpu_device):
    """On the card: the kernel as Triton compiles it, against jnp."""
    params = _params(1.5, kBT=1e-5)
    shape = (32, 32, 64)
    state = jax.device_put(
        model.init_droplet(shape, params, dtype=jnp.float32, radius=0.3),
        gpu_device)
    k_step = jax.jit(triton_step.make_step(params, shape))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda s: model.step(s, params,
                                           noise_source="hash")[0])(state)
    got = k_step(state)
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(ref.f),
                               rtol=0, atol=ATOL)
