"""Noise covariance validation (NoiseCovariance.ipynb analog, SURVEY.md §4.6).

Checks the per-mode amplitudes of LBM_binary.H:113-127:
  momentum modes: var = 2(lam - lam^2/2) kBT |rho phi/rho_t|, xi_g = -xi_f;
  ghost modes:    var = 2(lam - lam^2/2) kBT/cs2 b_a |n_s|, independent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.config import LBMParams
from bflbm_tpu.lattice import B, CS2
from bflbm_tpu.ops.noise import (hash_normal_stack, thermal_noise,
                                 thermal_noise_hash)


def _draw(params, shape=(16, 16, 16), nsamples=32, rho0=1.0, phi0=1.0):
    rho = jnp.full(shape, rho0, jnp.float64)
    phi = jnp.full(shape, phi0, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), nsamples)
    draw = jax.jit(lambda k: thermal_noise(k, rho, phi, params))
    xf, xg = [], []
    for k in keys:
        a, b = draw(k)
        xf.append(np.asarray(a))
        xg.append(np.asarray(b))
    return np.stack(xf), np.stack(xg)


def test_mode_variances():
    params = LBMParams(kBT=1e-5)
    rho0, phi0 = 1.2, 0.8
    xf, xg = _draw(params, nsamples=24, rho0=rho0, phi0=phi0)
    lam = params.lam_f
    pref = 2.0 * (lam - 0.5 * lam * lam) * params.kBT
    # mass mode exactly zero
    assert np.all(xf[:, 0] == 0.0) and np.all(xg[:, 0] == 0.0)
    # momentum modes: shared amplitude, exact anti-correlation
    var_mom = pref * rho0 * phi0 / (rho0 + phi0)
    got = xf[:, 1:4].var()
    np.testing.assert_allclose(got, var_mom, rtol=0.05)
    np.testing.assert_array_equal(xg[:, 1:4], -xf[:, 1:4])
    # ghost modes: b_a-weighted, species' own density
    for a in [4, 7, 10, 16, 18]:
        np.testing.assert_allclose(
            xf[:, a].var(), pref / CS2 * B[a] * rho0, rtol=0.08)
        np.testing.assert_allclose(
            xg[:, a].var(), pref / CS2 * B[a] * phi0, rtol=0.08)
    # f ghost and g ghost independent
    corr = np.corrcoef(xf[:, 5].ravel(), xg[:, 5].ravel())[0, 1]
    assert abs(corr) < 0.02


def test_noise_off_is_zero():
    params = LBMParams(kBT=0.0)
    rho = jnp.ones((4, 4, 4))
    xf, xg = thermal_noise(jax.random.PRNGKey(1), rho, rho, params)
    assert np.all(np.asarray(xf) == 0.0)
    assert np.all(np.asarray(xg) == 0.0)


def test_counter_based_determinism():
    params = LBMParams(kBT=1e-5)
    rho = jnp.ones((8, 8, 8))
    k = jax.random.PRNGKey(9)
    a1, _ = thermal_noise(k, rho, rho, params)
    a2, _ = thermal_noise(k, rho, rho, params)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))


# ---------------------------------------------------------------------------
# Coordinate-keyed ("hash") noise source - the RANDRAW
# draw_from_pdf_normal analog (LBM_binary.H:42-63), drawn bitwise alike
# by the jnp engine and the GPU step kernel.
# ---------------------------------------------------------------------------

def test_hash_stack_matches_kernel_stream():
    """The (33, ...) stack is the channel order of the stream: channel a
    is n1[a//2] / n2[a//2] of hash_normals, the per-cell draws the GPU
    step kernel computes (hash_channels)."""
    from bflbm_tpu.ops.noise import hash_normals

    shape = (6, 5, 8)
    word, step = jnp.int32(-123456789), jnp.int32(7)
    stack = np.asarray(hash_normal_stack(word, step, shape, jnp.float32))
    n1, n2 = hash_normals(word, step, (jnp.int32(0), jnp.int32(0)),
                          shape, shape, jnp.float32)
    for a in range(33):
        ref = n1[a // 2] if a % 2 == 0 else n2[a // 2]
        np.testing.assert_array_equal(stack[a], np.asarray(ref))


def test_hash_noise_mode_variances():
    """thermal_noise_hash carries the same FDT amplitudes as
    thermal_noise: per-mode variances, anti-correlated momentum."""
    params = LBMParams(kBT=1e-5)
    rho0, phi0 = 1.2, 0.8
    shape = (16, 16, 16)
    rho = jnp.full(shape, rho0, jnp.float32)
    phi = jnp.full(shape, phi0, jnp.float32)
    draw = jax.jit(lambda w, s: thermal_noise_hash(w, s, rho, phi, params))
    xf, xg = [], []
    for s in range(24):
        a, b = draw(jnp.int32(42), jnp.int32(s))
        xf.append(np.asarray(a))
        xg.append(np.asarray(b))
    xf, xg = np.stack(xf), np.stack(xg)
    lam = params.lam_f
    pref = 2.0 * (lam - 0.5 * lam * lam) * params.kBT
    assert np.all(xf[:, 0] == 0.0)
    np.testing.assert_array_equal(xg[:, 1:4], -xf[:, 1:4])
    np.testing.assert_allclose(xf[:, 1:4].var(),
                               pref * rho0 * phi0 / (rho0 + phi0),
                               rtol=0.05)
    for a in [4, 10, 18]:
        np.testing.assert_allclose(
            xf[:, a].var(), pref / CS2 * B[a] * rho0, rtol=0.08)
    # per-step streams distinct, per-(word, step) reproducible
    a1, _ = draw(jnp.int32(42), jnp.int32(3))
    a2, _ = draw(jnp.int32(42), jnp.int32(3))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    assert not np.array_equal(xf[3], xf[4])


@pytest.mark.parametrize("dist", ["clt4", "clt2", "u8", "bm"])
def test_hash_normals_coordinate_keyed(dist):
    """The counter-RNG normal for a global cell is independent of the
    region it is generated on - including negative origins and periodic
    wraps - which is what lets any kernel tiling draw the jnp engine's
    noise bitwise."""
    from bflbm_tpu.ops.noise import hash_normals

    domain = (8, 16, 8)
    w = jnp.int32(-123456789)
    s = jnp.int32(7)
    full = hash_normals(w, s, (jnp.int32(0), jnp.int32(0)),
                        domain, domain, jnp.float32, dist)
    # interior sub-region
    sub = hash_normals(w, s, (jnp.int32(2), jnp.int32(3)),
                       (4, 5, 8), domain, jnp.float32, dist)
    for p in range(len(full[0])):
        np.testing.assert_array_equal(
            np.asarray(sub[0][p]), np.asarray(full[0][p])[2:6, 3:8])
        np.testing.assert_array_equal(
            np.asarray(sub[1][p]), np.asarray(full[1][p])[2:6, 3:8])
    # negative origin + wrap: region [-2, 10) x [-2, 18)
    wrapped = hash_normals(w, s, (jnp.int32(-2), jnp.int32(-2)),
                           (12, 20, 8), domain, jnp.float32, dist)
    ref = np.asarray(full[0][3])
    got = np.asarray(wrapped[0][3])
    np.testing.assert_array_equal(got[2:10, 2:18], ref)
    np.testing.assert_array_equal(got[0:2, 2:18], ref[6:8, :])
    np.testing.assert_array_equal(got[2:10, 0:2], ref[:, 14:16])
    # different step / word -> different stream
    other = hash_normals(w, s + 1, (jnp.int32(0), jnp.int32(0)),
                         domain, domain, jnp.float32, dist)
    assert not np.allclose(np.asarray(other[0][0]), np.asarray(full[0][0]))


@pytest.mark.parametrize("dist", ["clt4", "clt2", "u8", "bm"])
def test_hash_normals_statistics(dist):
    """Mean/variance/cross-draw and spatial-lag correlations of the hash
    stream (the FDT noise driver of the kernel engine)."""
    from bflbm_tpu.ops.noise import hash_normals

    domain = (16, 16, 128)
    ns = []
    for step in range(4):
        n1, n2 = hash_normals(jnp.int32(987654321), jnp.int32(step),
                              (jnp.int32(0), jnp.int32(0)),
                              domain, domain, jnp.float32, dist)
        ns.append(np.stack([np.asarray(a) for a in (n1 + n2)]))
    x = np.stack(ns)  # (steps, 34, X, Y, Z)
    n_samp = x[0, 0].size  # 32768 per draw
    tol = 5.0 / np.sqrt(n_samp)  # ~5 sigma
    assert abs(x.mean()) < 1e-2
    np.testing.assert_allclose(x.var(axis=(2, 3, 4)), 1.0, atol=5 * tol)
    flat = x.reshape(4 * 34, -1)
    flat = flat - flat.mean(axis=1, keepdims=True)
    cov = (flat @ flat.T) / flat.shape[1]
    off = cov - np.diag(np.diag(cov))
    assert np.abs(off).max() < 4 * tol, np.abs(off).max()
    # spatial lag-1 correlations along each axis
    for ax in (1, 2, 3):
        a = x[0, 5]
        b = np.roll(a, 1, axis=ax - 1)
        r = np.mean(a * b)
        assert abs(r) < 4 * tol, (ax, r)


def test_clt2_pair_moments():
    """The CLT-2 byte-pair generator (two normals per word — the cheap
    noise_dist="clt2" option): EXACT first/second moments, zero skew,
    excess kurtosis -0.6, support +-2.44 sigma; lo/hi halves of one word
    map to independent byte pairs."""
    from bflbm_tpu.ops.noise import _clt2_pair

    # exhaustive over the low 16 bits: the lo normal's full distribution
    w = np.arange(1 << 16, dtype=np.uint32)
    lo, hi = _clt2_pair(jnp.asarray(w, jnp.uint32), jnp.float64)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    np.testing.assert_allclose(lo.mean(), 0.0, atol=1e-12)
    np.testing.assert_allclose(lo.var(), 1.0, rtol=1e-12)
    m4 = (lo ** 4).mean()
    np.testing.assert_allclose(m4 - 3.0, -0.6, atol=2e-3)
    assert np.isclose(np.abs(lo).max(), 255.0 / np.sqrt(65535.0 / 6.0),
                      rtol=1e-9)
    # hi half over this sweep is the zero pair -> constant minimum
    np.testing.assert_allclose(hi, hi[0])
    # hi extraction reads bytes 2,3: exhaustive over the high 16 bits
    _, hi2 = _clt2_pair(jnp.asarray(w << 16, jnp.uint32), jnp.float64)
    hi2 = np.asarray(hi2, np.float64)
    np.testing.assert_allclose(hi2.var(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.sort(hi2), np.sort(lo), atol=1e-12)


def test_u8_quad_moments():
    """The u8 single-byte generator (four variance-matched uniform
    deviates per word — Ladd's original FLBM noise, J. Fluid Mech. 271,
    1994; noise_dist="u8"): EXACT first/second moments, zero skew,
    excess kurtosis -1.2, support +-1.73 sigma; the four byte lanes of
    one word extract disjoint bits."""
    from bflbm_tpu.ops.noise import _u8_quad

    w = np.arange(1 << 16, dtype=np.uint32)
    ds = [np.asarray(d, np.float64)
          for d in _u8_quad(jnp.asarray(w, jnp.uint32), jnp.float64)]
    # byte 0 over the sweep: exhaustive uniform 0..255
    np.testing.assert_allclose(ds[0].mean(), 0.0, atol=1e-12)
    np.testing.assert_allclose(ds[0].var(), 1.0, rtol=1e-12)
    m4 = (ds[0] ** 4).mean()
    np.testing.assert_allclose(m4 - 3.0, -1.2, atol=1e-2)
    assert np.isclose(np.abs(ds[0]).max(), 127.5 / np.sqrt(65535.0 / 12.0),
                      rtol=1e-9)
    # byte lanes are disjoint bit ranges: bytes 2,3 constant on this sweep
    np.testing.assert_allclose(ds[2], ds[2][0])
    np.testing.assert_allclose(ds[3], ds[3][0])
    # byte 1 sweeps the same distribution
    np.testing.assert_allclose(np.sort(np.unique(ds[1])),
                               np.sort(np.unique(ds[0])), atol=1e-12)


def test_clt4_normal_moments():
    """The CLT-4 byte-sum generator has EXACT first/second moments (the
    only cumulants entering the validated fluctuation observables), zero
    skew, excess kurtosis -0.3, and support +-3.45 sigma - the documented
    trade of the hash stream's default noise distribution."""
    from bflbm_tpu.ops.noise import _clt4_normal

    # exhaustive: all 2^16 byte-pair sums x2 reproduces the exact
    # moments of the full 2^32 word space (bytes are i.i.d.)
    w = np.arange(1 << 16, dtype=np.uint32)
    w = (w & 0xFF) | ((w >> 8) << 8)  # identity; bytes 0,1 populated
    z = np.asarray(_clt4_normal(jnp.asarray(w, jnp.uint32), jnp.float32))
    # byte-sum of bytes 0,1 only -> mean -510*s + E[b0+b1]*s; instead
    # check the documented moments on the actual 4-byte generator via
    # the exact distribution of a single byte
    b = np.arange(256, dtype=np.float64)
    m1 = b.mean()
    v1 = ((b - m1) ** 2).mean()
    k4_1 = ((b - m1) ** 4).mean() - 3 * v1 ** 2  # 4th cumulant, 1 byte
    var4 = 4 * v1
    assert np.isclose(var4, 65535.0 / 3.0)
    excess = 4 * k4_1 / var4 ** 2
    assert np.isclose(excess, -0.3, atol=2e-3), excess
    # generator normalization: z for word with bytes (255,255,255,255)
    z_max = np.asarray(_clt4_normal(
        jnp.asarray([0xFFFFFFFF], jnp.uint32), jnp.float32))[0]
    assert np.isclose(z_max, 510.0 / np.sqrt(var4), rtol=1e-6)
    z0 = np.asarray(_clt4_normal(
        jnp.asarray([0], jnp.uint32), jnp.float32))[0]
    assert np.isclose(z0, -510.0 / np.sqrt(var4), rtol=1e-6)
    # sampled mean/var over the byte0/byte1-exhaustive slice agree with
    # the closed form (bytes 2,3 are zero -> shifted but same variance
    # contribution from two bytes)
    assert np.isclose(z.var(), 2 * v1 / var4, rtol=1e-3)
