"""Lattice model unit tests (SURVEY.md §7 step 1)."""

import jax.numpy as jnp
import numpy as np

from bflbm_tpu import lattice
from bflbm_tpu.ops.moments import moments, populations


def test_mode_norms_match_reference_table():
    # b table transcribed from LBM_d3q19.H:56-76 (fixture, not live code)
    np.testing.assert_allclose(lattice.B, lattice.B_REFERENCE, rtol=0, atol=1e-14)


def test_transform_inverse():
    np.testing.assert_allclose(
        lattice.M @ lattice.M_INV, np.eye(19), atol=1e-13)
    np.testing.assert_allclose(
        lattice.M_INV @ lattice.M, np.eye(19), atol=1e-13)


def test_weight_isotropy():
    C = lattice.C.astype(float)
    W = lattice.W
    # 4th order isotropy: sum w c_a c_b c_c c_d = cs4 (d_ab d_cd + ...)
    T4 = np.einsum("i,ia,ib,ic,id->abcd", W, C, C, C, C)
    I = np.eye(3)
    expected = lattice.CS4 * (
        np.einsum("ab,cd->abcd", I, I)
        + np.einsum("ac,bd->abcd", I, I)
        + np.einsum("ad,bc->abcd", I, I)
    )
    np.testing.assert_allclose(T4, expected, atol=1e-14)


def test_moment_roundtrip():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(19, 4, 4, 4))
    m = moments(jnp.asarray(f))
    f2 = populations(m)
    np.testing.assert_allclose(np.asarray(f2), f, atol=1e-12)


def test_conserved_moments_are_mass_and_momentum():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(19, 3, 3, 3))
    m = np.asarray(moments(jnp.asarray(f)))
    np.testing.assert_allclose(m[0], f.sum(axis=0), atol=1e-12)
    j = np.einsum("ixyz,id->dxyz", f, lattice.C.astype(float))
    np.testing.assert_allclose(m[1:4], j, atol=1e-12)


def test_equilibrium_velocity_moments():
    """populations(m_eq) must have exact 0th/1st/2nd velocity moments:
    sum f = rho, sum f c = rho u, sum f c c = rho cs2 I + rho u u."""
    from bflbm_tpu.ops.collide import equilibrium_moments

    rho = jnp.asarray(np.array([1.3])[:, None, None])
    u = jnp.asarray(np.array([0.02, -0.01, 0.03])[:, None, None, None])
    feq = np.asarray(populations(equilibrium_moments(rho, u))).reshape(19)
    C = lattice.C.astype(float)
    np.testing.assert_allclose(feq.sum(), 1.3, atol=1e-12)
    np.testing.assert_allclose(
        np.einsum("i,id->d", feq, C), 1.3 * np.asarray(u).ravel(), atol=1e-12)
    P = np.einsum("i,ia,ib->ab", feq, C, C)
    uu = np.outer(np.asarray(u).ravel(), np.asarray(u).ravel())
    np.testing.assert_allclose(
        P, 1.3 * (lattice.CS2 * np.eye(3) + uu), atol=1e-12)


def test_rest_equilibrium_is_weights():
    """moments of f_i = w_i rho must be (rho, 0...): the rest equilibrium."""
    rho = 2.7
    f = jnp.asarray(lattice.W * rho)[:, None, None, None]
    m = np.asarray(moments(f)).ravel()
    np.testing.assert_allclose(m[0], rho, atol=1e-12)
    np.testing.assert_allclose(m[1:], 0.0, atol=1e-12)


def test_eof_factored_schedules_match_matrices():
    """The hand-factored transform schedules (the GPU step kernel's) must
    reproduce M / M_INV exactly on the identity basis and agree with a
    dense f64 matrix apply on random data; the telescoped rest
    population must conserve mass to f64 roundoff.  Guards the
    import-time _verify_eof gate with visible coverage."""
    from bflbm_tpu.ops.moments import _eof_mom, _eof_pops, _verify_eof

    assert _verify_eof()
    rng = np.random.default_rng(3)
    pops = [rng.standard_normal(64) for _ in range(lattice.Q)]
    m_fact = np.stack(_eof_mom(pops))
    m_dense = np.einsum("ki,ix->kx", lattice.M, np.stack(pops))
    np.testing.assert_allclose(m_fact, m_dense, rtol=0, atol=1e-12)

    moms = [rng.standard_normal(64) for _ in range(lattice.Q)]
    p_fact = np.stack(_eof_pops(moms))
    p_dense = np.einsum("ik,kx->ix", lattice.M_INV, np.stack(moms))
    np.testing.assert_allclose(p_fact, p_dense, rtol=0, atol=1e-12)
    # telescoping: stored mass == the mass moment to f64 roundoff
    np.testing.assert_allclose(p_fact.sum(axis=0), moms[0], atol=1e-12)


# wg table transcribed from LBM_d3q19.H:78-98 (fixture, not live code —
# the live WG is CONSTRUCTED from its moment-space decomposition).
def _wg_reference():
    wg = np.zeros((19, 3, 3))

    def diag(i, xx, yy, zz):
        wg[i, 0, 0], wg[i, 1, 1], wg[i, 2, 2] = xx, yy, zz

    for i in (1, 2):
        diag(i, 5 / 36, -1 / 9, -1 / 9)
    for i in (3, 4):
        diag(i, -1 / 9, 5 / 36, -1 / 9)
    for i in (5, 6):
        diag(i, -1 / 9, -1 / 9, 5 / 36)
    for i, s in ((7, 1), (8, 1), (9, -1), (10, -1)):
        diag(i, -1 / 72, -1 / 72, 1 / 36)
        wg[i, 0, 1] = wg[i, 1, 0] = s / 12
    for i, s in ((11, 1), (12, 1), (13, -1), (14, -1)):
        diag(i, 1 / 36, -1 / 72, -1 / 72)
        wg[i, 1, 2] = wg[i, 2, 1] = s / 12
    for i, s in ((15, 1), (16, 1), (17, -1), (18, -1)):
        diag(i, -1 / 72, 1 / 36, -1 / 72)
        wg[i, 0, 2] = wg[i, 2, 0] = s / 12
    return wg


def test_tensor_weights_match_reference_table():
    np.testing.assert_allclose(lattice.WG, _wg_reference(), atol=1e-14)


def test_tensor_weights_moment_content():
    # zero first moment; isotropic -I/6 zeroth moment (the decomposition
    # the construction is built from)
    C = lattice.C.astype(float)
    np.testing.assert_allclose(
        np.einsum("iab,ic->abc", lattice.WG, C), 0.0, atol=1e-14)
    np.testing.assert_allclose(
        np.einsum("iab->ab", lattice.WG), -np.eye(3) / 6.0, atol=1e-14)


def test_moment_stress_diagnostic():
    # hydrovars(m) analog (LBM_d3q19.H:258-286): deviatoric stress from
    # moments equals the direct population-space contraction
    from bflbm_tpu.ops.hydro import moment_stress

    rng = np.random.default_rng(3)
    f = rng.uniform(0.5, 1.5, size=(19, 3, 4, 5))
    m = np.asarray(moments(jnp.asarray(f)))
    rho, j, sigma = moment_stress(jnp.asarray(m))
    C = lattice.C.astype(float)
    P = np.einsum("i...,ia,ib->ab...", f, C, C)
    rho_d = f.sum(0)
    j_d = np.einsum("i...,ia->a...", f, C)
    eye = np.eye(3).reshape(3, 3, 1, 1, 1)
    expected = P - lattice.CS2 * rho_d * eye \
        - j_d[None] * j_d[:, None] / rho_d
    np.testing.assert_allclose(np.asarray(sigma), expected, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rho), rho_d, atol=1e-12)
    np.testing.assert_allclose(np.asarray(j), j_d, atol=1e-12)
    # the rho <= FLT_EPSILON guard leaves the raw pressure tensor
    m0 = np.zeros((19, 1, 1, 1))
    _, _, s0 = moment_stress(jnp.asarray(m0))
    np.testing.assert_allclose(np.asarray(s0), 0.0, atol=0)


def test_single_fluid_mequilibrium_equivalence():
    # the reference's single-fluid mequilibrium (LBM_d3q19.H:288-317) is
    # algebraically the binary equilibrium_moments at the same (rho, u):
    # mass rho; momentum rho u; m4 = rho u^2; m5 = rho (2ux^2-uy^2-uz^2);
    # m6 = rho (uy^2-uz^2); m7..9 = rho u_a u_b; ghosts zero
    from bflbm_tpu.ops.collide import equilibrium_moments

    rho = jnp.asarray([[1.3]])
    u = jnp.asarray([[[0.02]], [[-0.01]], [[0.03]]])
    m = np.asarray(equilibrium_moments(rho, u)).ravel()
    r, (ux, uy, uz) = 1.3, (0.02, -0.01, 0.03)
    expect = np.zeros(19)
    expect[0] = r
    expect[1:4] = r * np.array([ux, uy, uz])
    expect[4] = r * (ux**2 + uy**2 + uz**2)
    expect[5] = r * (2 * ux**2 - uy**2 - uz**2)
    expect[6] = r * (uy**2 - uz**2)
    expect[7], expect[8], expect[9] = r * ux * uy, r * uy * uz, r * uz * ux
    np.testing.assert_allclose(m, expect, atol=1e-7)
