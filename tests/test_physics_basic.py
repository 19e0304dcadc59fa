"""Deterministic physics invariants (SURVEY.md §4 items 1, 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.config import LBMParams
from bflbm_tpu.models import binary_fluid as model
from bflbm_tpu.utils import debug


def run_n(state, params, n):
    stepf = jax.jit(model.step, static_argnums=1)
    for _ in range(n):
        state, h = stepf(state, params)
    return state, h


def test_uniform_mixture_stationary():
    """32^3 mixture, kBT=0, alpha0=0: uniform rho=phi=1 preserved to
    round-off (BASELINE config 1 / main_test.cpp intent)."""
    params = LBMParams(alpha0=0.0, kBT=0.0)
    state = model.init_mixture((16, 16, 16), params, dtype=jnp.float64)
    f0 = np.asarray(state.f)
    state, h = run_n(state, params, 20)
    np.testing.assert_allclose(np.asarray(state.f), f0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(h.rho), 1.0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(h.uf), 0.0, atol=1e-13)


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_mass_and_momentum_conservation(kBT):
    """Droplet with coupling: per-species mass and total momentum are
    conserved each step (PrintMassConservation analog, Debug.H:233-249);
    momentum noise is anti-correlated so conservation holds with noise.

    Uses rho_lo=0.1 so no cell falls below the FLT_EPSILON division guard:
    in guarded cells the 0.5*xi/rho velocity term is dropped while the
    moment-space noise kick is still applied — a ~sqrt(kBT*rho_guard)
    momentum leak inherited from the reference (same guard,
    LBM_binary.H:263-264); see test_guard_region_leak_is_bounded."""
    params = LBMParams(alpha0=1.5, kBT=kBT, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    state = model.init_droplet((12, 12, 12), params, dtype=jnp.float64,
                               radius=0.25)
    mass_f0 = float(debug.mass(state.f))
    mass_g0 = float(debug.mass(state.g))
    mom0 = np.asarray(debug.total_momentum(state.f, state.g))
    state, _ = run_n(state, params, 30)
    assert np.isclose(float(debug.mass(state.f)), mass_f0, rtol=1e-13)
    assert np.isclose(float(debug.mass(state.g)), mass_g0, rtol=1e-13)
    mom1 = np.asarray(debug.total_momentum(state.f, state.g))
    scale = mass_f0  # momentum-per-mass scale for tolerance
    np.testing.assert_allclose(mom1, mom0, atol=1e-11 * scale)
    assert not bool(debug.has_nonfinite(state.f, state.g))


def test_guard_region_leak_is_bounded():
    """With rho_lo=0 the droplet core/exterior has cells below the division
    guard; the per-step momentum leak there is O(sqrt(kBT * rho_guard)) per
    guarded cell (reference-inherited).  Verify it stays at that tiny scale
    rather than growing."""
    params = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.0,
                       rho_hi=3.0)
    state = model.init_droplet((12, 12, 12), params, dtype=jnp.float64,
                               radius=0.25)
    mom0 = np.asarray(debug.total_momentum(state.f, state.g))
    state, _ = run_n(state, params, 30)
    mom1 = np.asarray(debug.total_momentum(state.f, state.g))
    np.testing.assert_allclose(mom1, mom0, atol=1e-3)


def test_droplet_run_stays_finite_f32():
    """f32 stability smoke on the production dtype."""
    params = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.0,
                       rho_hi=3.0)
    state = model.init_droplet((16, 16, 16), params, dtype=jnp.float32,
                               radius=0.25)
    state, h = run_n(state, params, 50)
    assert not bool(debug.has_nonfinite(state.f, state.g, h.rho, h.uf))


def test_stripe_profile_shape():
    params = LBMParams(alpha0=1.5, kBT=0.0, kappa=0.1, rho_lo=0.1,
                       rho_hi=3.0)
    state = model.init_stripe((4, 8, 64), params, dtype=jnp.float64)
    rho = np.asarray(state.f.sum(axis=0))
    # high density inside the central slab, low outside
    assert rho[0, 0, 32] > 2.5
    assert rho[0, 0, 2] < 0.2
    # symmetric about the slab center
    np.testing.assert_allclose(rho[0, 0, 32 - 10], rho[0, 0, 32 + 10],
                               rtol=1e-10)


def test_determinism_same_seed():
    params = LBMParams(alpha0=0.0, kBT=1e-5)
    s1 = model.init_mixture((8, 8, 8), params, seed=3)
    s2 = model.init_mixture((8, 8, 8), params, seed=3)
    s1, _ = run_n(s1, params, 5)
    s2, _ = run_n(s2, params, 5)
    np.testing.assert_array_equal(np.asarray(s1.f), np.asarray(s2.f))


def test_asymmetric_relaxation_times():
    """tau_f != tau_g is supported (the reference hard-codes
    tau_g_bar = tau_f_bar in noise and forcing; we generalize) —
    conservation still holds and the run stays finite."""
    params = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.1,
                       rho_hi=3.0, tau_f=0.5, tau_g=0.8)
    state = model.init_droplet((10, 10, 10), params, dtype=jnp.float64,
                               radius=0.3)
    m_f0 = float(debug.mass(state.f))
    m_g0 = float(debug.mass(state.g))
    state, h = run_n(state, params, 20)
    assert np.isclose(float(debug.mass(state.f)), m_f0, rtol=1e-12)
    assert np.isclose(float(debug.mass(state.g)), m_g0, rtol=1e-12)
    assert not bool(debug.has_nonfinite(state.f, state.g, h.uf))


def test_units_system():
    from bflbm_tpu.utils.units import DEFAULT_UNITS, ohnesorge

    u = DEFAULT_UNITS
    # rho = 1 lbu <-> 1e3 kg/m^3 (system_unit.ipynb)
    np.testing.assert_allclose(u.density_si, 1e3, rtol=1e-3)
    # eta = 0.096 lbu <-> ~1e-3 Pa s (water's dynamic viscosity;
    # kinematic 0.096 dx^2/dt = 1e-6 m^2/s)
    np.testing.assert_allclose(0.096 * u.viscosity_si, 1e-3, rtol=0.01)
    # Oh = 1.231 with the reference's droplet numbers:
    # eta_lbu = rho_t/6 with rho_t ~ 3.1 -> 0.5167? the reference quotes
    # eta = 0.096 * ... use their pinned combination instead:
    oh = ohnesorge(0.5167, 3.1, 0.012162, 6.2)
    assert 1.0 < oh < 1.5  # order agreement with the pinned 1.231


def test_deep_quench_init_width_stabilizes():
    """alpha0=2.0, r=0.28 with the reference-exact sqrt(0.1)-cell init
    width diverges within ~10 steps (in float64 too — a stability
    boundary of the initialization, not a precision issue), while the
    stabilized init_width=1.0 protocol stays finite (RunConfig
    .init_width; acceptance d-sweep alpha0=2.0)."""
    params = LBMParams(alpha0=2.0, kBT=0.0, kappa=0.1,
                       rho_lo=0.0, rho_hi=3.0)
    sharp = model.init_droplet((32, 32, 32), params, dtype=jnp.float64,
                               radius=0.28)
    st, _ = run_n(sharp, params, 12)
    assert not bool(jnp.isfinite(jnp.sum(st.f)).item())

    wide = model.init_droplet((32, 32, 32), params, dtype=jnp.float32,
                              radius=0.28, width=1.0)
    st, _ = run_n(wide, params, 300)
    rho = np.asarray(jnp.sum(st.f, axis=0))
    assert np.isfinite(rho).all()
    assert 2.5 < rho.max() < 4.5


def test_run_noise_source_hash():
    """RunConfig.noise_source='hash' routes the jnp engine onto the
    coordinate-keyed stream (RANDRAW draw_from_pdf_normal analog): the
    run completes, equals the manual model.step(noise_source='hash')
    trajectory, and the kernel engine rejects the option loudly."""
    import tempfile

    from bflbm_tpu import run as run_mod
    from bflbm_tpu.config import RunConfig

    with tempfile.TemporaryDirectory() as d:
        cfg = RunConfig(shape=(8, 8, 8), params=LBMParams(kBT=1e-5),
                        nsteps=6, init="mixture", out_dir=d,
                        noise_source="hash")
        out = run_mod.run(cfg, engine="jnp")
        ref = model.make_initial_state(cfg)
        for _ in range(6):
            ref, _ = model.step(ref, cfg.params, noise_source="hash")
        # scan-compiled chunk vs eager per-step: same math, fusion may
        # re-associate rounding — f32 round-off tolerance
        np.testing.assert_allclose(np.asarray(out.f), np.asarray(ref.f),
                                   rtol=0, atol=5e-6)
        # differs from the default threefry stream (it IS another stream)
        thr = model.make_initial_state(cfg)
        for _ in range(6):
            thr, _ = model.step(thr, cfg.params)
        assert not np.array_equal(np.asarray(out.f), np.asarray(thr.f))
        # engine='auto' resolves to jnp under a non-default noise_source
        # (advisor r3): identical trajectory, no error
        auto = run_mod.run(cfg.replace(out_dir=d + "/auto"), engine="auto")
        np.testing.assert_array_equal(np.asarray(auto.f), np.asarray(out.f))
        with pytest.raises(ValueError, match="noise_source"):
            run_mod.run(cfg, engine="pallas")


def test_pick_chunk_caps_sparse_cadences():
    from bflbm_tpu.run import _pick_chunk

    # sparse single event: capped to the largest divisor <= cap so the
    # cadence still lands on a chunk boundary
    assert _pick_chunk([5000], 100_000, 1000) == 1000
    assert _pick_chunk([5000], 100_000, 900) == 625
    # gcd semantics unchanged below the cap
    assert _pick_chunk([2000, 100], 600_000, 1000) == 100
    # no events: nsteps, capped — even when nsteps is prime (advisor
    # r3: the divisor rule must not degrade an event-free chunk to 1)
    assert _pick_chunk([], 100_000, 1000) == 1000
    assert _pick_chunk([], 50, 1000) == 50
    assert _pick_chunk([], 100_003, 1000) == 1000
    # uncapped (cap=0) keeps the old behavior
    assert _pick_chunk([5000], 100_000, 0) == 5000
    # prime cadence above the cap degrades to 1 (correct, warned slow)
    assert _pick_chunk([4999], 100_000, 1000) == 1
