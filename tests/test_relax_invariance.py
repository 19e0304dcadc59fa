"""Exact-relaxation (tau = 1/2) specialization: algebraically exact,
NOT bitwise.

Every reference recipe runs tau_bar = 1 (LBM_binary.H:74-80), where the
MRT update m + (m_eq - m)/tau_bar + Phi + xi reduces to m_eq + Phi + xi;
the engines specialize that case to skip the discarded work.  The
specialization is algebraically exact (f64 diff ~1e-14 here), but in f32
``fl(m + fl(m_eq - m)) != m_eq`` in general - the specialized and
general paths produce trajectories that differ at round-off (~1e-7
after one step) on any NON-UNIFORM state, and a round-off-perturbed
chaotic trajectory decorrelates.  Consequence pinned here: no long-run
fluctuation statistic of the specialized engine can be byte-identical
to a run of the general formulas, so a re-validation after such a
change uses an independent seed to make its sampling-level differences
visible.

The hook ``ops.collide.FORCE_GENERAL_RELAX`` routes tau = 1/2 through
the general formulas for these A/Bs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflbm_tpu.config import LBMParams
from bflbm_tpu.models import binary_fluid as model
from bflbm_tpu.ops import collide as collide_ops


@pytest.fixture
def force_general():
    def setter(on):
        collide_ops.FORCE_GENERAL_RELAX = on

    yield setter
    setter(False)


def _jnp_step(state, params, n=8):
    out = jax.tree.map(jnp.array, state)
    # several steps: right after an equilibrium init m ~= m_eq within a
    # factor 2 everywhere, where Sterbenz makes fl(m + fl(m_eq - m))
    # EXACT — the paths only decorrelate once the state has evolved
    for _ in range(n):
        out, _ = model.step(out, params, noise_source="hash")
    return np.asarray(out.f), np.asarray(out.g)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_jnp_collide_exact_vs_general(force_general, dtype):
    """jnp engine: the specialized collide branch (ops/collide.py) is
    algebraically exact (f64 ~1e-14) but differs at round-off in f32 on
    a non-uniform fluctuating state — and is NOT bitwise there."""
    params = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1,
                       rho_lo=0.1, rho_hi=3.0)
    state = model.init_droplet((8, 8, 8), params, dtype=dtype, radius=0.3)

    force_general(False)
    fe, ge = _jnp_step(state, params)
    force_general(True)
    fg, gg = _jnp_step(state, params)

    d = max(np.abs(fe - fg).max(), np.abs(ge - gg).max())
    if dtype == jnp.float64:
        assert d < 1e-12, d
    else:
        assert d < 1e-5, d            # round-off, not a physics change
        assert d > 0.0                # ... but NOT bitwise
