"""Hydrodynamic variable reconstruction (modified -> real variables).

Reference: ``hydrovars`` / ``hydrovars_bar_density``
(``LBM_binary.H:196-354``).  The modified-LB bookkeeping: populations f, g
carry "modified" moments; physical ("real") velocities include half-step
force, cross-species friction, and noise corrections:

    uf = uf_bar + a_f/2
         - (lam_f/2) phi/(rho+phi) [ (uf_bar - ug_bar) + (a_f - a_g)/2 ]
         + xi_f / (2 rho)                       (LBM_binary.H:266-272)

with lam = 1/(tau + 1/2), a_f = -cs^2 alpha0 psi(rho) grad(psi(phi)) / rho
(Shan-Chen cross coupling, LBM_binary.H:254-255), and symmetric formulas
for g.  The 22-component output schema matches ``VariableNames``
(``AMReX_FileIO.H:209-295``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import LBMParams
from ..lattice import C, CS2
from . import stencil

# Output schema of the reference plotfiles (AMReX_FileIO.H:209-295 /
# main_run_job.cpp:147): 22 components.
HYDRO_NAMES: Tuple[str, ...] = (
    "rho", "phi",
    "ufx", "ufy", "ufz",
    "p_bulk",
    "ugx", "ugy", "ugz",
    "afx", "afy", "afz",
    "agx", "agy", "agz",
    "ubx", "uby", "ubz",
    "nfbarx", "ngbarx", "ufbarx", "ugbarx",
)


class HydroBar(NamedTuple):
    """Modified (bare LB) fields — ``hydrovars_bar_density`` analog."""

    rho: jnp.ndarray    # sum_i f_i
    phi: jnp.ndarray    # sum_i g_i
    uf_bar: jnp.ndarray  # (3,X,Y,Z) = jf / rho
    ug_bar: jnp.ndarray  # (3,X,Y,Z) = jg / phi


class Hydro(NamedTuple):
    """Real hydrodynamic fields — ``hydrovars`` analog."""

    rho: jnp.ndarray
    phi: jnp.ndarray
    uf: jnp.ndarray      # (3,...) real velocity of species f
    ug: jnp.ndarray      # (3,...) real velocity of species g
    af: jnp.ndarray      # (3,...) acceleration of f (== modified)
    ag: jnp.ndarray      # (3,...)
    ub: jnp.ndarray      # (3,...) barycentric velocity
    rho_tot: jnp.ndarray
    uf_bar: jnp.ndarray  # (3,...) bare LB velocity of f
    ug_bar: jnp.ndarray
    nf_vel: jnp.ndarray  # (3,...) xi_f[1:4] / rho (noise velocity term)
    ng_vel: jnp.ndarray


def _safe_div(num, den, eps):
    ok = jnp.abs(den) > eps
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)


def momentum(f: jnp.ndarray) -> jnp.ndarray:
    """j_d = sum_i f_i c_{i,d}; returns (3, X, Y, Z).

    Precision.HIGHEST: full float32, no TF32 (see ops.moments).
    """
    cmat = jnp.asarray(C.T, dtype=f.dtype)  # (3, 19)
    return jnp.tensordot(cmat, f, axes=([1], [0]),
                         precision=jax.lax.Precision.HIGHEST)


def hydrovars_bar(f: jnp.ndarray, g: jnp.ndarray,
                  params: LBMParams) -> HydroBar:
    """Densities + bare velocities from populations (LBM_binary.H:315-340)."""
    rho = jnp.sum(f, axis=0)
    phi = jnp.sum(g, axis=0)
    uf_bar = _safe_div(momentum(f), rho[None], params.div_eps)
    ug_bar = _safe_div(momentum(g), phi[None], params.div_eps)
    return HydroBar(rho, phi, uf_bar, ug_bar)


def accelerations(rho: jnp.ndarray, phi: jnp.ndarray,
                  params: LBMParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shan-Chen cross-species accelerations (LBM_binary.H:232-257).

    a_f = -cs^2 alpha0 psi(rho) grad(psi(phi)) / rho   (and symmetric).
    The alpha1 square-gradient term is only evaluated when alpha1 != 0 —
    the reference computes its 361-point stencil unconditionally but the
    result feeds only commented-out code (SURVEY.md §2.2).
    """
    use_sc, n0, eps = params.use_sc_pseudo, params.sc_ref_density, params.div_eps
    grad_phi = stencil.gradient(phi, use_sc, n0)
    grad_rho = stencil.gradient(rho, use_sc, n0)
    psi_rho = stencil.pseudopotential(rho, use_sc, n0)
    psi_phi = stencil.pseudopotential(phi, use_sc, n0)
    af = -CS2 * params.alpha0 * _safe_div(psi_rho[None] * grad_phi,
                                          rho[None], eps)
    ag = -CS2 * params.alpha0 * _safe_div(psi_phi[None] * grad_rho,
                                          phi[None], eps)
    if params.alpha1 != 0.0:
        af = af - CS2 * params.alpha1 * stencil.grad_laplacian(phi, use_sc, n0)
        ag = ag - CS2 * params.alpha1 * stencil.grad_laplacian(rho, use_sc, n0)
    return af, ag


def hydrovars(f: jnp.ndarray, g: jnp.ndarray,
              xi_f: jnp.ndarray, xi_g: jnp.ndarray,
              params: LBMParams,
              hbar: Optional[HydroBar] = None) -> Hydro:
    """Full real-variable reconstruction (LBM_binary.H:196-295)."""
    if hbar is None:
        hbar = hydrovars_bar(f, g, params)
    af, ag = accelerations(hbar.rho, hbar.phi, params)
    return hydrovars_with_acc(f, g, hbar, af, ag, xi_f, xi_g, params)


def hydrovars_with_acc(f: jnp.ndarray, g: jnp.ndarray, hbar: HydroBar,
                       af: jnp.ndarray, ag: jnp.ndarray,
                       xi_f: jnp.ndarray, xi_g: jnp.ndarray,
                       params: LBMParams) -> Hydro:
    """Velocity-correction part of hydrovars, given precomputed
    accelerations (used by the blocked/halo path where the stencil runs
    on extended windows)."""
    rho, phi, uf_bar, ug_bar = hbar
    eps = params.div_eps

    nf_vel = _safe_div(xi_f[1:4], rho[None], eps)
    ng_vel = _safe_div(xi_g[1:4], phi[None], eps)

    rho_tot = rho + phi
    wf = phi / rho_tot  # friction weight on species f
    wg = rho / rho_tot
    du = uf_bar - ug_bar + 0.5 * (af - ag)
    uf = uf_bar + 0.5 * af - 0.5 * params.lam_f * wf[None] * du + 0.5 * nf_vel
    ug = ug_bar + 0.5 * ag + 0.5 * params.lam_g * wg[None] * du + 0.5 * ng_vel

    ub = (rho[None] * uf_bar + phi[None] * ug_bar
          + 0.5 * (rho[None] * af + phi[None] * ag)) / rho_tot[None]

    return Hydro(rho=rho, phi=phi, uf=uf, ug=ug, af=af, ag=ag, ub=ub,
                 rho_tot=rho_tot, uf_bar=uf_bar, ug_bar=ug_bar,
                 nf_vel=nf_vel, ng_vel=ng_vel)


def pack(h: Hydro) -> jnp.ndarray:
    """Stack to the 22-component reference output schema (HYDRO_NAMES)."""
    return jnp.concatenate([
        h.rho[None], h.phi[None],
        h.uf,
        h.rho_tot[None],  # "p_bulk" slot holds total density (LBM_binary.H:275)
        h.ug, h.af, h.ag, h.ub,
        h.nf_vel[:1], h.ng_vel[:1], h.uf_bar[:1], h.ug_bar[:1],
    ])


def pack_bar(hbar: HydroBar) -> jnp.ndarray:
    """Modified-variable output (hydrovsbar comps 0-8, LBM_binary.H:329-339)."""
    return jnp.concatenate([
        hbar.rho[None], hbar.phi[None],
        hbar.uf_bar,
        (hbar.rho + hbar.phi)[None],
        hbar.ug_bar,
    ])


def moment_stress(m: jnp.ndarray, eps: float = 1.19209290e-7):
    """Moment-space stress diagnostic — the ``hydrovars(m)`` analog.

    The reference's lattice layer carries a per-cell diagnostic
    (LBM_d3q19.H:258-286) mapping the 19 moments to (rho, j, deviatoric
    stress); it is unused by the drivers but part of the lattice API.
    Here the full pressure tensor P_ab = sum_i f_i c_ia c_ib is obtained
    from the moments through the basis-derived contraction ``PTENS``
    (lattice.py) instead of the reference's hand-unrolled component
    formulas, then the equilibrium part rho cs^2 I + j j / rho is
    subtracted wherever rho exceeds the same FLT_EPSILON guard.

    Args:
      m: moments, shape (19, ...).
    Returns:
      (rho, j, sigma): densities (...), momenta (3, ...), deviatoric
      stress (3, 3, ...).
    """
    from ..lattice import PTENS

    rho = m[0]
    j = m[1:4]
    pt = jnp.asarray(PTENS, m.dtype)
    P = jnp.einsum("kab,k...->ab...", pt, m,
                   precision=jax.lax.Precision.HIGHEST)
    guard = rho > eps
    rho_safe = jnp.where(guard, rho, 1.0)
    eye = jnp.eye(3, dtype=m.dtype).reshape((3, 3) + (1,) * (m.ndim - 1))
    eq = CS2 * rho * eye + j[None, :] * j[:, None] / rho_safe
    return rho, j, jnp.where(guard, P - eq, P)
