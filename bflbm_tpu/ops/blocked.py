"""Extended-block (halo) formulation of the timestep.

The periodic jnp path (:mod:`bflbm_tpu.models.binary_fluid`) wraps every
shift with ``jnp.roll``; on a sharded mesh with explicit halo exchange
(:mod:`bflbm_tpu.parallel.halo`) each shard instead holds a local block
extended by 2 halo cells along the sharded axes and all shifts become
plain slices (with rolls only on unsharded, locally-periodic axes).

Blocks hold POST-COLLIDE populations (stream-then-collide
factorization); one call performs

    pull-stream (interior)        <- consumes 1 halo cell
    densities on the 1-extended window  <- consumes the 2nd halo cell
    gradients + hydro + noise + MRT collide on the interior

so a single 2-deep halo exchange per step suffices (the reference does
~6 FillBoundary calls per step, SURVEY.md §2.6).  Noise normals are
needed on the interior only and are passed in pre-drawn, so the noise
stream stays decomposition-invariant (drawn globally, sharded by XLA).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from ..config import LBMParams
from ..lattice import B, C, CS2, Q, W
from . import collide as collide_ops
from . import hydro as hydro_ops


def _slice_axis(a, ax, lo, n):
    idx = [slice(None)] * a.ndim
    idx[ax] = slice(lo, lo + n)
    return a[tuple(idx)]


def shift_block(arr: jnp.ndarray, cvec, halo_axes: Sequence[bool],
                trim: int, halo: int) -> jnp.ndarray:
    """Evaluate arr at (x + cvec) on the window trimmed to `trim` halo
    cells, given a block with `halo` halo cells on the flagged axes
    (|cvec| + trim <= halo required there); unflagged axes are locally
    periodic and use roll.  Spatial axes are the last three."""
    nd = arr.ndim
    out = arr
    for d in range(3):
        ax = nd - 3 + d
        c = int(cvec[d])
        if halo_axes[d]:
            n_int = arr.shape[ax] - 2 * halo
            lo = halo + c - trim
            out = _slice_axis(out, ax, lo, n_int + 2 * trim)
        else:
            if c != 0:
                out = jnp.roll(out, -c, axis=ax)
    return out


def trim_block(arr: jnp.ndarray, halo_axes: Sequence[bool],
               trim: int, halo: int) -> jnp.ndarray:
    """Cut a `halo`-extended block down to `trim` halo cells."""
    return shift_block(arr, (0, 0, 0), halo_axes, trim, halo)


def step_on_block(f_ext: jnp.ndarray, g_ext: jnp.ndarray,
                  normals_int: jnp.ndarray, params: LBMParams,
                  halo_axes: Sequence[bool]
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One stream+collide on an extended block (post-collide space).

    f_ext, g_ext: (19, ...) post-collide populations, halo 2 on flagged
    axes.  normals_int: (33, interior...) standard normals (ignored when
    kBT == 0; pass an array of the right shape).  Returns post-collide
    interior (f_out, g_out).
    """
    H = 2
    dtype = f_ext.dtype

    # streamed populations on the interior
    fs = jnp.stack([
        shift_block(f_ext[i], -C[i], halo_axes, 0, H) for i in range(Q)])
    gs = jnp.stack([
        shift_block(g_ext[i], -C[i], halo_axes, 0, H) for i in range(Q)])

    # densities of the streamed state on the 1-extended window:
    # rho1(x) = sum_j f_ext[j](x - c_j), x in ext1  (uses both halos)
    def density1(src_ext):
        acc = None
        for j in range(Q):
            t = shift_block(src_ext[j], -C[j], halo_axes, 1, H)
            acc = t if acc is None else acc + t
        return acc

    rho1 = density1(f_ext)
    phi1 = density1(g_ext)

    use_sc, n0 = params.use_sc_pseudo, params.sc_ref_density

    def psi(x):
        return n0 * (1.0 - jnp.exp(-x / n0)) if use_sc else x

    psi_rho1 = psi(rho1)
    psi_phi1 = psi(phi1)

    # 19-point gradient at the interior from the ext1 density fields
    def gradient(ps1):
        comps = [None, None, None]
        for i in range(1, Q):
            nb = shift_block(ps1, C[i], halo_axes, 0, 1)
            wc = float(W[i] / CS2)
            for d in range(3):
                if C[i, d] != 0:
                    t = (wc * float(C[i, d])) * nb
                    comps[d] = t if comps[d] is None else comps[d] + t
        return jnp.stack(comps)

    grad_phi = gradient(psi_phi1)
    grad_rho = gradient(psi_rho1)

    rho = trim_block(rho1, halo_axes, 0, 1)
    phi = trim_block(phi1, halo_axes, 0, 1)
    psi_rho = trim_block(psi_rho1, halo_axes, 0, 1)
    psi_phi = trim_block(psi_phi1, halo_axes, 0, 1)

    eps = params.div_eps

    def safe_div(a, b):
        ok = jnp.abs(b) > eps
        return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)

    hbar = hydro_ops.HydroBar(
        rho=rho, phi=phi,
        uf_bar=safe_div(hydro_ops.momentum(fs), rho[None]),
        ug_bar=safe_div(hydro_ops.momentum(gs), phi[None]),
    )
    af = -CS2 * params.alpha0 * safe_div(psi_rho[None] * grad_phi,
                                         rho[None])
    ag = -CS2 * params.alpha0 * safe_div(psi_phi[None] * grad_rho,
                                         phi[None])

    # noise moments from the supplied normals
    if params.noise_on:
        lam_f, lam_g = params.lam_f, params.lam_g
        pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * params.kBT
        pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * params.kBT
        rhot = rho + phi
        amp_mom = jnp.sqrt(pref_f * jnp.abs(safe_div(rho * phi, rhot)))
        b_ghost = jnp.asarray(B[4:], dtype).reshape(
            (Q - 4,) + (1,) * rho.ndim)
        amp_gf = jnp.sqrt((pref_f / CS2) * b_ghost * jnp.abs(rho)[None])
        amp_gg = jnp.sqrt((pref_g / CS2) * b_ghost * jnp.abs(phi)[None])
        zero = jnp.zeros_like(rho)[None]
        xi_mom = amp_mom[None] * normals_int[:3]
        xi_f = jnp.concatenate([zero, xi_mom, amp_gf * normals_int[3:18]])
        xi_g = jnp.concatenate([zero, -xi_mom, amp_gg * normals_int[18:33]])
    else:
        xi_f = jnp.zeros((Q,) + rho.shape, dtype)
        xi_g = xi_f

    h = hydro_ops.hydrovars_with_acc(fs, gs, hbar, af, ag, xi_f, xi_g,
                                     params)
    f_out, g_out = collide_ops.collide(fs, gs, h, xi_f, xi_g, params)
    return f_out, g_out
