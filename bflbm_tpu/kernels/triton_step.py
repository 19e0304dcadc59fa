"""One fused D3Q19 binary-fluid timestep as a Pallas kernel through Triton.

The jnp engine (:func:`bflbm_tpu.models.binary_fluid.step`) materialises
the moment, equilibrium, noise and streamed-population stacks in device
memory between XLA fusions.  This kernel does the same step in one pass:
each program owns one (x, y-block, z-block) tile of cells and

    loads its cells' 2 x 19 populations (coalesced along z)
      -> densities, bare velocities (factored forward transform)
      -> Shan-Chen force from the neighbours' pseudopotentials
      -> per-mode thermal noise from the coordinate-keyed hash stream
      -> real velocities, equilibrium + Guo forcing moments, MRT relax
      -> back transform with exact-mass telescoping
      -> push-writes the 2 x 19 post-collide populations to x + c_i.

Every target cell and direction is written by exactly one program, so
the push needs no atomics, and the state stays the standard post-stream
:class:`SimState` - the run loop needs no entry/exit conversion.  Read
and write both species once: 304 B/cell in float32.

With ``alpha0``/``alpha1`` != 0 the force needs neighbour densities, so a
small XLA prelude writes the pseudopotential fields (and, for alpha1,
their lattice laplacians) that the kernel reads back through the cache.

Noise is always the hash stream (``ops.noise.hash_channels``) keyed by
the word the jnp prelude derives from the step's RNG split, so the kernel
trajectory equals the jnp engine's ``noise_source="hash"`` trajectory up
to float rounding, with bitwise-equal RNG keys.

Contractions are unrolled adds and multiplies in float32 (no tensor
cores, no TF32).  Block extents are powers of two; extents that a block
does not divide are masked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import LBMParams
from ..lattice import B, C, CS2, Q, W
from ..ops import moments as mom_ops
from ..ops import noise as noise_ops
from ..ops import stencil
from ..state import SimState

# cells and warps per program: two cells per thread.  On an H100 at
# 256^3 (fluctuating mixture) 256 cells x 4 warps ran at 4.33 GLUPS,
# against 4.04 for 256 x 8, 3.53 for 128 x 4 and 4.34 for 512 x 8.
BLOCK_CELLS = 256
NUM_WARPS = 4


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def tile_for(shape, block_cells=None):
    """(BY, BZ): powers of two, BZ up to the z extent, BY filling the
    rest of `block_cells` (default BLOCK_CELLS)."""
    block_cells = block_cells or BLOCK_CELLS
    _, Y, Z = shape
    bz = min(_pow2_at_least(Z), block_cells)
    by = min(_pow2_at_least(Y), max(1, block_cells // bz))
    return by, bz


def _force_fields(f, g, params: LBMParams):
    """(n, X, Y, Z) fields whose neighbour values the kernel's force
    needs: psi(rho), psi(phi) for alpha0, and their 19-point laplacians
    for alpha1 (ops/hydro.py accelerations)."""
    use_sc, n0 = params.use_sc_pseudo, params.sc_ref_density
    psi_rho = stencil.pseudopotential(jnp.sum(f, axis=0), use_sc, n0)
    psi_phi = stencil.pseudopotential(jnp.sum(g, axis=0), use_sc, n0)
    fields = [psi_rho, psi_phi]
    if params.alpha1 != 0.0:
        fields += [stencil.laplacian(psi_rho), stencil.laplacian(psi_phi)]
    return jnp.stack(fields)


def _kernel(params: LBMParams, shape, tile, noise_dist, masked, nfields,
            keys_ref, f_ref, g_ref, *rest):
    if nfields:
        fld_ref, fo_ref, go_ref = rest
    else:
        fo_ref, go_ref = rest
    X, Y, Z = shape
    by, bz = tile
    x = pl.program_id(0)
    y = pl.program_id(1) * by + jax.lax.broadcasted_iota(
        jnp.int32, (by, bz), 0)
    z = pl.program_id(2) * bz + jax.lax.broadcasted_iota(
        jnp.int32, (by, bz), 1)
    if masked:
        valid = (y < Y) & (z < Z)
        y = jnp.minimum(y, Y - 1)
        z = jnp.minimum(z, Z - 1)

    # periodic neighbour coordinates for offsets -1, 0, +1
    xs = ((x + X - 1) % X, x, (x + 1) % X)
    ys = (jnp.where(y == 0, Y - 1, y - 1), y,
          jnp.where(y == Y - 1, 0, y + 1))
    zs = (jnp.where(z == 0, Z - 1, z - 1), z,
          jnp.where(z == Z - 1, 0, z + 1))

    def at(c):
        return xs[c[0] + 1], ys[c[1] + 1], zs[c[2] + 1]

    fp = [f_ref[i, x, y, z] for i in range(Q)]
    gp = [g_ref[i, x, y, z] for i in range(Q)]
    dtype = fp[0].dtype

    exact = params.tau_f == 0.5 and params.tau_g == 0.5
    fwd = mom_ops._eof_mom_c if exact else mom_ops._eof_mom
    mf = fwd(fp)
    mg = fwd(gp)
    rho, phi = mf[0], mg[0]

    eps = params.div_eps

    def safe_inv(v):
        ok = jnp.abs(v) > eps
        return jnp.where(ok, 1.0 / jnp.where(ok, v, 1.0), 0.0)

    inv_rho = safe_inv(rho)
    inv_phi = safe_inv(phi)
    ufb = [mf[d] * inv_rho for d in (1, 2, 3)]
    ugb = [mg[d] * inv_phi for d in (1, 2, 3)]

    # ---- Shan-Chen (+ alpha1 square-gradient) accelerations
    has_force = params.alpha0 != 0.0 or params.alpha1 != 0.0
    if has_force:
        def gradient(k):
            comps = [None, None, None]
            for i, j in stencil._PAIRS:
                diff = (fld_ref[(k,) + at(C[i])]
                        - fld_ref[(k,) + at(C[j])])
                coeff = float(W[i] / CS2)
                for d in range(3):
                    if C[i, d] != 0:
                        t = (coeff * float(C[i, d])) * diff
                        comps[d] = t if comps[d] is None else comps[d] + t
            return comps

        use_sc, n0 = params.use_sc_pseudo, params.sc_ref_density
        psi_rho = stencil.pseudopotential(rho, use_sc, n0)
        psi_phi = stencil.pseudopotential(phi, use_sc, n0)
        a0 = -CS2 * params.alpha0
        gphi, grho = gradient(1), gradient(0)
        af = [a0 * (psi_rho * gd) * inv_rho for gd in gphi]
        ag = [a0 * (psi_phi * gd) * inv_phi for gd in grho]
        if params.alpha1 != 0.0:
            a1 = CS2 * params.alpha1
            af = [v - a1 * gd for v, gd in zip(af, gradient(3))]
            ag = [v - a1 * gd for v, gd in zip(ag, gradient(2))]

    rhot = rho + phi
    inv_rhot = safe_inv(rhot)

    # ---- thermal noise moments (ops/noise.py, LBM_binary.H:113-127)
    lam_f, lam_g = params.lam_f, params.lam_g
    if params.noise_on:
        cell = noise_ops.cell_index(x, y, z, shape)
        keys = [keys_ref[a] for a in range(keys_ref.shape[0])]
        n = noise_ops.hash_channels(cell, keys, dtype, noise_dist)
        pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * params.kBT
        pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * params.kBT
        amp_mom = jnp.sqrt(pref_f * jnp.abs(rho * phi * inv_rhot))
        sq_rho = jnp.sqrt(jnp.abs(rho))
        sq_phi = jnp.sqrt(jnp.abs(phi))
        xi_f = [None] + [amp_mom * n[a] for a in range(3)]
        xi_g = [None] + [-v for v in xi_f[1:]]
        for a in range(4, Q):
            xi_f.append(float(np.sqrt(pref_f / CS2 * B[a]))
                        * sq_rho * n[a - 1])
            xi_g.append(float(np.sqrt(pref_g / CS2 * B[a]))
                        * sq_phi * n[a + 14])

    # ---- real velocities (LBM_binary.H:266-272)
    wf = phi * inv_rhot
    wg = rho * inv_rhot
    uf, ug = [], []
    for d in range(3):
        du = ufb[d] - ugb[d]
        if has_force:
            du = du + 0.5 * (af[d] - ag[d])
        uf_d = ufb[d] - (0.5 * lam_f) * wf * du
        ug_d = ugb[d] + (0.5 * lam_g) * wg * du
        if has_force:
            uf_d = uf_d + 0.5 * af[d]
            ug_d = ug_d + 0.5 * ag[d]
        if params.noise_on:
            uf_d = uf_d + 0.5 * xi_f[1 + d] * inv_rho
            ug_d = ug_d + 0.5 * xi_g[1 + d] * inv_phi
        uf.append(uf_d)
        ug.append(ug_d)
    vb = [(rho * uf[d] + phi * ug[d]) * inv_rhot for d in range(3)]

    # ---- collision in moment space (ops/collide.py, LBM_binary.H:451-516)
    def m_eq(nn, u):
        u2 = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        return [nn, nn * u[0], nn * u[1], nn * u[2], nn * u2,
                nn * (3.0 * u[0] * u[0] - u2),
                nn * (u[1] * u[1] - u[2] * u[2]),
                nn * u[0] * u[1], nn * u[1] * u[2], nn * u[0] * u[2]]

    def m_force(nn, u, a, tau):
        s = 1.0 / (1.0 + 1.0 / (2.0 * tau))
        au = a[0] * u[0] + a[1] * u[1] + a[2] * u[2]
        sn = s * nn
        return [None, sn * a[0], sn * a[1], sn * a[2], 2.0 * sn * au,
                sn * (6.0 * a[0] * u[0] - 2.0 * au),
                2.0 * sn * (a[1] * u[1] - a[2] * u[2]),
                sn * (a[0] * u[1] + a[1] * u[0]),
                sn * (a[1] * u[2] + a[2] * u[1]),
                sn * (a[0] * u[2] + a[2] * u[0])]

    def post_collide(m, nn, u, a, xi, tau):
        eq = m_eq(nn, vb)
        force = m_force(nn, u, a, tau) if has_force else None
        inv_t = 1.0 / (tau + 0.5)
        out = [nn]
        for k in range(1, Q):
            if exact:
                v = eq[k] if k < 10 else None
            elif k < 10:
                v = m[k] + inv_t * (eq[k] - m[k])
            else:
                v = m[k] - inv_t * m[k]
            if force is not None and k < 10:
                v = v + force[k]
            if xi is not None:
                v = xi[k] if v is None else v + xi[k]
            out.append(v)
        if out[10] is None:
            return mom_ops._eof_pops_c10(out[:10])
        return mom_ops._eof_pops(out)

    noise = params.noise_on
    fpost = post_collide(mf, rho, uf, af if has_force else None,
                         xi_f if noise else None, params.tau_f)
    gpost = post_collide(mg, phi, ug, ag if has_force else None,
                         xi_g if noise else None, params.tau_g)

    # ---- push streaming: population i of cell x goes to x + c_i
    for i in range(Q):
        tx, ty, tz = at(C[i])
        if masked:
            # masked lanes also aim outside the array in y, so that no
            # implementation of the masked store can let them collide
            # with a real lane's target
            ty = jnp.where(valid, ty, Y)
            plgpu.store(fo_ref.at[i, tx, ty, tz], fpost[i], mask=valid)
            plgpu.store(go_ref.at[i, tx, ty, tz], gpost[i], mask=valid)
        else:
            fo_ref[i, tx, ty, tz] = fpost[i]
            go_ref[i, tx, ty, tz] = gpost[i]


def make_step(params: LBMParams, shape, dtype=jnp.float32, *,
              noise_dist: str = "clt4", interpret: bool = False):
    """Return step(state) -> state: one kernel timestep (not jitted).

    Consumes the RNG key exactly as ``model.step`` does, and draws the
    noise of ``model.step(..., noise_source="hash",
    noise_dist=noise_dist)``.  interpret=True runs the kernel through the
    Pallas interpreter (CPU tests)."""
    X, Y, Z = shape = tuple(int(n) for n in shape)
    tile = tile_for(shape)
    by, bz = tile
    masked = Y % by != 0 or Z % bz != 0
    nfields = 0
    if params.alpha0 != 0.0 or params.alpha1 != 0.0:
        nfields = 4 if params.alpha1 != 0.0 else 2
    pop = jax.ShapeDtypeStruct((Q,) + shape, dtype)
    call = pl.pallas_call(
        functools.partial(_kernel, params, shape, tile, noise_dist, masked,
                          nfields),
        out_shape=(pop, pop),
        grid=(X, pl.cdiv(Y, by), pl.cdiv(Z, bz)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bflbm_step",
    )
    nwords = noise_ops.HASH_WORDS[noise_dist]

    def step(state: SimState) -> SimState:
        key, sub = jax.random.split(state.key)
        word = (noise_ops.hash_word(sub) if params.noise_on
                else jnp.int32(0))
        keys = noise_ops.hash_counters(word, state.step, nwords)
        args = (keys, state.f, state.g)
        if nfields:
            args += (_force_fields(state.f, state.g, params),)
        f, g = call(*args)
        return SimState(f=f, g=g, key=key, step=state.step + 1)

    return step
