#!/usr/bin/env python
"""First-principles per-mode capillary spectrum from the discrete model.

Round-2 verdict item 8: convert the *explanation* of the measured
per-mode capillary structure (-15%..+13% vs gamma = 0.012162,
ACCEPTANCE.md section C) into a *prediction* with no free parameters.

Method — exact linear response of the production timestep (not a
continuum model):

1. Converge the deterministic flat-interface steady state s* of the
   actual `models/binary_fluid.step` on a (1,1,64) column (the profile
   is x,y-invariant; interfaces at z ~ 16 / 48, interface-fluct
   parameters: alpha0=1.5, kBT=1e-5, rho_lo=0.1, rho_hi=3.0).
2. Linearize the explicit-noise step  s' = F(s, n)  (n = the 33
   standard normals/cell of ops/noise.thermal_noise) at (s*, 0) with
   `jax.linearize`.  Because s* is x,y-invariant and every operator is
   translation-invariant with one-step support <= +-2 cells (19-point
   stencils + pull streaming), the full Jacobian is characterized by
   its response to delta tangents at one (x0, y0): real-space kernels
   K_M[dx, dy] (state->state, 2432x2432 per offset, state = 2 species
   x 19 pops x 64 z) and K_B[dx, dy] (noise->state, 2432x2112).
3. Per transverse mode (kx, ky): M = sum K_M e^{-i(kx dx + ky dy)},
   Bh = sum K_B e^{-i...}; per-step mode noise covariance
   Q = Bh Bh^H / (Nx Ny)  (iid unit normals per cell; mode convention
   u_k = (1/NxNy) sum_x s(x) e^{-ikx}).  The stationary covariance
   solves the discrete Lyapunov equation  S = M S M^H + Q, computed by
   doubling (A <- A^2, Q <- A Q A^H + Q), exact for spectral radius < 1
   (true for every k != 0 mode; conserved modes live at k = 0 only).
4. Project onto the linearized production height estimator
   (observables/interface.interface_height: linear interpolation of the
   rho = 1.55 upper crossing; drho = sum_i df_i), giving the
   height-amplitude covariance  S2D(kx, ky) = l^H S l.  The reference's
   single-slice backward-norm FFT spectrum is then EXACTLY

       S_slice(ky) = Ny^2 * sum_{kx in 2 pi n / 8} S2D(kx, ky)

   (cross-kx terms vanish by translation invariance), and the
   x-averaged channel is  S_xavg(ky) = Ny^2 * S2D(0, ky).
   gamma_m = kBT / (S k_m^2) exactly as in acceptance.py phase C.

Everything—forces, finite interface width, the two coupled interfaces,
the conserved order parameter, lattice dispersion, the estimator's
finite-width sampling of the profile—is inherited from the production
code via jvp; the only approximation is linearization in the noise
amplitude (O(sqrt(kBT)) relative corrections).

An exact finite-time cross-check (stage `validate`) computes
E[|h_hat(k)|^2] after t noisy steps both by adjoint (vjp) propagation
through the real-space step — no mode decomposition at all — and from
the mode-space representation, validating every kernel, phase and
normalization in the chain to float64 accuracy.

Stages (cached in out/capillary_model/): profile, kernels, reduce,
validate, modes, report.  Run CPU-only:
    JAX_PLATFORMS=cpu python benchmarks/capillary_model.py all

Reference anchors: Flat_Interface.ipynb cells 5-10 (geometry +
estimator), LBM_binary.H:73-132 (noise), gamma_ref = 0.012162 (BVP
theory constant, surface_tension_predict).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from bflbm_tpu.config import LBMParams  # noqa: E402
from bflbm_tpu.lattice import Q as NQ  # noqa: E402
from bflbm_tpu.models import binary_fluid as model  # noqa: E402
from bflbm_tpu.ops import collide as collide_ops  # noqa: E402
from bflbm_tpu.ops import hydro as hydro_ops  # noqa: E402
from bflbm_tpu.ops import noise as noise_ops  # noqa: E402
from bflbm_tpu.ops import stream as stream_ops  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "out", "capillary_model")
PARAMS = LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
NZ = 64
LEVEL = 0.5 * (PARAMS.rho_lo + PARAMS.rho_hi)
NX_PHYS, NY_PHYS = 8, 256          # the production 8 x 256 x 64 stripe
GAMMA_REF = 0.012162
KBT = PARAMS.kBT
SUP = 2                            # one-step spatial support (stencil+stream)
NSTATE = 2 * NQ * NZ               # 2432
NNOISE = 33 * NZ                   # 2112
MODES_TABLE = (1, 2, 3, 5, 8)      # the ACCEPTANCE per-mode table
MODES_XAVG = tuple(range(1, 13))   # xavg plateau prediction


def step_explicit(fg, n, params=PARAMS):
    """The production step with the noise normals passed explicitly.

    Mirrors models/binary_fluid.step + ops/noise.thermal_noise with the
    33 unit normals per cell as an argument instead of a threefry draw
    (mass mode zero; momentum modes shared anti-correlated; 15 ghost
    modes per species)."""
    f, g = fg
    hbar = hydro_ops.hydrovars_bar(f, g, params)
    amp_mom, amp_gf, amp_gg = noise_ops.noise_amplitudes(
        hbar.rho, hbar.phi, params, f.dtype)
    zero = jnp.zeros((1,) + f.shape[1:], f.dtype)
    xi_mom = amp_mom[None] * n[:3]
    xi_f = jnp.concatenate([zero, xi_mom, amp_gf * n[3:18]])
    xi_g = jnp.concatenate([zero, -xi_mom, amp_gg * n[18:33]])
    h = hydro_ops.hydrovars(f, g, xi_f, xi_g, params, hbar)
    f1, g1 = collide_ops.collide(f, g, h, xi_f, xi_g, params)
    return (stream_ops.stream(f1), stream_ops.stream(g1))


# ---------------------------------------------------------------------------
# Stage 1: deterministic steady profile on a (1,1,64) column
# ---------------------------------------------------------------------------

def stage_profile():
    st = model.init_stripe((1, 1, NZ), PARAMS, dtype=jnp.float64)
    fg = (st.f, st.g)
    zero_n = jnp.zeros((33, 1, 1, NZ), jnp.float64)

    @jax.jit
    def chunk(fg):
        def body(c, _):
            return step_explicit(c, zero_n), None
        out, _ = jax.lax.scan(body, fg, None, length=2000)
        return out

    t0 = time.time()
    res = None
    for it in range(100):
        fg_new = chunk(fg)
        res = max(float(jnp.max(jnp.abs(fg_new[0] - fg[0]))),
                  float(jnp.max(jnp.abs(fg_new[1] - fg[1]))))
        fg = fg_new
        if res < 1e-14:
            break
    steps = 2000 * (it + 1)
    rho = np.asarray(jnp.sum(fg[0], axis=0))[0, 0]
    # crossing cell of the upper interface (rho decreasing through LEVEL)
    s = rho - LEVEL
    ks = [k for k in range(NZ - 1) if s[k] > 0 >= s[k + 1]]
    assert len(ks) == 1, ks
    k0 = ks[-1]
    np.savez(os.path.join(OUT, "profile.npz"),
             f=np.asarray(fg[0]), g=np.asarray(fg[1]), rho=rho,
             k0=k0, steps=steps, residual=res)
    print(json.dumps({"stage": "profile", "steps": steps, "residual": res,
                      "k0": int(k0), "rho_k0": float(rho[k0]),
                      "rho_k1": float(rho[k0 + 1]),
                      "wall_s": round(time.time() - t0, 1)}))


def load_profile():
    d = np.load(os.path.join(OUT, "profile.npz"))
    return d["f"], d["g"], int(d["k0"]), d["rho"]


def estimator_vector(rho, k0):
    """Linearization of interface_height at the base profile.

    h = k0 + s0/(s0 - s1), s = rho - LEVEL  ->
    dh = (-s1 drho0 + s0 drho1) / (s0 - s1)^2, drho = sum_i df_i."""
    s0 = rho[k0] - LEVEL
    s1 = rho[k0 + 1] - LEVEL
    den = (s0 - s1) ** 2
    w = np.zeros(NZ)
    w[k0] = -s1 / den
    w[k0 + 1] = s0 / den
    l = np.zeros(NSTATE)
    for a in range(NQ):                      # drho = sum over f pops only
        l[a * NZ:(a + 1) * NZ] = w
    return l, w


# ---------------------------------------------------------------------------
# Stage 2: one-step response kernels K_M[dx,dy], K_B[dx,dy] by jvp
# ---------------------------------------------------------------------------

def stage_kernels():
    f1, g1, k0, rho = load_profile()
    nx = ny = 2 * SUP + 4                      # 8: no wrap ambiguity
    x0 = y0 = nx // 2
    base = (jnp.asarray(np.broadcast_to(f1, (NQ, nx, ny, NZ))),
            jnp.asarray(np.broadcast_to(g1, (NQ, nx, ny, NZ))))
    zero_n = jnp.zeros((33, nx, ny, NZ), jnp.float64)

    prim, lin = jax.linearize(step_explicit, base, zero_n)
    # fixed-point sanity on the tiled domain
    fp = max(float(jnp.max(jnp.abs(prim[0] - base[0]))),
             float(jnp.max(jnp.abs(prim[1] - base[1]))))
    assert fp < 1e-12, fp
    lin = jax.jit(lin)

    offs = range(-SUP, SUP + 1)
    t0 = time.time()

    def collect(n_basis, make_tangent, chunk=128):
        """Apply lin to delta tangents; return K[(2*SUP+1)^2, NSTATE, n]."""
        K = np.zeros(((2 * SUP + 1) ** 2, NSTATE, n_basis))
        far = 0.0
        for c0 in range(0, n_basis, chunk):
            idx = list(range(c0, min(c0 + chunk, n_basis)))
            ts, tn = make_tangent(idx)
            df, dg = jax.vmap(lin)(ts, tn)
            out = np.concatenate([np.asarray(df), np.asarray(dg)], axis=1)
            # out: (b, 38, nx, ny, NZ)
            mask = np.ones((nx, ny), bool)
            for dx in offs:
                for dy in offs:
                    mask[(x0 + dx) % nx, (y0 + dy) % ny] = False
            far = max(far, float(np.abs(out[:, :, mask, :]).max()))
            for oi, dx in enumerate(offs):
                for oj, dy in enumerate(offs):
                    blk = out[:, :, (x0 + dx) % nx, (y0 + dy) % ny, :]
                    # blk: (b, 38, NZ) -> rows (a*NZ+z), cols b
                    K[oi * (2 * SUP + 1) + oj, :, idx] = \
                        blk.reshape(len(idx), NSTATE)
        return K, far

    def tang_state(idx):
        ts_f = np.zeros((len(idx), NQ, nx, ny, NZ))
        ts_g = np.zeros((len(idx), NQ, nx, ny, NZ))
        for r, b in enumerate(idx):
            a, z = divmod(b, NZ)
            if a < NQ:
                ts_f[r, a, x0, y0, z] = 1.0
            else:
                ts_g[r, a - NQ, x0, y0, z] = 1.0
        return ((jnp.asarray(ts_f), jnp.asarray(ts_g)),
                jnp.zeros((len(idx), 33, nx, ny, NZ)))

    def tang_noise(idx):
        tn = np.zeros((len(idx), 33, nx, ny, NZ))
        for r, b in enumerate(idx):
            ch, z = divmod(b, NZ)
            tn[r, ch, x0, y0, z] = 1.0
        zf = jnp.zeros((len(idx), NQ, nx, ny, NZ))
        return ((zf, zf), jnp.asarray(tn))

    KM, farM = collect(NSTATE, tang_state)
    KB, farB = collect(NNOISE, tang_noise)
    assert farM < 1e-12 and farB < 1e-12, (farM, farB)
    np.savez(os.path.join(OUT, "kernels.npz"), KM=KM, KB=KB,
             sup=SUP, farM=farM, farB=farB)
    print(json.dumps({"stage": "kernels", "farM": farM, "farB": farB,
                      "KM_bytes": KM.nbytes, "wall_s":
                      round(time.time() - t0, 1)}))


def load_kernels():
    d = np.load(os.path.join(OUT, "kernels.npz"))
    return d["KM"], d["KB"]


def phases(kx, ky):
    offs = np.arange(-SUP, SUP + 1)
    return np.exp(-1j * (kx * offs[:, None] +
                         ky * offs[None, :])).reshape(-1)


# ---------------------------------------------------------------------------
# Stage 2b: rank reduction.  With the preset's tau_f = tau_g = 1/2 the
# MRT rate lam = 1/(tau + 1/2) = 1 exactly: the collision has ZERO
# memory — every post-collide moment is a function of the conserved
# hydro fields (rho, phi, j_f, j_g: 8 per cell) plus noise.  Hence the
# one-step mode Jacobian factors exactly as M = C H, where H extracts
# the 8 x NZ = 512 hydro fields (local, mode-independent) and
# C = M H^+.  The Lyapunov solve then lives in the 512-dim hydro space:
#     h_{t+1} = A h_t + (H Bh) n_t,  A = H C = H M H^+,
#     Sigma_s  = C Sigma_h C^H + Bh Bh^H / N.
# The factorization is VERIFIED numerically per run (|M - C H| ~ 0).
# ---------------------------------------------------------------------------

NH = 8 * NZ


def hydro_extractor():
    """H (NH x NSTATE): per z, rows = [rho; jfx; jfy; jfz; phi; jgx..]."""
    from bflbm_tpu.lattice import C as CVEC

    cv = np.asarray(CVEC, float)              # (3, 19) or (19, 3)?
    if cv.shape == (NQ, 3):
        cv = cv.T
    H = np.zeros((NH, NSTATE))
    for z in range(NZ):
        for a in range(NQ):
            H[0 * NZ + z, a * NZ + z] = 1.0                    # rho
            H[4 * NZ + z, (NQ + a) * NZ + z] = 1.0             # phi
            for d in range(3):
                H[(1 + d) * NZ + z, a * NZ + z] = cv[d, a]     # j_f
                H[(5 + d) * NZ + z, (NQ + a) * NZ + z] = cv[d, a]
    gram = H @ H.T                            # block-diagonal, tiny
    Hp = H.T @ np.linalg.inv(gram)            # right inverse H Hp = I
    return H, Hp


def stage_reduce():
    """Precompute per-offset reduced operators + factorization check."""
    KM, KB = load_kernels()
    H, Hp = hydro_extractor()
    _, _, k0, rho = load_profile()
    l, _ = estimator_vector(rho, k0)
    t0 = time.time()
    noff = (2 * SUP + 1) ** 2
    HK = np.stack([H @ KM[o] for o in range(noff)])       # (25, NH, NSTATE)
    G = np.einsum("onm,mh->onh", HK, Hp)                  # A pieces (25,NH,NH)
    HB = np.stack([H @ KB[o] for o in range(noff)])       # (25, NH, NNOISE)
    ml = np.stack([KM[o].T @ l for o in range(noff)])     # M^T l pieces
    bl = np.stack([KB[o].T @ l for o in range(noff)])     # B^T l pieces
    # exact-factorization check on a representative mode
    kx, ky = 2 * np.pi / NX_PHYS, 2 * np.pi * 3 / NY_PHYS
    ph = phases(kx, ky)
    M = np.einsum("o,onm->nm", ph, KM)
    C = M @ Hp
    resid = float(np.abs(M - C @ (H.astype(complex))).max() /
                  np.abs(M).max())
    assert resid < 1e-10, resid
    np.savez(os.path.join(OUT, "reduced.npz"), G=G, HB=HB, ml=ml, bl=bl,
             H=H, Hp=Hp, resid=resid)
    print(json.dumps({"stage": "reduce", "factorization_resid": resid,
                      "wall_s": round(time.time() - t0, 1)}))


def load_reduced():
    d = np.load(os.path.join(OUT, "reduced.npz"))
    return d["G"], d["HB"], d["ml"], d["bl"], d["H"], d["Hp"]


def reduced_mode(G, HB, ml, bl, Hp, kx, ky):
    """(A, Bh_h, w, direct): reduced dynamics, observable w = C^H l in
    hydro space, and the direct (same-step noise) term l^H B B^H l/N."""
    ph = phases(kx, ky)
    A = np.einsum("o,onh->nh", ph, G)
    Bh = np.einsum("o,onb->nb", ph, HB)
    Ml = np.einsum("o,on->n", ph.conj(), ml)      # M^H l
    w = Hp.T @ Ml                                 # C^H l = Hp^H M^H l
    Bl = np.einsum("o,on->n", ph.conj(), bl)      # B^H l
    direct = float(np.real(Bl.conj() @ Bl))
    return A, Bh, w, direct


def solve_mode(G, HB, ml, bl, Hp, kx, ky, norm, jmax=26, tol=1e-12):
    """s = l^H Sigma_s l by doubling in the 512-dim hydro space, plus
    dyadic autocorrelation samples c(t=2^j+1) for finite-window
    modeling.  norm = Nx*Ny of the physical domain."""
    A0, Bh, w, direct = reduced_mode(G, HB, ml, bl, Hp, kx, ky)
    Q = (Bh @ Bh.conj().T) / norm
    A = A0
    vs = [w]
    s_prev = None
    anorm = np.inf
    for j in range(jmax):
        vs.append(A.conj().T @ vs[-1])
        Q = Q + A @ Q @ A.conj().T
        A = A @ A
        s_now = float(np.real(w.conj() @ (Q @ w)))
        anorm = float(np.abs(A).max())
        if s_prev is not None and abs(s_now - s_prev) <= tol * max(
                abs(s_now), 1e-300) and anorm < 1e-8:
            break
        s_prev = s_now
    Sh = Q
    s_stat = float(np.real(w.conj() @ (Sh @ w))) + direct / norm
    # c(t) = w^H A^(t-1) Sigma_h A^(t-1)H w at t-1 = 2^j
    cs = [float(np.real(v.conj() @ (Sh @ v))) for v in vs[1:]]
    return s_stat, np.array(cs), j + 1, anorm


# ---------------------------------------------------------------------------
# Stage 3: the production-geometry mode table
# ---------------------------------------------------------------------------

def stage_modes():
    G, HB, ml, bl, H, Hp = load_reduced()
    kxs = 2.0 * np.pi * np.arange(5) / NX_PHYS      # n = 0..4; n and 8-n
    kx_w = np.array([1.0, 2.0, 2.0, 2.0, 1.0])      # conjugate pairs
    norm = NX_PHYS * NY_PHYS
    res = {}
    t00 = time.time()
    todo = sorted(set(MODES_TABLE) | set(MODES_XAVG))
    for m in todo:
        ky = 2.0 * np.pi * m / NY_PHYS
        per_kx = []
        nlist = range(5) if m in MODES_TABLE else [0]
        for n in nlist:
            t0 = time.time()
            s, cs, iters, anorm = solve_mode(G, HB, ml, bl, Hp,
                                             kxs[n], ky, norm)
            per_kx.append(s)
            res[f"m{m}_n{n}"] = {"s2d": s, "iters": iters,
                                 "anorm": anorm, "c_dyadic": cs.tolist(),
                                 "wall_s": round(time.time() - t0, 1)}
            print(json.dumps({"mode": [m, n], "s2d": s, "iters": iters,
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)
        if m in MODES_TABLE:
            s_slice = NY_PHYS ** 2 * float(np.sum(kx_w * np.array(per_kx)))
            res[f"m{m}_slice"] = s_slice
        res[f"m{m}_xavg"] = NY_PHYS ** 2 * per_kx[0]
    res["wall_s"] = round(time.time() - t00, 1)
    with open(os.path.join(OUT, "modes.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"stage": "modes", "wall_s": res["wall_s"]}))


# ---------------------------------------------------------------------------
# Stage 4: exact finite-time validation of the whole chain.
#
# On an (8,8,64) domain, E[|h_hat(k_m)|^2] after t noisy steps from the
# deterministic state is computed two independent ways:
#   (real space)  adjoint propagation with jax.vjp through the actual
#                 step: E[O^2] = sum_{j<t} |B^T M^T^j u0|^2 for the
#                 cos/sin quadratures u0 of the slice-FFT height
#                 observable — no mode decomposition, no kernels;
#   (mode space)  Ny^2 sum_kx l^H Sigma_t l with Sigma_t from the
#                 reduced representation (Sigma_h(t) = A Sigma A^H + Q).
# Agreement validates kernels, phases, the 1/(Nx Ny) normalization, the
# hydro-rank reduction, and the estimator projection end to end.
# ---------------------------------------------------------------------------

def stage_validate(tmax=6):
    f1, g1, k0, rho = load_profile()
    nx, ny = 8, 8
    base = (jnp.asarray(np.broadcast_to(f1, (NQ, nx, ny, NZ))),
            jnp.asarray(np.broadcast_to(g1, (NQ, nx, ny, NZ))))
    zero_n = jnp.zeros((33, nx, ny, NZ), jnp.float64)
    l, w = estimator_vector(rho, k0)
    _, vjp = jax.vjp(step_explicit, base, zero_n)
    vjp = jax.jit(vjp)

    t0 = time.time()
    out = {"stage": "validate", "tmax": tmax}
    G, HB, ml, bl, H, Hp = load_reduced()
    kxs = 2.0 * np.pi * np.arange(5) / nx
    kx_w = np.array([1.0, 2.0, 2.0, 2.0, 1.0])
    worst = 0.0
    for m in (1, 2):
        kym = 2.0 * np.pi * m / ny
        # real space: two quadratures of the slice-FFT observable
        yy = np.arange(ny)
        acc = 0.0
        for quad in (np.cos, lambda a: -np.sin(a)):
            u0f = np.zeros((NQ, nx, ny, NZ))
            u0f[:, 4, :, :] = quad(kym * yy)[None, :, None] * w[None, None, :]
            cot = (jnp.asarray(u0f), jnp.zeros_like(base[1]))
            for j in range(tmax):
                ds, dn = vjp(cot)
                acc += float(jnp.sum(dn * dn))
                cot = ds
        # mode space, reduced representation
        tot = 0.0
        for n in range(5):
            A, Bh, wv, direct = reduced_mode(G, HB, ml, bl, Hp, kxs[n], kym)
            Q = (Bh @ Bh.conj().T) / (nx * ny)
            Sh = np.zeros_like(Q)
            s_t = direct / (nx * ny)          # j = 0 (same-step noise) term
            for j in range(tmax - 1):
                Sh = A @ Sh @ A.conj().T + Q
                # after t steps: Sigma_s(t) = C Sigma_h(t-1) C^H + BB^H/N
            s_t += float(np.real(wv.conj() @ (Sh @ wv)))
            tot += kx_w[n] * s_t
        pred = ny ** 2 * tot
        rel = abs(acc / pred - 1.0)
        worst = max(worst, rel)
        out[f"m{m}"] = {"real_space": acc, "mode_space": pred,
                        "rel_dev": rel}
    # doubling-vs-direct-sum consistency (same mode, reduced space)
    A, Bh, wv, direct = reduced_mode(G, HB, ml, bl, Hp, kxs[1],
                                     2 * np.pi / ny)
    Q = (Bh @ Bh.conj().T) / (nx * ny)
    Sd = np.zeros_like(Q)
    for j in range(32):
        Sd = A @ Sd @ A.conj().T + Q
    direct_32 = float(np.real(wv.conj() @ (Sd @ wv)))
    Ad, Qd = A.copy(), Q.copy()
    for j in range(5):                        # 2^5 = 32 terms
        Qd = Qd + Ad @ Qd @ Ad.conj().T
        Ad = Ad @ Ad
    dbl_32 = float(np.real(wv.conj() @ (Qd @ wv)))
    out["doubling_check_rel"] = abs(dbl_32 / direct_32 - 1.0)
    out["wall_s"] = round(time.time() - t0, 1)
    ok = worst < 1e-8 and out["doubling_check_rel"] < 1e-10
    out["ok"] = bool(ok)
    with open(os.path.join(OUT, "validate.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    assert ok, out


# ---------------------------------------------------------------------------
# Stage 5: report — predicted vs measured gamma_m
# ---------------------------------------------------------------------------

MEASURED = {  # ACCEPTANCE.md section C, 24-run ensemble (mean, stderr)
    1: (0.010345, 0.000236), 2: (0.013216, 0.000107),
    3: (0.013767, 0.000091), 5: (0.013564, 0.000120),
    8: (0.012137, 0.000073),
}


def stage_report():
    with open(os.path.join(OUT, "modes.json")) as fh:
        res = json.load(fh)
    rows = []
    for m in MODES_TABLE:
        ky = 2.0 * np.pi * m / NY_PHYS
        g_pred = KBT / (res[f"m{m}_slice"] * ky ** 2)
        g_xavg = KBT / (res[f"m{m}_xavg"] * ky ** 2)
        meas, err = MEASURED[m]
        rows.append({"m": m, "gamma_pred_slice": round(g_pred, 6),
                     "gamma_pred_xavg": round(g_xavg, 6),
                     "gamma_measured": meas, "stderr": err,
                     "pred_vs_ref_pct": round(100 * (g_pred / GAMMA_REF - 1), 2),
                     "meas_vs_ref_pct": round(100 * (meas / GAMMA_REF - 1), 2),
                     "pred_vs_meas_sigma":
                         round((g_pred - meas) / err, 2)})
    xavg_curve = {m: round(KBT / (res[f"m{m}_xavg"] *
                                  (2 * np.pi * m / NY_PHYS) ** 2) /
                           GAMMA_REF, 4)
                  for m in MODES_XAVG}
    rep = {"table": rows, "xavg_gamma_over_ref": xavg_curve}
    with open(os.path.join(OUT, "report.json"), "w") as fh:
        json.dump(rep, fh, indent=1)
    print(json.dumps(rep, indent=1))


# ---------------------------------------------------------------------------
# Stage 6: compare the stationary prediction against the real nonlinear
# accelerator run of benchmarks/capillary_nl_check.py (8 x 64 x 64; its ky modes
# m' = 1..3 sit at the production m = 4, 8, 12 wavenumbers).
# ---------------------------------------------------------------------------

def stage_nlcompare():
    d = np.load(os.path.join(OUT, "nl_check.npz"))
    G, HB, ml, bl, H, Hp = load_reduced()
    ny = 64
    kxs = 2.0 * np.pi * np.arange(5) / NX_PHYS
    kx_w = np.array([1.0, 2.0, 2.0, 2.0, 1.0])
    norm = NX_PHYS * ny
    out = {"stage": "nlcompare", "n_frames": int(d["n_frames"]),
           "steps": int(d["steps"])}
    T = int(d["n_frames"])
    for m in (1, 2, 3):
        ky = 2.0 * np.pi * m / ny
        per_kx = []
        for n in range(5):
            s, _, _, _ = solve_mode(G, HB, ml, bl, Hp, kxs[n], ky, norm)
            per_kx.append(s)
        pred_slice = ny ** 2 * float(np.sum(kx_w * np.array(per_kx)))
        pred_xavg = ny ** 2 * per_kx[0]
        # statistical error of the measured spectrum from the mode
        # series' own autocorrelation (chi^2 with T/g dof)
        res = {}
        for ch, name, pred in ((d["hk_slice"][:, m], "slice", pred_slice),
                               (d["hk_xavg"][:, m], "xavg", pred_xavg)):
            a = ch - ch.mean()
            var = float(np.mean(np.abs(a) ** 2))
            # integrated autocorrelation (initial-positive-sequence)
            g = 1.0
            c0 = var
            for lag in range(1, T // 4):
                rho_l = float(np.real(np.mean(
                    a[lag:] * np.conj(a[:-lag])))) / c0
                if rho_l <= 0:
                    break
                g += 2.0 * (1.0 - lag / T) * rho_l
            stderr = var * np.sqrt(2.0 * g / T)
            res[name] = {
                "measured": var, "pred": pred, "g": round(g, 1),
                "ratio": round(var / pred, 4),
                "dev_sigma": round((var - pred) / stderr, 2)}
        out[f"m{m}"] = res
    with open(os.path.join(OUT, "nlcompare.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))


STAGES = {"profile": stage_profile, "kernels": stage_kernels,
          "reduce": stage_reduce, "validate": stage_validate,
          "modes": stage_modes, "report": stage_report,
          "nlcompare": stage_nlcompare}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stages", nargs="+",
                    help=f"{list(STAGES)} or 'all'")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    names = list(STAGES) if args.stages == ["all"] else args.stages
    for name in names:
        STAGES[name]()


if __name__ == "__main__":
    main()
