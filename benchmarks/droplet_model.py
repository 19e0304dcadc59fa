#!/usr/bin/env python
"""First-principles droplet shape-fluctuation spectrum.

Round-2 verdict "weak" item 7: the principal-axis shape route of
acceptance phase F was qualitative-only (gamma_(2,0) ~ 0.998 with no
reference number to anchor), and the zeta_20 variance had no
independent prediction.  This module predicts BOTH from exact linear
response of the production timestep around the deterministic
equilibrium droplet — the droplet-geometry analog of
benchmarks/capillary_model.py (which closed the flat-interface per-mode
structure to <1%).

Method.  The droplet breaks translation invariance, so there is no
per-mode factorization: the Jacobian is a 2*19*32^3-dim operator.  But
every acceptance-F observable is a SCALAR functional o = l^T dstate of
the state, so its stationary variance under the fluctuating step
s' = F(s, n) (n = the 33 unit normals/cell of ops/noise.thermal_noise)
is the adjoint sum

    Var(o)      = sum_{j>=0} || B^T (M^T)^j l ||^2 ,
    Cov(o_a,o_b)= sum_{j>=0} ( B^T (M^T)^j l_a ) . ( B^T (M^T)^j l_b ),

with M = dF/ds, B = dF/dn at (s*, 0) — evaluated matrix-free by
iterating one `jax.vjp` of the production step per term (the same
identity benchmarks/capillary_model.py:stage_validate verifies against
the mode-space Lyapunov solution to 1e-16 on the flat interface).  The
sum converges geometrically because every observable below is
translation-invariant (the extraction re-centers on the COM), so l is
orthogonal to the droplet's neutral translation modes and the noise
they absorb (the COM Brownian motion measured in acceptance phase E)
never enters.

Observables (the exact phase-F measurement pipeline, linearized):

  zeta_lm   l<=2 spherical-harmonic surface amplitudes from the
            ray/Gauss-Legendre radius map about the background-
            subtracted COM (observables/droplet.surface_radius_map +
            spherical_harmonic_amplitudes, frozen-bracket crossing);
  S_ab      the 6 gyration-tensor components (full rho, minimum-image
            about the COM — observables/droplet.gyration_tensor).

The principal-axis route (sorted eigenvalues -> semi-axes -> the
notebook's gamma_(2,0)/gamma_(2,+-2) equipartition sums) is NOT a
differentiable function at the equilibrium droplet — the gyration
tensor is degenerate (three equal eigenvalues), so sorted eigenvalues
respond nonlinearly to ANY perturbation.  Stage `mc` therefore samples
Gaussian gyration tensors from the predicted 6x6 covariance and pushes
them through the exact nonlinear eig/axes/equipartition pipeline,
giving parameter-free predictions for the measured axis variances and
gamma_(2,0)/gamma_(2,2) — quantifying exactly why the idealized
equipartition fails (it assumes independent harmonic zeta_2m modes, not
sorted eigenvalues of a noisy near-degenerate tensor).

Stages (artifacts in out/droplet_model/):
  profile   refine out/acceptance2/droplet-r0.25/checkpoint0020000 (the
            exact state phase F's trajectories branch from) to the
            deterministic fixed point; freeze extraction constants.
  adjoint   accelerator f32: the 15x15 stationary covariance by batched adjoint
            propagation (lax.scan chunks; early stop on convergence).
  validate  CPU f64 (run with --cpu): recompute the
            first-200-step partial Gram in float64 at the same
            linearization point; bounds the f32 arithmetic error.
  mc        numpy: sorted-eig / axes / gamma predictions from the
            gyration covariance (400k Gaussian samples).
  report    predicted vs the two measured 2013-frame phase-F
            trajectories (out/acceptance2/droplet-shapefluct*/).

Reference anchors: Droplet_Fluctuation.ipynb cells 21-41 (trajectory,
gyration/axes equipartition cells 24-25, zeta_20 cells 32-39),
LBM_hydrovs.H:258-335 (fittingDropletCovariance), LBM_binary.H:73-132
(noise model).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def _is_cpu_stage(stage):
    return stage in ("validate",)


import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "out", "droplet_model")
EQ_CKPT = os.path.join(ROOT, "out", "acceptance2", "droplet-r0.25",
                       "checkpoint0020000.npz")
MEASURED = [os.path.join(ROOT, "out", acc, d, "shapefluct.npz")
            # acceptance2 = round-2 trajectories (carry the coherent f32
            # mass drift, +1.7% mass_f over 1.15M steps — ACCEPTANCE
            # "[r3] Exact-mass collision"); acceptance3 = drift-free
            # re-measurement with the exact-mass engine
            for acc in ("acceptance2", "acceptance3")
            for d in ("droplet-shapefluct", "droplet-shapefluct-777000")]

KBT = 1e-5
SHAPE = (32, 32, 32)
NT, NP = 32, 64          # the production _sphere_grid default
NR, R_LO, R_HI = 256, 0.5, 15.0   # surface_radius_map ray sampling
LMAX = 2

OBS_NAMES = ["zeta00", "zeta10", "Re_zeta11", "Im_zeta11", "zeta20",
             "Re_zeta21", "Im_zeta21", "Re_zeta22", "Im_zeta22",
             "Sxx", "Syy", "Szz", "Sxy", "Sxz", "Syz"]
IDX_Z20 = OBS_NAMES.index("zeta20")
IDX_GYR = slice(9, 15)


def make_params():
    from bflbm_tpu.config import LBMParams
    return LBMParams(alpha0=1.5, kBT=KBT, kappa=0.1, rho_lo=0.0,
                     rho_hi=3.0)


def step_explicit(fg, n, params):
    """The production step with the 33 unit normals passed explicitly
    (mirrors models/binary_fluid.step + ops/noise.thermal_noise: mass
    mode zero, 3 shared anti-correlated momentum modes, 15 ghost modes
    per species) — same construction as capillary_model.step_explicit,
    dtype-generic."""
    from bflbm_tpu.ops import collide as collide_ops
    from bflbm_tpu.ops import hydro as hydro_ops
    from bflbm_tpu.ops import noise as noise_ops
    from bflbm_tpu.ops import stream as stream_ops

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
# Extraction geometry (constants on the production Gauss-Legendre grid)
# ---------------------------------------------------------------------------

def sphere_grid():
    from bflbm_tpu.observables.droplet import _sphere_grid
    theta, phi, w = _sphere_grid(NT, NP)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                     np.cos(tt)], axis=-1)
    w2 = np.broadcast_to(w[:, None], (NT, NP))
    return tt, pp, w2, dirs


def ylm_tables():
    """(name, Re/Im Y_lm grid, normalization) rows for the zeta
    observables, exactly spherical_harmonic_amplitudes' convention
    zeta_lm = sum(R conj(Y) w) / sum(|Y|^2 w)."""
    from scipy.special import sph_harm_y
    tt, pp, w2, _ = sphere_grid()
    rows = []
    for l, m, part, name in [(0, 0, "re", "zeta00"), (1, 0, "re", "zeta10"),
                             (1, 1, "re", "Re_zeta11"),
                             (1, 1, "im", "Im_zeta11"),
                             (2, 0, "re", "zeta20"),
                             (2, 1, "re", "Re_zeta21"),
                             (2, 1, "im", "Im_zeta21"),
                             (2, 2, "re", "Re_zeta22"),
                             (2, 2, "im", "Im_zeta22")]:
        ylm = sph_harm_y(l, m, tt, pp)
        den = float(np.sum(np.abs(ylm) ** 2 * w2))
        # zeta = sum(R conj(Y) w)/den; Re/Im parts are linear in R with
        # kernels Re(conj Y) w/den and Im(conj Y) w/den
        kern = np.conj(ylm) * w2 / den
        rows.append((name, (kern.real if part == "re" else kern.imag)))
    assert [r[0] for r in rows] == OBS_NAMES[:9]
    return rows


def cell_coords_np():
    idx = np.moveaxis(np.indices(SHAPE), 0, -1).astype(float)
    return idx - np.asarray(SHAPE) / 2.0 + 0.5


# ---------------------------------------------------------------------------
# Differentiable estimator (frozen crossing brackets)
# ---------------------------------------------------------------------------

def trilinear_periodic(field, pts):
    """jnp trilinear interpolation with periodic wrap (the jax twin of
    observables/droplet._trilinear_periodic)."""
    shape = jnp.asarray(field.shape, pts.dtype)
    p = jnp.mod(pts, shape)
    i0 = jnp.floor(p).astype(jnp.int32)
    frac = p - i0.astype(pts.dtype)
    out = jnp.zeros(p.shape[:-1], field.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = ((i0[..., 0] + dx) % field.shape[0],
                       (i0[..., 1] + dy) % field.shape[1],
                       (i0[..., 2] + dz) % field.shape[2])
                w = (jnp.where(dx, frac[..., 0], 1 - frac[..., 0])
                     * jnp.where(dy, frac[..., 1], 1 - frac[..., 1])
                     * jnp.where(dz, frac[..., 2], 1 - frac[..., 2]))
                out = out + w * field[idx]
    return out


def freeze_extraction(rho_star):
    """Constants the linearized estimator holds fixed: the interface
    level (0.5*(min+max) of the steady profile — the per-frame level's
    fluctuation is a common-mode l=0 shift that the Y_lm l>=1
    projections annihilate) and the per-ray crossing bracket index."""
    from bflbm_tpu.observables.droplet import (_trilinear_periodic,
                                               center_of_mass)
    level = 0.5 * (float(rho_star.min()) + float(rho_star.max()))
    com = center_of_mass(rho_star - rho_star[0, 0, 0])
    _, _, _, dirs = sphere_grid()
    rs = np.linspace(R_LO, R_HI, NR)
    pts = (com + np.asarray(SHAPE) / 2.0 - 0.5)[None, None, None, :] \
        + dirs[:, :, None, :] * rs[None, None, :, None]
    s = _trilinear_periodic(rho_star, pts) - level
    flip = (s[..., :-1] > 0) & (s[..., 1:] <= 0)
    assert flip.any(axis=-1).all(), "some ray never crosses the level"
    i0 = np.argmax(flip, axis=-1).astype(np.int32)
    return level, i0, rs


def make_obs(level, i0, rs, dtype):
    """obs(f) -> (15,) vector of the linearization observables."""
    _, _, w2, dirs_np = sphere_grid()
    ylms = ylm_tables()
    coords = cell_coords_np()
    dirs = jnp.asarray(dirs_np, dtype)
    kerns = jnp.asarray(np.stack([k for _, k in ylms]), dtype)  # (9,NT,NP)
    coords_j = jnp.asarray(coords, dtype)
    box = jnp.asarray(SHAPE, dtype)
    r0g = jnp.asarray(rs[i0], dtype)
    r1g = jnp.asarray(rs[i0 + 1], dtype)
    dr = float(rs[1] - rs[0])

    def obs(f):
        rho = jnp.sum(f, axis=0)
        dens = rho - rho[0, 0, 0]
        com = jnp.einsum("xyz,xyzd->d", dens, coords_j) / jnp.sum(dens)
        origin = com + box / 2.0 - 0.5
        p0 = origin + dirs * r0g[..., None]
        p1 = origin + dirs * r1g[..., None]
        s0 = trilinear_periodic(rho, p0) - level
        s1 = trilinear_periodic(rho, p1) - level
        rmap = r0g + s0 / (s0 - s1) * dr
        zetas = jnp.einsum("ktp,tp->k", kerns, rmap)
        # gyration (full rho, minimum-image about the COM)
        r = coords_j - com
        r = r - box * jnp.round(r / box)
        sab = jnp.einsum("xyz,xyza,xyzb->ab", rho, r, r) / jnp.sum(rho)
        gyr = jnp.stack([sab[0, 0], sab[1, 1], sab[2, 2],
                         sab[0, 1], sab[0, 2], sab[1, 2]])
        return jnp.concatenate([zetas, gyr])

    return obs


# ---------------------------------------------------------------------------
# Stage: profile
# ---------------------------------------------------------------------------

def stage_profile(args):
    params = make_params()
    d = np.load(EQ_CKPT)
    dtype = jnp.float64 if args.x64 else jnp.float32
    fg = (jnp.asarray(d["f"], dtype), jnp.asarray(d["g"], dtype))
    zero_n = jnp.zeros((33,) + SHAPE, dtype)

    @jax.jit
    def chunk(fg):
        def body(c, _):
            return step_explicit(c, zero_n, params), None
        out, _ = jax.lax.scan(body, fg, None, length=1000)
        return out

    t0 = time.time()
    hist = []
    res = None
    for it in range(args.profile_chunks):
        fg_new = chunk(fg)
        res = max(float(jnp.max(jnp.abs(fg_new[0] - fg[0]))),
                  float(jnp.max(jnp.abs(fg_new[1] - fg[1]))))
        hist.append(res)
        fg = fg_new
        # f32 fixed-point wander floor ~1e-7; stop once below or stuck
        if res < (1e-13 if args.x64 else 2e-7):
            break
        if len(hist) >= 4 and abs(hist[-1] / hist[-3] - 1.0) < 1e-3:
            break
    f_star = np.asarray(fg[0])
    g_star = np.asarray(fg[1])
    rho_star = f_star.sum(axis=0)
    level, i0, rs = freeze_extraction(rho_star)
    from bflbm_tpu.observables.droplet import radius_from_mass
    os.makedirs(OUT, exist_ok=True)
    np.savez(os.path.join(OUT, "profile.npz"), f=f_star, g=g_star,
             level=level, i0=i0, rs=rs, residual=res,
             steps=1000 * (it + 1), res_hist=np.asarray(hist),
             r0_mass=radius_from_mass(rho_star))
    print(json.dumps({
        "stage": "profile", "steps": 1000 * (it + 1),
        "residual_per_step": res, "level": level,
        "rho_bg": float(rho_star[0, 0, 0]),
        "rho_max": float(rho_star.max()),
        "r0_mass": float(radius_from_mass(rho_star)),
        "wall_s": round(time.time() - t0, 1)}))


def load_profile(dtype):
    d = np.load(os.path.join(OUT, "profile.npz"))
    return ((jnp.asarray(d["f"], dtype), jnp.asarray(d["g"], dtype)),
            float(d["level"]), d["i0"], d["rs"])


# ---------------------------------------------------------------------------
# Stage: adjoint
# ---------------------------------------------------------------------------

def _cotangents(obs, f_star, g_like):
    """l_k = d o_k / d f at the fixed point (observables are f-only);
    returns (L_f (15,19,X,Y,Z), L_g zeros)."""
    jac = jax.jacrev(obs)(f_star)          # (15, 19, X, Y, Z)
    return jac, jnp.zeros((len(OBS_NAMES),) + g_like.shape, g_like.dtype)


def _translation_check(obs, f_star):
    """|jvp along the discrete x-translation| — the estimator must be
    translation-invariant (this is what decouples the COM Brownian
    motion from the variance sum)."""
    df = 0.5 * (jnp.roll(f_star, -1, axis=1) - jnp.roll(f_star, 1, axis=1))
    _, do = jax.jvp(obs, (f_star,), (df,))
    base = np.abs(np.asarray(jax.jacrev(obs)(f_star))
                  .reshape(len(OBS_NAMES), -1)).sum(axis=1)
    return np.asarray(do), base


def stage_adjoint(args):
    params = make_params()
    dtype = jnp.float64 if args.x64 else jnp.float32
    fg, level, i0, rs = load_profile(dtype)
    print(json.dumps({"stage": "adjoint", "backend_up": True,
                      "mass": float(jnp.sum(fg[0]))}), flush=True)
    obs = make_obs(level, i0, rs, dtype)
    o_star = np.asarray(jax.jit(obs)(fg[0]))
    do_trans, l1 = _translation_check(obs, fg[0])
    Lf, Lg = _cotangents(obs, fg[0], fg[1])

    zero_n = jnp.zeros((33,) + SHAPE, dtype)
    _, vjp = jax.vjp(lambda c, n: step_explicit(c, n, params), fg, zero_n)

    nobs = len(OBS_NAMES)

    def make_chunk(length):
        @jax.jit
        def chunk(V):
            def body(carry, _):
                Vf, Vg = carry
                (dS, dN) = jax.vmap(lambda vf, vg: vjp((vf, vg)))(Vf, Vg)
                dF, dG = dS
                dn = dN.reshape(nobs, -1)
                C = jnp.einsum("af,bf->ab", dn, dn,
                               precision=jax.lax.Precision.HIGHEST)
                return (dF, dG), C
            (Vf, Vg), Cs = jax.lax.scan(body, V, None, length=length)
            return (Vf, Vg), jnp.sum(Cs, axis=0), Cs

        return chunk

    V = (Lf, Lg)
    t0 = time.time()
    # exact first-N-step partial for the f64 validate stage
    chunk200 = make_chunk(args.c200)
    V, C200, _ = chunk200(V)
    C200 = np.asarray(C200, np.float64)
    C = C200.copy()
    steps_c200 = args.c200
    chunk_n = make_chunk(args.chunk)
    diag_hist = [np.diag(C).copy()]
    steps = steps_c200
    converged = False

    C_inc_last = np.zeros_like(C)

    def save():
        # checkpoint every few chunks: a killed / wall-clock-bounded run
        # keeps its partial sums, and stage_report's geometric-tail
        # certificate quantifies what the truncation left out.
        # C_inc_last (the last chunk's Gram increment MATRIX) lets
        # closed_covariance() extrapolate the full-matrix tail, not
        # just the diagonal.
        np.savez(os.path.join(OUT, "adjoint.npz"), C=C, C200=C200,
                 c200_steps=args.c200, o_star=o_star, steps=steps,
                 diag_hist=np.asarray(diag_hist),
                 C_inc_last=C_inc_last, inc_chunk=args.chunk,
                 translation_jvp=do_trans, l1_norms=l1,
                 dtype=str(np.dtype(np.float64 if args.x64
                                    else np.float32)))

    for it in range(args.max_chunks):
        V, Cc, Cs = chunk_n(V)
        Cc = np.asarray(Cc, np.float64)
        C_inc_last = Cc
        C += Cc
        steps += args.chunk
        diag_hist.append(np.diag(C).copy())
        inc = Cc[IDX_Z20, IDX_Z20] / max(C[IDX_Z20, IDX_Z20], 1e-300)
        gy = np.diag(Cc)[IDX_GYR].max() / max(np.diag(C)[IDX_GYR].max(),
                                              1e-300)
        # certified early stop: the per-chunk Gram increments decay
        # geometrically (see _tail_extrapolation); once the closed tail
        # is a negligible fraction of every partial sum the remaining
        # chunks cannot change the answer
        ext = _tail_extrapolation(diag_hist)
        cert = (ext is not None
                and float(ext["tail_frac"].max()) < args.tail_tol
                and float(ext["ratio"].max()) < 1.0)
        if it % 10 == 0 or max(inc, gy) < args.tol or cert:
            print(json.dumps({"chunk": it, "steps": steps,
                              "zeta20_var": C[IDX_Z20, IDX_Z20],
                              "rel_inc": inc,
                              "max_tail_frac": (float(ext["tail_frac"]
                                                      .max())
                                                if ext else None),
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)
            save()
        if max(inc, gy) < args.tol or cert:
            converged = True
            break
    wall = time.time() - t0
    save()
    print(json.dumps({
        "stage": "adjoint", "steps": steps, "converged": converged,
        "zeta20_var": C[IDX_Z20, IDX_Z20],
        "zeta_diag": {n: C[i, i] for i, n in enumerate(OBS_NAMES[:9])},
        "gyr_diag": {n: C[9 + i, 9 + i]
                     for i, n in enumerate(OBS_NAMES[9:])},
        "last_rel_inc_zeta20": inc, "last_rel_inc_gyr": gy,
        "translation_invariance": {
            n: abs(float(do_trans[i])) / max(float(l1[i]), 1e-300)
            for i, n in enumerate(OBS_NAMES)},
        "o_star": {n: float(o_star[i]) for i, n in enumerate(OBS_NAMES)},
        "wall_s": round(wall, 1)}))


# ---------------------------------------------------------------------------
# Stage: validate (CPU f64 — run with --cpu)
# ---------------------------------------------------------------------------

def stage_validate(args):
    assert jax.devices()[0].platform == "cpu", \
        "run with --cpu"
    params = make_params()
    fg, level, i0, rs = load_profile(jnp.float64)
    obs = make_obs(level, i0, rs, jnp.float64)
    Lf, Lg = _cotangents(obs, fg[0], fg[1])
    zero_n = jnp.zeros((33,) + SHAPE, jnp.float64)
    _, vjp = jax.vjp(lambda c, n: step_explicit(c, n, params), fg, zero_n)
    vjp = jax.jit(vjp)
    nobs = len(OBS_NAMES)
    C = np.zeros((nobs, nobs))
    Vf, Vg = np.asarray(Lf), np.asarray(Lg)
    t0 = time.time()
    n200 = int(np.load(os.path.join(OUT, "adjoint.npz"))["c200_steps"])
    for j in range(n200):
        dS_f = np.empty_like(Vf)
        dS_g = np.empty_like(Vg)
        dn_rows = np.empty((nobs, 33 * np.prod(SHAPE)))
        for k in range(nobs):
            (df, dg), dn = vjp((jnp.asarray(Vf[k]), jnp.asarray(Vg[k])))
            dS_f[k] = np.asarray(df)
            dS_g[k] = np.asarray(dg)
            dn_rows[k] = np.asarray(dn).ravel()
        C += dn_rows @ dn_rows.T
        Vf, Vg = dS_f, dS_g
    wall = time.time() - t0
    d = np.load(os.path.join(OUT, "adjoint.npz"))
    C200 = d["C200"]
    scale = np.sqrt(np.outer(np.diag(C), np.diag(C)))
    rel = np.abs(C - C200) / np.maximum(scale, 1e-300)
    out = {"stage": "validate", "steps": n200,
           "max_rel_dev_vs_f32": float(rel.max()),
           "zeta20_rel_dev": float(abs(C[IDX_Z20, IDX_Z20]
                                       - C200[IDX_Z20, IDX_Z20])
                                   / C[IDX_Z20, IDX_Z20]),
           "wall_s": round(wall, 1)}
    np.savez(os.path.join(OUT, "validate.npz"), C200_f64=C)
    with open(os.path.join(OUT, "validate.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Stage: mc — the nonlinear sorted-eig/axes pipeline on the predicted
# gyration covariance
# ---------------------------------------------------------------------------

def _axes_from_eigs(e, r0):
    """a,b,c = r0 ((e_i^2)/(e_j e_k))^(1/6), e sorted desc (the
    xdg_msd_calc.ipynb principal_radii construction, phase-F fixed-R0
    convention)."""
    out = []
    for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        out.append(r0 * ((e[:, i] * e[:, i])
                         / (e[:, j] * e[:, k])) ** (1.0 / 6.0))
    return np.stack(out, axis=1)


def closed_covariance(d):
    """Tail-closed stationary covariance from an (early-stopped)
    adjoint checkpoint.

    The per-chunk Gram increments I_j are PSD and decay geometrically
    (one slow physical mode dominates the tail — _tail_extrapolation
    fits its per-observable ratio r_i from the diagonal history).  Two
    closures, in order of fidelity:

      * checkpoint has C_inc_last (the last increment MATRIX): close
        entrywise with Tail_ij = I_last_ij * r_ij/(1 - r_ij),
        r_ij = sqrt(r_i r_j) — exact for a rank-1 dominant mode, and
        symmetric/PSD-consistent by the Cauchy-Schwarz structure of a
        Gram tail;
      * diagonal-only checkpoint: scale C -> D C D with
        D = diag(sqrt(1 + tail_frac_i)) — matches the extrapolated
        diagonal exactly, keeps PSD, leaves correlations unchanged.

    Returns (C_closed, info-dict) — or (C, None) when the history is
    too short to certify a ratio."""
    C = np.asarray(d["C"], np.float64)
    ext = (_tail_extrapolation(d["diag_hist"])
           if "diag_hist" in d else None)
    if ext is None:
        return C, None
    r = np.clip(ext["ratio"], 0.0, 0.999)
    if "C_inc_last" in d and np.any(np.asarray(d["C_inc_last"])):
        I = np.asarray(d["C_inc_last"], np.float64)
        rij = np.sqrt(np.outer(r, r))
        tail = I * rij / (1.0 - rij)
        mode = "matrix"
    else:
        scale = np.sqrt(1.0 + ext["tail_frac"])
        tail = np.outer(scale, scale) * C - C
        mode = "diag_scale"
    Cc = C + tail
    return Cc, {"mode": mode,
                "max_tail_frac": float(ext["tail_frac"].max()),
                "ratio": [float(v) for v in ext["ratio"]]}


def stage_mc(args):
    rng = np.random.default_rng(7)
    d = np.load(os.path.join(OUT, "adjoint.npz"))
    C, closure = closed_covariance(d)
    o_star = d["o_star"]
    prof = np.load(os.path.join(OUT, "profile.npz"))
    r0 = float(prof["r0_mass"])
    Cg = C[IDX_GYR, :][:, IDX_GYR]
    mu = o_star[IDX_GYR]
    n = args.mc_samples
    # sample symmetric tensors
    L = np.linalg.cholesky(Cg + 1e-30 * np.eye(6))
    x = mu[None, :] + rng.standard_normal((n, 6)) @ L.T
    S = np.zeros((n, 3, 3))
    S[:, 0, 0], S[:, 1, 1], S[:, 2, 2] = x[:, 0], x[:, 1], x[:, 2]
    S[:, 0, 1] = S[:, 1, 0] = x[:, 3]
    S[:, 0, 2] = S[:, 2, 0] = x[:, 4]
    S[:, 1, 2] = S[:, 2, 1] = x[:, 5]
    e = np.linalg.eigvalsh(S)[:, ::-1]          # sorted desc
    axes = _axes_from_eigs(e, r0)
    da = axes - axes.mean(axis=0, keepdims=True)
    pairs = ((0, 1), (1, 2), (0, 2))
    plus = sum(np.mean((da[:, i] + da[:, j]) ** 2) for i, j in pairs)
    minus = sum(np.mean((da[:, i] - da[:, j]) ** 2) for i, j in pairs)
    out = {
        "stage": "mc", "samples": n, "r0": r0,
        "tail_closure": closure,
        "gyr_mean": [float(v) for v in mu],
        "gyr_cov_diag": [float(v) for v in np.diag(Cg)],
        "eig_mean": [float(v) for v in e.mean(axis=0)],
        "eig_var": [float(v) for v in e.var(axis=0)],
        "axes_var": [float(v) for v in da.var(axis=0)],
        "mean_abs_da_sum": float(np.abs(da.sum(axis=1)).mean()),
        "mean_abs_da": [float(v) for v in np.abs(da).mean(axis=0)],
        "gamma_20_axes_sum": float(15 * KBT / (16 * np.pi * plus)),
        "gamma_22_axes_sum": float(45 * KBT / (16 * np.pi * minus)),
    }
    with open(os.path.join(OUT, "mc.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Stage: report
# ---------------------------------------------------------------------------

def _tail_extrapolation(diag_hist):
    """Geometric tail of the adjoint partial sums.

    diag_hist[n] is the covariance diagonal after n recorded chunks
    (row 0 = after the c200 prefix).  Each chunk's increment is a Gram
    diagonal, hence >= 0 and asymptotically ~ r^n with r = exp(-2*chunk
    /tau_slowest); fit r from the last increments and close the series:
    tail = I_last * r / (1 - r).  Returns per-observable (ratio, tail,
    tail fraction of the partial sum) — a convergence certificate for
    the early-stopped adjoint stage."""
    hist = np.asarray(diag_hist, np.float64)
    if hist.shape[0] < 5:
        return None
    inc = np.diff(hist, axis=0)
    span = min(4, inc.shape[0] - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = (inc[-1] / inc[-1 - span]) ** (1.0 / span)
    r = np.where(np.isfinite(r), r, 0.0)
    tail = np.where((r > 0) & (r < 1), inc[-1] * r / (1.0 - r), 0.0)
    tot = np.maximum(hist[-1], 1e-300)
    return {"ratio": r, "tail": tail, "tail_frac": tail / tot}


def stage_report(args):
    d = np.load(os.path.join(OUT, "adjoint.npz"))
    C, closure = closed_covariance(d)
    with open(os.path.join(OUT, "mc.json")) as fh:
        mc = json.load(fh)
    rows = {"tail_closure": closure, "predicted": {
        "zeta20_fluct_var": C[IDX_Z20, IDX_Z20],
        "zeta2m_vars": {n: float(C[i, i])
                        for i, n in enumerate(OBS_NAMES[:9])},
        "gamma_zeta20": KBT / (4.0 * C[IDX_Z20, IDX_Z20]),
        "equipartition_lhs": 2 * 0.01216 * C[IDX_Z20, IDX_Z20],
        "eig_var": mc["eig_var"], "axes_var": mc["axes_var"],
        "gamma_20_axes_sum": mc["gamma_20_axes_sum"],
        "gamma_22_axes_sum": mc["gamma_22_axes_sum"],
        "mean_abs_da": mc["mean_abs_da"],
        "mean_abs_da_sum": mc["mean_abs_da_sum"],
    }, "measured": []}
    for path in MEASURED:
        if not os.path.exists(path):
            continue
        m = np.load(path)
        z = np.asarray(m["zeta20"])
        ax = np.asarray(m["axes"])
        e = np.asarray(m["eigs"])
        da = ax - ax.mean(axis=0, keepdims=True)
        pairs = ((0, 1), (1, 2), (0, 2))
        plus = sum(np.mean((da[:, i] + da[:, j]) ** 2) for i, j in pairs)
        minus = sum(np.mean((da[:, i] - da[:, j]) ** 2) for i, j in pairs)
        rows["measured"].append({
            "path": os.path.relpath(path, ROOT),
            "n_frames": int(len(z)),
            "zeta20_fluct_var": float(np.var(z)),
            "eig_var": [float(v) for v in e.var(axis=0)],
            "axes_var": [float(v) for v in da.var(axis=0)],
            "gamma_20_axes_sum": float(15 * KBT / (16 * np.pi * plus)),
            "gamma_22_axes_sum": float(45 * KBT / (16 * np.pi * minus)),
            "mean_abs_da": [float(v) for v in np.abs(da).mean(axis=0)],
            "mean_abs_da_sum": float(np.abs(da.sum(axis=1)).mean()),
        })
    ext = _tail_extrapolation(d["diag_hist"]) if "diag_hist" in d else None
    if ext is not None:
        Craw = np.asarray(d["C"], np.float64)
        rows["convergence"] = {
            "steps": int(d["steps"]),
            "per_obs": {n: {"ratio": float(ext["ratio"][i]),
                            "tail_frac": float(ext["tail_frac"][i])}
                        for i, n in enumerate(OBS_NAMES)},
            "zeta20_var_raw": float(Craw[IDX_Z20, IDX_Z20]),
            "zeta20_var_extrapolated":
                float(Craw[IDX_Z20, IDX_Z20] + ext["tail"][IDX_Z20]),
            "max_tail_frac": float(ext["tail_frac"].max()),
        }
    if rows["measured"]:
        mz = np.mean([m["zeta20_fluct_var"] for m in rows["measured"]])
        rows["zeta20_pred_over_measured"] = \
            float(rows["predicted"]["zeta20_fluct_var"] / mz)
        mg = np.mean([m["gamma_20_axes_sum"] for m in rows["measured"]])
        rows["gamma20_pred_over_measured"] = \
            float(rows["predicted"]["gamma_20_axes_sum"] / mg)
    with open(os.path.join(OUT, "report.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    print(json.dumps(rows))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["profile", "adjoint", "validate",
                                      "mc", "report"])
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--profile-chunks", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--c200", type=int, default=200,
                    help="length of the saved partial Gram (validate)")
    ap.add_argument("--max-chunks", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--tail-tol", type=float, default=2e-3,
                    help="certified early stop: halt the adjoint once "
                         "the geometric-tail closure of every partial "
                         "sum is below this fraction")
    ap.add_argument("--mc-samples", type=int, default=400_000)
    ap.add_argument("--out", default=None,
                    help="override the artifact directory (e.g. a CPU "
                         "fallback adjoint that must not clash with the "
                         "accelerator run); seed it with profile.npz first")
    args = ap.parse_args()
    if args.out:
        global OUT
        OUT = args.out
    os.makedirs(OUT, exist_ok=True)
    if args.cpu or args.stage in ("validate",):
        jax.config.update("jax_platforms", "cpu")
    if args.stage == "validate" or args.x64:
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    {"profile": stage_profile, "adjoint": stage_adjoint,
     "validate": stage_validate, "mc": stage_mc,
     "report": stage_report}[args.stage](args)


if __name__ == "__main__":
    main()
