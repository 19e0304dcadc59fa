"""Acceptance physics runs - the reference's headline validations at full
scale on the accelerator (BASELINE.md):

  A.        mixture equilibration (two-phase protocol entry)
  B.        fluctuating mixture -> equilibrium S(k) flat at the
            Mixture.ipynb normalizations (target: within 1%)
  C.        flat interface -> capillary-wave spectrum
  c-ens     independent-seed capillary ensemble (+ mode series for
            benchmarks/capillary_debias.py)
  D.        droplet radius sweep -> Laplace slope + equilibrium radii
            (reference pinned R/L: 0.176, 0.204, 0.231, 0.257, 0.283)
  d-sweep   alpha0 in {0.8, 1.7, 2.0, 2.5} Laplace sweeps
  E.        droplet Brownian MSD / Stokes-Einstein (--size 32|64)
  F.        droplet shape fluctuations (zeta_20, principal axes)
  f-static  static/fluctuation decomposition of <zeta_20^2> from saved
            phase-F artifacts (CPU-only, closes the extraction-method
            attribution with numbers)

Usage: python benchmarks/acceptance.py <phase> [--steps N] [--out DIR]
Each phase prints one JSON line with its results.
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def phase_a(args):
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod

    cfg = preset("mixture-eq").replace(out_dir=f"{args.out}/mixture-eq",
                                       plot_int=100, t_window=200)
    state = run_mod.run(cfg)
    return {"phase": "A", "final_step": int(state.step),
            "out": cfg.out_dir}


def phase_b(args):
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import structfact as sf_lib

    steps = args.steps or 200_000
    window = min(steps // 2, 100_000)
    cfg = preset("mixture-fluct").replace(
        nsteps=steps, step_continue=500,
        checkpoint_path=f"{args.out}/mixture-eq/checkpoint0000500",
        sf_window=window, sf_every=100, plot_int=0, print_int=steps // 10,
        out_dir=f"{args.out}/mixture-fluct")
    if args.noise_dist:
        cfg = cfg.replace(noise_dist=args.noise_dist)
    if args.seed_base != 20_000:
        # independent-seed re-validation: a fresh seed makes the run's
        # statistical independence visible - its ratios must differ from
        # prior artifacts at the ~1e-3 sampling level
        # (tests/test_relax_invariance.py rationale)
        cfg = cfg.replace(seed=args.seed_base, reseed=True)
    t0 = time.time()
    state = run_mod.run(cfg)
    wall = time.time() - t0

    sf_files = sorted(glob.glob(os.path.join(cfg.out_dir, "structfact*")))
    with np.load(sf_files[-1], allow_pickle=True) as d:
        sk = np.fft.ifftshift(d["s_k"], axes=(-3, -2, -1))
        names = [str(n) for n in d["names"]]
    kBT = 1e-5
    cs2 = 1.0 / 3.0
    # Equilibrium normalizations (Mixture.ipynb cells 1-2): bare LB
    # velocities carry kBT/rho; the REAL velocities in the 22-comp
    # schema carry the 3/4-identity; uf.ug cross carries 1/4 kBT.
    norm = {"rho*rho": kBT / cs2, "phi*phi": kBT / cs2,
            "ufx*ufx": 0.75 * kBT, "ufy*ufy": 0.75 * kBT,
            "ufz*ufz": 0.75 * kBT,
            "ufx*ugx": 0.25 * kBT,
            "ufbarx*ufbarx": kBT, "ugbarx*ugbarx": kBT,
            "ubx*ubx": kBT / 2, "uby*uby": kBT / 2, "ubz*ubz": kBT / 2}
    out = {"phase": "B", "steps": steps,
           "wall_s": round(wall, 1),
           "sf_frames": int(window // 100)}
    if args.noise_dist:
        out["noise_dist"] = args.noise_dist
    if args.seed_base != 20_000:
        out["seed"] = args.seed_base
    worst = 0.0
    for p, name in enumerate(names):
        if name not in norm:
            continue
        k, s = sf_lib.radial_average(np.real(sk[p]))
        r = float(np.mean(s) / norm[name])
        out[name] = round(r, 5)
        worst = max(worst, abs(r - 1.0))
    out["worst_abs_dev"] = round(worst, 5)
    return out


def phase_c(args):
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import interface as iface
    from bflbm_tpu.io import fields as fields_io

    out_eq = f"{args.out}/interface-eq"
    if not os.path.exists(os.path.join(out_eq, "checkpoint0003000.npz")):
        cfg0 = preset("interface-eq").replace(out_dir=out_eq, plot_int=0)
        run_mod.run(cfg0)

    steps = args.steps or 200_000
    cfg = preset("interface-fluct").replace(
        nsteps=steps, step_continue=3000,
        checkpoint_path=f"{out_eq}/checkpoint0003000",
        plot_int=500, print_int=steps // 10,
        out_dir=f"{args.out}/interface-fluct")
    t0 = time.time()
    run_mod.run(cfg)
    wall = time.time() - t0

    frames = sorted(glob.glob(os.path.join(cfg.out_dir, "plt*.npz"))
                    + glob.glob(os.path.join(cfg.out_dir, "plt*.bflbm")))
    skip = len(frames) // 2  # discard noise-equilibration transient
    heights = []
    level = 0.5 * (0.1 + 3.0)
    for f in frames[skip:]:
        d = fields_io.read_frame(f)
        # per-column NaN fill (overhangs) instead of dropping whole frames
        h = iface.fill_missing(iface.interface_height(d["rho"], level))
        heights.append(h[4, :])
    k, s = iface.capillary_spectrum_ref(np.asarray(heights))
    kBT = 1e-5
    gamma = iface.fit_capillary_gamma_window(k, s, kBT)
    per_mode = {f"gamma_m{m}": round(float(kBT / (s[m - 1] * k[m - 1] ** 2)), 6)
                for m in (1, 2, 3, 5, 8)}
    return {"phase": "C", "steps": steps, "wall_s": round(wall, 1),
            "n_frames": len(heights), "gamma_ref": 0.012162,
            "gamma_capillary": round(gamma, 6),
            "rel_dev": round(abs(gamma / 0.012162 - 1), 4), **per_mode}


def _capillary_one(out_eq, out_dir, steps, seed, reseed):
    """One interface-fluct run; heights collected in-memory (no disk
    frames), reference spectrum conventions (Flat_Interface.ipynb
    cells 7-9: single x-slice, backward-norm FFT, mean-profile
    subtraction).  Returns (gamma, per-mode dict, wall_s)."""
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import interface as iface

    heights = []
    level = 0.5 * (0.1 + 3.0)

    def on_frame(step_i, packed):
        # all 8 x-slices (the field is only 0.5 MB): slice 4 feeds the
        # reference's single-slice convention, the rest give the
        # slice-averaged spectrum (better statistics, same estimator)
        rho = np.asarray(packed[0])
        h = iface.fill_missing(iface.interface_height(rho, level))
        heights.append((step_i, np.array(h)))

    cfg = preset("interface-fluct").replace(
        nsteps=steps, step_continue=3000,
        checkpoint_path=f"{out_eq}/checkpoint0003000",
        plot_int=500, plot_save=False, print_int=steps // 4,
        seed=seed, reseed=reseed, out_dir=out_dir)
    t0 = time.time()
    run_mod.run(cfg, on_frame=on_frame)
    wall = time.time() - t0
    cut = 3000 + steps // 2  # discard the noise-equilibration transient
    hs = np.asarray([h for s, h in heights if s > cut])  # (T, 8, Y)
    kBT = 1e-5
    # reference convention: single x-slice (x=4)
    k, s = iface.capillary_spectrum_ref(hs[:, 4, :])
    gamma = iface.fit_capillary_gamma_window(k, s, kBT)
    # slice-averaged: same estimator on every slice, spectra averaged
    s_all = np.mean([iface.capillary_spectrum_ref(hs[:, x, :])[1]
                     for x in range(hs.shape[1])], axis=0)
    gamma_avg = iface.fit_capillary_gamma_window(k, s_all, kBT)
    # kx=0 estimator: the x-AVERAGED height's spectrum is the pure
    # (kx=0, ky) capillary mode.  A single slice's spectrum is the sum
    # over kx modes — the kx=0 term (= the x-average, identical
    # normalization since the interface is x-coherent at long
    # wavelength over Lx=8) plus a ky-independent noise floor from
    # kx != 0, which biases the k^4-weighted window fit low.
    k2d, s2d = iface.capillary_spectrum_ref(hs.mean(axis=1))
    gamma_xavg = iface.fit_capillary_gamma_window(k2d, s2d, kBT)
    np.save(os.path.join(out_dir, "spectrum.npy"),
            np.stack([k, s, s_all, s2d]))
    # per-frame mode amplitudes (slice 4 + x-average), m = 0..32: the
    # raw material for autocorrelation-time measurement and exact
    # finite-window mean-subtraction debiasing in the analysis
    hk_slice = np.fft.fft(hs[:, 4, :], axis=1)[:, :33]
    hk_xavg = np.fft.fft(hs.mean(axis=1), axis=1)[:, :33]
    np.save(os.path.join(out_dir, "hk_series.npy"),
            np.stack([hk_slice, hk_xavg], axis=1))
    per_mode = {f"gamma_m{m}": round(float(kBT / (s[m - 1] * k[m - 1] ** 2)),
                                     6)
                for m in (1, 2, 3, 5, 8)}
    per_mode["gamma_sliceavg"] = round(gamma_avg, 6)
    per_mode["gamma_xavg"] = round(gamma_xavg, 6)
    return gamma, per_mode, wall, len(hs)


def phase_c_ens(args):
    """Independent-seed ensemble of full 800k-step capillary runs (the
    <1% gamma certification: mean +- stderr over independent
    trajectories branching from the shared deterministic
    equilibration)."""
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod

    out_eq = f"{args.out}/interface-eq"
    if not os.path.exists(os.path.join(out_eq, "checkpoint0003000.npz")):
        cfg0 = preset("interface-eq").replace(out_dir=out_eq, plot_int=0)
        run_mod.run(cfg0)

    steps = args.steps or 800_000
    n_runs = args.n_runs
    gammas, runs = [], []
    for i in range(n_runs):
        seed = args.seed_base + 7919 * i
        g, per_mode, wall, n_frames = _capillary_one(
            out_eq, f"{args.out}/interface-ens-{args.seed_base}-{i}",
            steps, seed, reseed=True)
        gammas.append(g)
        runs.append({"seed": seed, "gamma": round(g, 6), **per_mode,
                     "wall_s": round(wall, 1), "n_frames": n_frames})
        print(json.dumps({"ens_run": i, **runs[-1]}), flush=True)
    gam = np.asarray(gammas)
    mean = float(gam.mean())
    stderr = float(gam.std(ddof=1) / np.sqrt(len(gam))) if len(gam) > 1 \
        else float("nan")
    gavg = np.asarray([r["gamma_sliceavg"] for r in runs])
    mean_avg = float(gavg.mean())
    stderr_avg = float(gavg.std(ddof=1) / np.sqrt(len(gavg))) \
        if len(gavg) > 1 else float("nan")
    return {"phase": "C-ens", "steps": steps, "n_runs": n_runs,
            "runs": runs, "gamma_mean": round(mean, 6),
            "gamma_stderr": round(stderr, 6),
            "gamma_sliceavg_mean": round(mean_avg, 6),
            "gamma_sliceavg_stderr": round(stderr_avg, 6),
            "gamma_ref": 0.012162,
            "rel_dev": round(abs(mean / 0.012162 - 1), 4),
            "rel_stderr": round(stderr / 0.012162, 4),
            "rel_dev_sliceavg": round(abs(mean_avg / 0.012162 - 1), 4),
            "rel_stderr_sliceavg": round(stderr_avg / 0.012162, 4)}


def phase_d(args):
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.io import fields as fields_io
    from bflbm_tpu.observables import droplet as drop_obs

    radii = [0.2, 0.23, 0.25, 0.28, 0.3]
    ref_radii = [0.1760534, 0.20426208, 0.23111422, 0.25739767, 0.2831091]
    steps = args.steps or 20_000
    results = []
    for r in radii:
        cfg = preset("droplet-eq").replace(
            nsteps=steps, init_radius=r, plot_int=0,
            out_dir=f"{args.out}/droplet-r{r:.2f}")
        state = run_mod.run(cfg)
        rho = np.asarray(state.f.sum(axis=0))
        phi = np.asarray(state.g.sum(axis=0))
        com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
        fit = drop_obs.fit_droplet(rho, com)
        # the reference's pinned-value convention: unbinned all-cells
        # curve_fit (Surface_Tension.ipynb cell 8) — the per-cell
        # weighting differs from the binned radial-profile fit above
        fit_ref = drop_obs.fit_droplet_allcells(rho)
        dp = drop_obs.laplace_delta_p(rho, phi, 1.5, com)
        results.append({"init_r": r,
                        "R_over_L": round(fit_ref["R"], 6),
                        "R_over_L_binned": round(fit["R"] / 32, 6),
                        "delta_p": round(dp, 6)})
    gamma, icpt = drop_obs.surface_tension_laplace(
        [32 * x["R_over_L"] for x in results],
        [x["delta_p"] for x in results])
    devs = [abs(a["R_over_L"] - b) / b for a, b in zip(results, ref_radii)]
    # The reference fits DeltaP vs 1/(R/L) and quotes slope/2
    # (Surface_Tension.ipynb cell 17 saved output: slope 0.0215679,
    # "theoretical surface tension" 0.0107839 at alpha0=1.5).  Our fit
    # uses lattice-unit R; conversion: k_ref = gamma_lat / (L/2).
    k_ref_conv = gamma / 16.0
    return {"phase": "D", "steps": steps, "runs": results,
            "gamma_laplace_slope_lat": round(gamma, 6),
            "laplace_intercept": round(icpt, 6),
            "slope_ref_convention": round(k_ref_conv, 6),
            "slope_reference_value": 0.021567889346707517,
            "slope_rel_dev": round(abs(k_ref_conv / 0.021567889 - 1), 5),
            "ref_radii": ref_radii,
            "radius_max_rel_dev": round(max(devs), 5)}


_SWEEPS = {
    # alpha0 -> (preset, radii, reference saved slope or None)
    # Surface_Tension.ipynb cells 18-28.  The reference's own saved
    # outputs for alpha0=0.8 and 2.5 have NEGATIVE Laplace slopes
    # (radii 0.36-0.42 of the box: droplets interact with their
    # periodic images, DeltaP no longer ~ 1/R) — recorded here as-is.
    1.7: ("droplet-a1.7-eq", [0.20, 0.23, 0.25, 0.28], 0.026914662086),
    2.0: ("droplet-a2.5-eq", [0.20, 0.23, 0.25, 0.28], None),  # see below
    0.8: ("droplet-a0.8-eq", [0.38, 0.40, 0.42], -0.00248879718),
    2.5: ("droplet-a2.5-eq", [0.36, 0.38, 0.40, 0.42],
          -0.0007536467744),
}


def phase_d_sweep(args):
    """Laplace-law sweeps for the alpha0 variants (Surface_Tension
    cells 18-28).  --alpha0 selects the family."""
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import droplet as drop_obs

    import dataclasses

    a0 = args.alpha0
    if a0 == 2.0:
        # cell 21: alpha0=2.0 with the rho_hi=3 recipe.  The reference-
        # exact sqrt(kappa)=0.32-cell init width diverges within ~10
        # steps at this quench depth — in float64 as well (onset step 2,
        # rho < 0 at the interface shell; its notebook cell has no saved
        # output either).  init_width=1.0 relaxes the start; the
        # converged radii/DeltaP are protocol-insensitive (the r=0.20
        # case agrees between both inits — 'width_check' below).
        base = preset("droplet-a1.7-eq")
        base = base.replace(
            params=dataclasses.replace(base.params, alpha0=2.0),
            init_width=1.0)
        radii, ref_slope = [0.20, 0.23, 0.25, 0.28], None
    else:
        name, radii, ref_slope = _SWEEPS[a0]
        base = preset(name)
        if a0 == 2.5:
            base = base.replace(
                params=dataclasses.replace(base.params, alpha0=2.5))
    steps = args.steps or 20_000
    results = []
    for r in radii:
        cfg = base.replace(nsteps=steps, init_radius=r, plot_int=0,
                           t_window=0,
                           out_dir=f"{args.out}/droplet-a{a0}-r{r:.2f}")
        state = run_mod.run(cfg)
        rho = np.asarray(state.f.sum(axis=0))
        phi = np.asarray(state.g.sum(axis=0))
        if not np.isfinite(rho).all():
            # deep-quench f32 instability (observed: alpha0=2.0 r=0.28)
            results.append({"init_r": r, "nonfinite": True})
            continue
        com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
        fit_ref = drop_obs.fit_droplet_allcells(rho)
        dp = drop_obs.laplace_delta_p(rho, phi, a0, com)
        results.append({"init_r": r, "R_over_L": round(fit_ref["R"], 6),
                        "delta_p": round(dp, 6)})
    width_check = None
    if a0 == 2.0:
        # protocol-insensitivity: the r=0.20 case with the reference-
        # exact sqrt(kappa) init must converge to the same equilibrium
        cfg = base.replace(nsteps=steps, init_radius=0.20, plot_int=0,
                           t_window=0, init_width=0.0,
                           out_dir=f"{args.out}/droplet-a{a0}-r0.20-refinit")
        state = run_mod.run(cfg)
        rho = np.asarray(state.f.sum(axis=0))
        phi = np.asarray(state.g.sum(axis=0))
        com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
        fit_ref = drop_obs.fit_droplet_allcells(rho)
        dp = drop_obs.laplace_delta_p(rho, phi, a0, com)
        r20 = next(x for x in results if x["init_r"] == 0.20)
        width_check = {
            "R_over_L_refinit": round(fit_ref["R"], 6),
            "delta_p_refinit": round(dp, 6),
            "R_rel_dev": round(abs(fit_ref["R"] / r20["R_over_L"] - 1), 6),
            "dp_rel_dev": round(abs(dp / r20["delta_p"] - 1), 6)}
    # the reference's fit: DeltaP vs 1/(R/L), quoted slope
    ok = [x for x in results if "R_over_L" in x]
    inv_r = np.array([1.0 / x["R_over_L"] for x in ok])
    dps = np.array([x["delta_p"] for x in ok])
    slope, icpt = np.polyfit(inv_r, dps, 1)
    out = {"phase": f"D-sweep-a{a0}", "steps": steps, "runs": results,
           "width_check": width_check,
           "slope": round(float(slope), 8),
           "intercept": round(float(icpt), 8),
           "gamma_quoted": round(float(slope) / 2.0, 8)}
    if ref_slope is not None:
        out["slope_reference_saved"] = ref_slope
        out["slope_rel_dev"] = round(abs(slope / ref_slope - 1), 4)
    return out


def phase_e(args):
    """Droplet Brownian MSD / Stokes-Einstein (xdg_msd_calc.ipynb; the
    notebook's saved output on its own data: Dse=9.2952e-07,
    Db=9.6660e-07, diff 3.99%).  Protocol: 64^3, alpha0=4, rho_hi=1,
    r=0.2 droplet; 20k deterministic equilibration -> fluctuating
    kBT=5e-5 continuation; COM of the threshold-filtered density per
    frame (img_filter rho>0.06), MSD over a 100-frame lag window,
    D = slope/6 vs stokes_einstein(R, L, eta=rho0/6, kT, alpha=1)."""
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import msd as msd_obs

    n = args.size  # 32: the system_unit.ipynb droplet (R=6.2, P=0.450);
    #                 64: the xdg_msd_calc data set (R/L identical)
    out_eq = f"{args.out}/droplet-msd-eq{n}"
    if not os.path.exists(os.path.join(out_eq, "checkpoint0020000.npz")):
        cfg0 = preset("droplet-msd-eq").replace(shape=(n, n, n),
                                                out_dir=out_eq)
        run_mod.run(cfg0)

    steps = args.steps or 1_000_000
    rows = []  # (step, R_mass, com_xyz)

    # device-side per-frame reduction (no full 64^3 hydro pull to the
    # host per frame): COM + mass-radius of the filtered
    # density, exactly the notebook's img_filter/droplet_radius_mass
    import jax
    import jax.numpy as jnp

    shape_n = (n, n, n)
    grids = jnp.meshgrid(*[jnp.arange(nn, dtype=jnp.float32) - nn / 2 + 0.5
                           for nn in shape_n], indexing="ij")

    @jax.jit
    def reduce_frame(rho):
        filt = jnp.where(rho > 0.06, rho, 0.0)
        mass = jnp.sum(filt)
        com = jnp.stack([jnp.sum(filt * g) for g in grids]) / mass
        rho_d = filt[n // 2, n // 2, n // 2]
        rho_m = filt[0, 0, 0]
        excess = jnp.sum(filt - rho_m)
        r = (3.0 / (4.0 * jnp.pi) * excess
             / (rho_d - rho_m)) ** (1.0 / 3.0)
        return jnp.concatenate([r[None], com])

    def on_frame(step_i, packed):
        out = np.asarray(reduce_frame(packed[0]))
        rows.append((step_i, out[0], out[1], out[2], out[3]))

    eta = 1.0 * (1.0 / 3.0) * (1.0 - 0.5)  # rho0 cs2 (tau_r - 1/2)
    tau = 100  # frame lags (the notebook's tau)
    t0 = time.time()
    d_fits, r_list, runs = [], [], []
    for i in range(args.n_runs):
        rows.clear()
        cfg = preset("droplet-msd-fluct").replace(
            shape=(n, n, n), nsteps=steps,
            checkpoint_path=f"{out_eq}/checkpoint0020000",
            plot_save=False, print_int=steps // 10,
            seed=args.seed_base + 7919 * i, reseed=args.n_runs > 1,
            out_dir=f"{args.out}/droplet-msd-fluct{n}-{i}"
            if args.n_runs > 1 else f"{args.out}/droplet-msd-fluct{n}")
        run_mod.run(cfg, on_frame=on_frame)
        arr = np.asarray(rows[1:])  # drop frame 0 like the notebook
        np.save(os.path.join(cfg.out_dir, "msd_rows.npy"), arr)
        steps_f, r_mass, coms = arr[:, 0], arr[:, 1], arr[:, 2:5]
        traj = msd_obs.unwrap_periodic(coms, cfg.shape)
        ts, m = msd_obs.msd(steps_f, traj, tau)
        d_fits.append(float(np.polyfit(ts, m, 1)[0] / 6.0))
        r_list.append(float(r_mass.mean()))
        runs.append({"seed": cfg.seed, "D_fit": d_fits[-1],
                     "R": round(r_list[-1], 4)})
        if args.n_runs > 1:
            print(json.dumps({"msd_run": i, **runs[-1]}), flush=True)
    wall = time.time() - t0
    d_fit = float(np.mean(d_fits))
    R = float(np.mean(r_list))
    d_se = msd_obs.stokes_einstein(R, float(n), eta, 5e-5)
    # physical units (system_unit.ipynb cell 0)
    dx, dt = 1.613e-9, 0.250e-12
    d_fit_st = d_fit * dx * dx / dt * 1e4  # m^2/s -> St (cm^2/s)
    out = {"phase": f"E-msd-{n}", "steps": steps, "n_runs": args.n_runs,
           "wall_s": round(wall, 1),
           "n_frames": int(steps // 100), "R_mass_mean": round(R, 4),
           "P_factor": round(1 - 2.84 * R / n, 4),
           "D_fit": d_fit, "D_se": d_se,
           "rel_diff": round((d_fit - d_se) / d_se, 4),
           "D_fit_stokes": d_fit_st}
    if args.n_runs > 1:
        stderr = float(np.std(d_fits, ddof=1) / np.sqrt(len(d_fits)))
        out["D_fit_stderr"] = stderr
        out["ratio_stderr"] = round(stderr / d_se, 4)
        out["runs"] = runs
    if n == 64:
        # the notebook's saved output on its own 64^3 data set
        out["reference_saved"] = {"Dse": 9.2952e-07, "Db": 9.6660e-07,
                                  "diff_pct": 3.99}
    else:
        # system_unit.ipynb pins P_FLBM = 0.450 for the R=6.2, L=32 case
        out["reference_P"] = 0.450
    return out


def _analyze_shape_frame(rho):
    """Per-frame shape observables (multiprocessing worker): gyration
    eigenvalues plus zeta_20 by BOTH surface extractors — the round-2
    ray/Gauss-Legendre radius map and the reference's marching-cubes
    vertex pipeline (hand-rolled, observables/marching_cubes.py) — so
    the extraction-method delta on <zeta_20^2> is measured on identical
    frames (VERDICT round-2 item 4)."""
    from bflbm_tpu.observables import droplet as drop_obs
    from bflbm_tpu.observables import marching_cubes as mc_obs

    com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
    rad = drop_obs.radius_from_mass(rho)
    s = drop_obs.gyration_tensor(rho, com)
    eig = np.sort(np.linalg.eigvalsh(s))[::-1]
    level = 0.5 * (rho.min() + rho.max())
    rmap = drop_obs.surface_radius_map(rho, com, level)
    amps = drop_obs.spherical_harmonic_amplitudes(rmap, lmax=2)
    # marching cubes wants the COM in array-index coordinates
    com_idx = com + (np.asarray(rho.shape) - 1) / 2.0
    amps_mc, diag = mc_obs.mc_surface_amplitudes(rho, com_idx, level)
    return (rad, eig, amps[(2, 0)].real, amps_mc[(2, 0)].real,
            diag["boundary_edges"])


def phase_f(args):
    """Droplet shape-fluctuation surface tensions
    (Droplet_Fluctuation.ipynb): principal-axis equipartition
    gamma_(2,0), gamma_(2,+-2) (cells 24-25) and the spherical-harmonic
    zeta_20 equipartition 2 gamma <zeta_20^2> = kBT/2 (cells 35, 39),
    vs gamma_theory = 0.01216 at alpha0 = 1.5.  The reference's
    trajectory (cell 21): init r = 0.25, 32^3, kBT = 1e-5, frames every
    500 steps, 2301 frames (~1.15M steps); its equilibrium R0 = 7.655
    by the mass-radius convention (cell 41)."""
    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import droplet as drop_obs

    out_eq = f"{args.out}/droplet-r0.25"  # phase D's alpha0=1.5 r=0.25 run
    if not os.path.exists(os.path.join(out_eq, "checkpoint0020000.npz")):
        cfg0 = preset("droplet-eq").replace(nsteps=20_000, plot_int=0,
                                            init_radius=0.25,
                                            out_dir=out_eq)
        run_mod.run(cfg0)

    steps = args.steps or 1_150_000
    frames = []

    def on_frame(step_i, packed):
        frames.append(np.asarray(packed[0]))  # 32^3 rho, 131 KB

    reseed = args.seed_base != 20_000
    cfg = preset("droplet-fluct").replace(
        nsteps=steps, checkpoint_path=f"{out_eq}/checkpoint0020000",
        plot_int=500, plot_save=False, print_int=steps // 10,
        seed=args.seed_base, reseed=reseed,
        out_dir=f"{args.out}/droplet-shapefluct"
        + (f"-{args.seed_base}" if reseed else ""))
    t0 = time.time()
    run_mod.run(cfg, on_frame=on_frame)
    wall = time.time() - t0

    kBT = 1e-5
    skip = len(frames) // 8  # noise-equilibration transient
    import multiprocessing as mp

    with mp.Pool(8) as pool:
        rows = pool.map(_analyze_shape_frame, frames[skip:], chunksize=8)
    rads = [r[0] for r in rows]
    eigs = [r[1] for r in rows]
    zetas = [r[2] for r in rows]
    zetas_mc = [r[3] for r in rows]
    holes = [r[4] for r in rows]
    # principal semi-axes at FIXED R0 (a per-frame mass-radius injects a
    # common-mode delta R driven by the single-cell center density and
    # swamps the shape signal — the reference's own |d(a+b+c)| ~ 1e-4
    # shows it used a fixed scale)
    e = np.asarray(eigs)
    r0 = float(np.mean(rads))
    axes = np.stack([r0 * ((e[:, i] * e[:, i])
                           / (e[:, j] * e[:, k])) ** (1.0 / 6.0)
                     for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1))],
                    axis=1)
    da = axes - axes.mean(axis=0, keepdims=True)
    gpair = drop_obs.shape_fluctuation_gamma(axes, kBT)
    # the reference's formula (cell 24) SUMS over the three pairs
    pairs = ((0, 1), (1, 2), (0, 2))
    plus = sum(np.mean((da[:, i] + da[:, j]) ** 2) for i, j in pairs)
    minus = sum(np.mean((da[:, i] - da[:, j]) ** 2) for i, j in pairs)
    z = np.asarray(zetas)
    z_mc = np.asarray(zetas_mc)
    g_zeta = drop_obs.zeta_equipartition_gamma(z, kBT)
    g_zeta_mc = drop_obs.zeta_equipartition_gamma(z_mc, kBT)
    gamma_th = 0.01216
    np.savez(os.path.join(cfg.out_dir, "shapefluct.npz"),
             axes=axes, eigs=e, rads=np.asarray(rads), zeta20=z,
             zeta20_mc=z_mc, mc_boundary_edges=np.asarray(holes))
    return {"phase": "F-shapefluct", "steps": steps,
            "wall_s": round(wall, 1), "n_frames": len(frames) - skip,
            "R0": round(r0, 4),
            # reference cell 25's printed statistics (lattice units):
            # 0.000129, 0.0265, 0.0133, 0.0131 on its 2301-frame set
            "mean_abs_da_sum": float(np.abs(da.sum(axis=1)).mean()),
            "mean_abs_da": [float(x) for x in np.abs(da).mean(axis=0)],
            "gamma_20_axes_sum": round(15 * kBT / (16 * np.pi * plus), 6),
            "gamma_22_axes_sum": round(45 * kBT / (16 * np.pi * minus), 6),
            "gamma_20_axes_mean": round(gpair["gamma_20"], 6),
            "gamma_22_axes_mean": round(gpair["gamma_22"], 6),
            # cell 39's check: 2 gamma_theory <zeta_20^2> vs kBT/2; the
            # reference's OWN saved output is LHS=2.5488e-07 vs 5e-06 —
            # the idealized equipartition fails 20x on its data too; the
            # comparable quantity is <zeta_20^2>
            "equipartition_lhs": float(2 * gamma_th * np.mean(z ** 2)),
            "equipartition_rhs": kBT / 2,
            "reference_saved_lhs": 2.5488e-07,
            "zeta20_var": float(np.mean(z ** 2)),
            # the reference-method (marching cubes) numbers on the SAME
            # frames — the direct comparable to its saved 1.048e-05
            "zeta20_var_mc": float(np.mean(z_mc ** 2)),
            "equipartition_lhs_mc": float(2 * gamma_th
                                          * np.mean(z_mc ** 2)),
            "mc_mean_boundary_edges": float(np.mean(holes)),
            "reference_zeta20_var": 1.048e-05,
            "gamma_zeta20": round(g_zeta, 6),
            "gamma_zeta20_mc": round(g_zeta_mc, 6),
            "gamma_theory": gamma_th}


def phase_f_static(args):
    """Decompose <zeta_20^2> = static^2 + fluctuation variance from the
    SAVED phase-F artifacts (no simulation; CPU numpy only).

    The static term is each extractor's zeta_20 on the kBT=0 equilibrium
    droplet checkpoint — the true value is 0 by spherical symmetry, so
    anything nonzero is lattice-discretization quadrupole bias of that
    surface pipeline.  A synthetic tanh-droplet radius scan then shows
    the bias is sub-lattice aliasing: it oscillates with R by more than
    an order of magnitude in static^2 across R in [7, 8] on the 32^3
    grid, which brackets the reference's implied static (its saved
    total 1.048e-5 minus the extractor-independent fluctuation
    variance).  Closes VERDICT round-2 item 4: the extraction method
    accounts for the full <zeta_20^2> gap, with numbers."""
    from bflbm_tpu.observables import droplet as drop_obs
    from scipy.optimize import curve_fit

    z = np.load(f"{args.out}/droplet-shapefluct/shapefluct.npz")
    ray, mc = np.asarray(z["zeta20"]), np.asarray(z["zeta20_mc"])
    ck = np.load(f"{args.out}/droplet-r0.25/checkpoint0020000.npz")
    rho_eq = ck["f"].sum(axis=0)
    _, _, s_ray, s_mc, _ = _analyze_shape_frame(rho_eq)

    # synthetic scan: same profile shape as the equilibrium droplet
    n = rho_eq.shape[0]
    x = np.arange(n) - (n - 1) / 2
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    com = drop_obs.center_of_mass(rho_eq - rho_eq[0, 0, 0])
    r = np.sqrt((X - com[0]) ** 2 + (Y - com[1]) ** 2
                + (Z - com[2]) ** 2)

    def prof(r, R, w, lo, hi):
        return lo + (hi - lo) * 0.5 * (1 - np.tanh((r - R) / w))

    p, _ = curve_fit(prof, r.ravel(), rho_eq.ravel(),
                     p0=[7.5, 1.0, 0.01, 3.4])
    scan = {}
    for R in (7.0, 7.25, 7.51, 7.655, 7.8, 8.0):
        _, _, zr, zm, _ = _analyze_shape_frame(prof(r, R, *p[1:]))
        scan[f"{R:.3f}"] = {"ray_sq": float(zr ** 2),
                            "mc_sq": float(zm ** 2)}
    fluct = 0.5 * (np.var(ray) + np.var(mc))
    return {"phase": "f-static",
            "total_ray": float(np.mean(ray ** 2)),
            "total_mc": float(np.mean(mc ** 2)),
            "fluct_var_ray": float(np.var(ray)),
            "fluct_var_mc": float(np.var(mc)),
            "corr_ray_mc": float(np.corrcoef(ray, mc)[0, 1]),
            "traj_mean_ray": float(np.mean(ray)),
            "traj_mean_mc": float(np.mean(mc)),
            "static_eq_ray": float(s_ray), "static_eq_mc": float(s_mc),
            # closure: static^2 + var must reproduce the totals
            "predicted_total_ray": float(s_ray ** 2 + np.var(ray)),
            "predicted_total_mc": float(s_mc ** 2 + np.var(mc)),
            "reference_total": 1.048e-05,
            "reference_implied_static_sq": float(1.048e-05 - fluct),
            "synthetic_radius_scan": scan}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=["a", "b", "c", "c-ens", "d",
                                      "d-sweep", "e", "f", "f-static"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--n-runs", type=int, default=8)
    ap.add_argument("--alpha0", type=float, default=1.7)
    ap.add_argument("--seed-base", type=int, default=20_000)
    ap.add_argument("--size", type=int, default=32,
                    help="phase e domain edge (32: system_unit droplet; "
                    "64: the xdg_msd_calc data set)")
    ap.add_argument("--out", default="out/acceptance")
    ap.add_argument("--noise-dist", default=None,
                    help="phase b: normal generator of the hash noise "
                    "stream (clt4/clt2/u8/bm; default clt4)")
    args = ap.parse_args()
    import jax

    print(f"[backend: {jax.devices()[0].platform}]", flush=True)
    fn = {"a": phase_a, "b": phase_b,
          "c": phase_c, "c-ens": phase_c_ens,
          "d": phase_d, "d-sweep": phase_d_sweep, "e": phase_e,
          "f": phase_f, "f-static": phase_f_static}
    print(json.dumps(fn[args.phase](args)), flush=True)


if __name__ == "__main__":
    main()
