#!/usr/bin/env python
"""End-to-end nonlinear check of the capillary linear-response model.

Runs the REAL fluctuating simulation (f32 on the accelerator, jnp engine — the same
code path as the production 24-run ensemble) on an 8 x 64 x 64 stripe,
whose ky modes m' = 1, 2, 3 sit at the same physical wavenumbers as the
production (Ny = 256) modes m = 4, 8, 12.  The measured single-slice
and x-averaged spectra (exact acceptance conventions) are then compared
against the first-principles stationary prediction of
benchmarks/capillary_model.py for THIS geometry — an apples-to-apples
test that includes every effect the linear model omits (estimator
nonlinearity at the ~1.5-cell-wide interface, nonlinear mode coupling,
f32 arithmetic).

Usage:
    python benchmarks/capillary_nl_check.py --steps 4000000
    JAX_PLATFORMS=cpu python benchmarks/capillary_model.py nlcompare
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "out", "capillary_model")
SHAPE = (8, 64, 64)
LEVEL = 0.5 * (0.1 + 3.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4_000_000)
    ap.add_argument("--every", type=int, default=250)
    ap.add_argument("--seed", type=int, default=271828)
    args = ap.parse_args()

    from bflbm_tpu.config import preset
    from bflbm_tpu import run as run_mod
    from bflbm_tpu.observables import interface as iface

    os.makedirs(OUT, exist_ok=True)
    out_eq = os.path.join(OUT, "nl_eq")
    ck = os.path.join(out_eq, "checkpoint0003000.npz")
    if not os.path.exists(ck):
        cfg0 = preset("interface-eq").replace(
            shape=SHAPE, out_dir=out_eq, plot_int=0)
        run_mod.run(cfg0)

    heights = []

    def on_frame(step_i, packed):
        rho = np.asarray(packed[0])
        h = iface.fill_missing(iface.interface_height(rho, LEVEL))
        heights.append((step_i, np.asarray(h, np.float32)))

    cfg = preset("interface-fluct").replace(
        shape=SHAPE, nsteps=args.steps, step_continue=3000,
        checkpoint_path=ck[:-4], plot_int=args.every, plot_save=False,
        print_int=args.steps // 8, seed=args.seed, reseed=True,
        out_dir=os.path.join(OUT, "nl_fluct"))
    t0 = time.time()
    run_mod.run(cfg, on_frame=on_frame)
    wall = time.time() - t0

    cut = 3000 + args.steps // 4       # noise-equilibration transient
    hs = np.asarray([h for s, h in heights if s > cut])   # (T, 8, 64)
    # per-frame mode amplitudes for both channels (backward-norm FFT)
    hk_slice = np.fft.fft(hs[:, 4, :], axis=1)[:, :17]
    hk_xavg = np.fft.fft(hs.mean(axis=1), axis=1)[:, :17]
    k, s_slice = iface.capillary_spectrum_ref(hs[:, 4, :])
    _, s_xavg = iface.capillary_spectrum_ref(hs.mean(axis=1))
    s_sliceavg = np.mean([iface.capillary_spectrum_ref(hs[:, x, :])[1]
                          for x in range(hs.shape[1])], axis=0)
    np.savez(os.path.join(OUT, "nl_check.npz"),
             k=k, s_slice=s_slice, s_xavg=s_xavg, s_sliceavg=s_sliceavg,
             hk_slice=hk_slice, hk_xavg=hk_xavg,
             n_frames=len(hs), steps=args.steps, every=args.every,
             seed=args.seed)
    print(json.dumps({"steps": args.steps, "n_frames": int(len(hs)),
                      "wall_s": round(wall, 1),
                      "s_slice_m1_3": [float(x) for x in s_slice[:3]],
                      "s_xavg_m1_3": [float(x) for x in s_xavg[:3]]}))


if __name__ == "__main__":
    main()
