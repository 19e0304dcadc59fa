#!/usr/bin/env python
"""Mass-drift sensitivity of the capillary spectrum (linear response).

Long f32 fluctuating runs gain total density at ~1.5-1.9e-8/step
(rounding bias of the collision arithmetic; see metrics.jsonl of any
production ensemble run: +1.5% over 800k steps at 8x256x64, +6% over
4M steps at 8x64x64).  The reference runs double (amrex::Real) where
the same bias is ~1e-17/step — invisible.  This script quantifies what
the drift does to the measured capillary spectrum by re-running the
benchmarks/capillary_model.py chain around the steady profile converged
from a (1+delta)-scaled initial state:

    python benchmarks/capillary_drift.py --delta 0.011
        # production geometry (Ny=256): per-mode gamma vs the base
        # prediction.  0.011 = the 24-run ensembles' window-mean excess.
    python benchmarks/capillary_drift.py --delta 0.0381 --geometry nl
        # the 8x64x64 nl-check run's window-mean excess; compares the
        # drift-adjusted prediction against its measured spectrum
        # (out/capillary_model/nlcompare.json must exist).

Headline result (ACCEPTANCE.md C-model/C-nl): gamma_m sensitivity is
MODE-DEPENDENT (+1.2%..+3.5% per 1.1% mass at m=2..8, -5.5% at m=1),
the measured per-mode values all lie between the t=0-base and
window-mean-drift predictions with the fast modes ON the drifted curve
(m8: 0.03 sigma), and the drift-adjusted prediction reproduces the real
nonlinear f32 accelerator run at 8x64x64 to 0.2-0.9% on all six channels.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import capillary_model as cm  # noqa: E402  (configures jax for CPU/x64)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bflbm_tpu.models import binary_fluid as model  # noqa: E402

BASE_OUT = cm.OUT


def converge_scaled_profile(delta):
    st = model.init_stripe((1, 1, cm.NZ), cm.PARAMS, dtype=jnp.float64)
    fg = (st.f * (1 + delta), st.g * (1 + delta))
    zero_n = jnp.zeros((33, 1, 1, cm.NZ), jnp.float64)

    @jax.jit
    def chunk(fg):
        def body(c, _):
            return cm.step_explicit(c, zero_n), None
        out, _ = jax.lax.scan(body, fg, None, length=2000)
        return out

    res = np.inf
    for _ in range(100):
        fg_new = chunk(fg)
        res = max(float(jnp.max(jnp.abs(fg_new[0] - fg[0]))),
                  float(jnp.max(jnp.abs(fg_new[1] - fg[1]))))
        fg = fg_new
        if res < 1e-14:
            break
    rho = np.asarray(jnp.sum(fg[0], axis=0))[0, 0]
    s = rho - cm.LEVEL
    k0 = [k for k in range(cm.NZ - 1) if s[k] > 0 >= s[k + 1]][-1]
    np.savez(os.path.join(cm.OUT, "profile.npz"), f=np.asarray(fg[0]),
             g=np.asarray(fg[1]), rho=rho, k0=k0, residual=res)
    print(json.dumps({"profile_residual": res, "k0": int(k0),
                      "mass_scale": float(rho.mean() / 1.55)}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--delta", type=float, required=True,
                    help="fractional mass excess of the drifted base")
    ap.add_argument("--geometry", choices=["prod", "nl"], default="prod")
    args = ap.parse_args()

    tag = f"drift{args.delta:g}_{args.geometry}"
    cm.OUT = os.path.join(os.path.dirname(BASE_OUT), f"capillary_{tag}")
    os.makedirs(cm.OUT, exist_ok=True)
    converge_scaled_profile(args.delta)
    cm.stage_kernels()
    cm.stage_reduce()

    G, HB, ml, bl, H, Hp = cm.load_reduced()
    kxs = 2.0 * np.pi * np.arange(5) / cm.NX_PHYS
    kx_w = np.array([1.0, 2.0, 2.0, 2.0, 1.0])
    out = {"delta": args.delta, "geometry": args.geometry}

    if args.geometry == "prod":
        base = json.load(open(os.path.join(BASE_OUT, "modes.json")))
        norm = cm.NX_PHYS * cm.NY_PHYS
        for m in cm.MODES_TABLE:
            ky = 2.0 * np.pi * m / cm.NY_PHYS
            per = [cm.solve_mode(G, HB, ml, bl, Hp, kxs[n], ky, norm)[0]
                   for n in range(5)]
            s_sl = cm.NY_PHYS ** 2 * float(np.sum(kx_w * np.array(per)))
            g_new = cm.KBT / (s_sl * ky ** 2)
            g_old = cm.KBT / (base[f"m{m}_slice"] * ky ** 2)
            out[f"m{m}"] = {"gamma_drift": round(g_new, 6),
                            "gamma_base": round(g_old, 6),
                            "sens_pct": round(100 * (g_new / g_old - 1), 3)}
            print(json.dumps({f"m{m}": out[f"m{m}"]}), flush=True)
    else:
        ny = 64
        norm = cm.NX_PHYS * ny
        meas = json.load(open(os.path.join(BASE_OUT, "nlcompare.json")))
        for m in (1, 2, 3):
            ky = 2.0 * np.pi * m / ny
            per = [cm.solve_mode(G, HB, ml, bl, Hp, kxs[n], ky, norm)[0]
                   for n in range(5)]
            ps = ny ** 2 * float(np.sum(kx_w * np.array(per)))
            px = ny ** 2 * per[0]
            out[f"m{m}"] = {
                "slice": {"pred_drift": ps, "ratio": round(
                    meas[f"m{m}"]["slice"]["measured"] / ps, 4)},
                "xavg": {"pred_drift": px, "ratio": round(
                    meas[f"m{m}"]["xavg"]["measured"] / px, 4)}}
            print(json.dumps({f"m{m}": out[f"m{m}"]}), flush=True)

    with open(os.path.join(cm.OUT, f"{tag}.json"), "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
