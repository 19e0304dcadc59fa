#!/usr/bin/env python
"""Benchmark: MLUPS of the step loop on one GPU.

Times `--steps`-step chunks of the engine that ``engine="auto"`` selects,
on the fluctuating mixture (preset ``bench-256``: 256^3, kBT=1e-5).
Prints the card's `name, power.limit` line, then one JSON line naming
the device it measured.  Exits non-zero when JAX finds no GPU.

    python bench.py [--shape X Y Z] [--steps N] [--coupled]
"""

import argparse
import json

import numpy as np

from bflbm_tpu import run as run_mod
from bflbm_tpu.config import preset
from bflbm_tpu.models import binary_fluid as model
from bflbm_tpu.utils import compile_cache, device
from bflbm_tpu.utils.timing import time_steps


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--kBT", type=float, default=1e-5)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--coupled", action="store_true",
                    help="alpha0=1.5 (the interface/droplet force path)")
    args = ap.parse_args()

    compile_cache.enable()
    device.require_gpu()
    cfg = preset("bench-256").replace(nsteps=args.steps).with_params(
        kBT=args.kBT, alpha0=1.5 if args.coupled else 0.0)
    if args.shape:
        cfg = cfg.replace(shape=tuple(args.shape))
    engine = run_mod.resolve_engine(cfg, "auto")
    _, run_chunk = run_mod.make_advance(cfg, engine, args.steps)
    carry = {"s": model.make_initial_state(cfg)}

    def once():
        carry["s"] = run_chunk(carry["s"])
        return carry["s"]

    res = time_steps(once, int(np.prod(cfg.shape)), args.steps, warmup=1,
                     repeats=args.repeats)
    print(device.nvidia_smi())
    X, Y, Z = cfg.shape
    print(json.dumps({
        "metric": f"MLUPS {X}x{Y}x{Z} D3Q19 binary FLBM (kBT={args.kBT}, "
                  f"alpha0={cfg.params.alpha0}, engine {engine})",
        "value": res["mlups"], "unit": "MLUPS", "times_s": res["times_s"],
        "device": device.describe()}))


if __name__ == "__main__":
    main()
