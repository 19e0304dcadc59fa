#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the multi-device engines
                                  # against one card, and nothing else

Phases, each printing one JSON line:

1. device   - platform, device kind and count, JAX version, and the
              card's `name, power.limit` from nvidia-smi;
2. compile  - the jnp step and the GPU step kernel at 256^3, with
              ``compiled.memory_analysis()``;
3. parity   - 10 steps of the kernel against the jnp reference at 256^3
              (kBT=0 mixture, kBT=0 droplet, fluctuating droplet with
              hash noise): atol 2e-5 on f and g, equal RNG keys;
4. main     - ``run.run`` end to end: the mixture-fluct preset at 256^3
              (frames, metrics, S(k), checkpoint, mass drift), a resume
              from its checkpoint, and the coupled droplet-fluct preset
              at 128^3 with the online droplet fit;
5. timing   - ``run.run`` at 256^3, kBT=1e-5, production cadence, through
              the jnp engine and the kernel engine in turns, plus the
              bare 100-step chunk rate of each.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; it does the
same at once when JAX finds no GPU.  Run outputs go to ``out/chip_smoke``
inside the checkout and are deleted afterwards.
"""

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# 304 B/cell: read + write both 19-population float32 species once
MIN_BYTES_PER_CELL = 2 * 2 * 19 * 4
ATOL = 2e-5


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _mem(compiled):
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _configs():
    from bflbm_tpu.config import LBMParams

    droplet = dict(alpha0=1.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    return {
        "mixture_kBT0": LBMParams(alpha0=0.0, kBT=0.0),
        "droplet_kBT0": LBMParams(kBT=0.0, **droplet),
        "droplet_fluct": LBMParams(kBT=1e-5, **droplet),
    }


def _initial(name, params, shape):
    import jax.numpy as jnp

    from bflbm_tpu.models import binary_fluid as model

    if name.startswith("mixture"):
        st = model.init_mixture(shape, params, dtype=jnp.float32)
        # a uniform state is a fixed point at kBT=0: perturb it
        bump = 1e-3 * jnp.sin(jnp.arange(shape[2], dtype=jnp.float32)
                              * 0.37)
        return st._replace(f=st.f * (1.0 + bump))
    return model.init_droplet(shape, params, dtype=jnp.float32, radius=0.25)


def phase_device():
    import jax

    from bflbm_tpu.utils import device

    emit("device", **device.describe(), jax=jax.__version__,
         nvidia_smi=device.nvidia_smi())


def phase_compile(shape, interpret=False):
    import jax

    from bflbm_tpu.kernels import triton_step
    from bflbm_tpu.models import binary_fluid as model

    params = _configs()["droplet_fluct"]
    st = _initial("droplet_fluct", params, shape)
    out = {}
    for engine, fn in (
            ("jnp", lambda s: model.step(s, params, noise_source="hash")[0]),
            ("pallas", triton_step.make_step(params, shape,
                                             interpret=interpret))):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(st).compile()
        out[engine] = {"compile_s": time.perf_counter() - t0,
                       "memory": _mem(compiled)}
    emit("compile", shape=list(shape), **out)


def phase_parity(shape, nsteps=10, interpret=False):
    import jax
    import numpy as np

    from bflbm_tpu.kernels import triton_step
    from bflbm_tpu.models import binary_fluid as model

    res = {}
    for name, params in _configs().items():
        st0 = _initial(name, params, shape)
        with jax.default_matmul_precision("highest"):
            ref_step = jax.jit(
                lambda s, p=params: model.step(s, p, noise_source="hash")[0])
            ref = st0
            for _ in range(nsteps):
                ref = ref_step(ref)
            ref = jax.block_until_ready(ref)
        k_step = jax.jit(triton_step.make_step(params, shape,
                                               interpret=interpret))
        got = st0
        for _ in range(nsteps):
            got = k_step(got)
        got = jax.block_until_ready(got)
        df = float(np.max(np.abs(np.asarray(got.f) - np.asarray(ref.f))))
        dg = float(np.max(np.abs(np.asarray(got.g) - np.asarray(ref.g))))
        keys = bool(np.array_equal(np.asarray(got.key), np.asarray(ref.key)))
        finite = bool(np.isfinite(np.asarray(got.f)).all())
        res[name] = {"max_abs_df": df, "max_abs_dg": dg, "keys_equal": keys}
        check(finite and keys and df <= ATOL and dg <= ATOL,
              f"parity {name}: df={df} dg={dg} keys={keys} finite={finite}")
        del ref, got
    emit("parity", shape=list(shape), steps=nsteps, atol=ATOL, **res)


def _out_dir(tag):
    path = os.path.join(ROOT, "out", "chip_smoke", tag)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def phase_main(shape, drop_shape, interpret=False):
    import glob

    import numpy as np

    from bflbm_tpu import run as run_mod
    from bflbm_tpu.config import preset
    from bflbm_tpu.io import native

    engine = run_mod.resolve_engine(preset("mixture-fluct"), "auto")
    kw = dict(interpret=interpret) if engine == "pallas" else {}
    out = _out_dir("main")
    cfg = preset("mixture-fluct").replace(
        shape=shape, init="mixture", step_continue=0, nsteps=300,
        plot_int=100, print_int=100, sf_window=200, sf_every=100,
        out_dir=out)
    t0 = time.perf_counter()
    state = run_mod.run(cfg, **kw)
    wall = time.perf_counter() - t0
    frames = sorted(glob.glob(os.path.join(out, "plt*")))
    recs = [r for r in _metrics(out) if "mass_f" in r]
    sk = os.path.join(out, "structfact0000300.npz")
    check(len(frames) == 4, f"frames: {frames}")
    check(len(recs) == 3, f"metrics records: {len(recs)}")
    check(os.path.exists(sk), "no structfact0000300.npz")
    with np.load(sk) as d:
        check(d["s_k"].shape == (22,) + tuple(shape), "s_k shape")
        check(bool(np.isfinite(d["s_k"]).all()), "s_k not finite")
    f = np.asarray(state.f, np.float64)
    check(bool(np.isfinite(f).all()), "state not finite")
    mass0 = float(np.prod(shape))  # init_mixture: rho = 1 per cell
    drift = abs(f.sum() - mass0) / mass0
    check(drift < 1e-6, f"relative mass drift {drift}")
    del f, state

    ck = os.path.join(out, "checkpoint0000300")
    cfg_r = cfg.replace(init="checkpoint", checkpoint_path=ck,
                        step_continue=300, nsteps=100, sf_window=0,
                        out_dir=_out_dir("resume"))
    st_r = run_mod.run(cfg_r, **kw)
    check(int(st_r.step) == 400, f"resume ended at {int(st_r.step)}")
    check(bool(np.isfinite(np.asarray(st_r.f)).all()), "resume not finite")
    del st_r

    drop = _out_dir("droplet")
    cfg_d = preset("droplet-fluct").replace(
        shape=drop_shape, init="droplet", step_continue=0, nsteps=200,
        plot_int=100, droplet_int=100, print_int=100, out_dir=drop)
    st_d = run_mod.run(cfg_d, **kw)
    fits = [r for r in _metrics(drop) if "droplet_R_mass" in r]
    check(len(fits) == 2, f"droplet records: {len(fits)}")
    check(bool(np.isfinite(np.asarray(st_d.f)).all()), "droplet not finite")
    emit("main", engine=engine, shape=list(shape), wall_s=wall,
         frames=len(frames), mass_drift_rel=drift,
         mlups_loop=recs[-1]["mlups"], resume_step=400,
         droplet_R_mass=[r["droplet_R_mass"] for r in fits],
         native_writer=native.available(), peak_bytes_in_use=_peak_bytes())
    shutil.rmtree(os.path.join(ROOT, "out", "chip_smoke"),
                  ignore_errors=True)


def _chunk_rate(cfg, engine, steps, interpret, repeats=3):
    """MLUPS of bare `steps`-step chunks (the step loop without I/O)."""
    import numpy as np

    from bflbm_tpu import run as run_mod
    from bflbm_tpu.models import binary_fluid as model
    from bflbm_tpu.utils.timing import time_steps

    _, run_chunk = run_mod.make_advance(cfg, engine, steps,
                                        interpret=interpret)
    carry = {"s": model.make_initial_state(cfg)}

    def once():
        carry["s"] = run_chunk(carry["s"])
        return carry["s"]

    return time_steps(once, int(np.prod(cfg.shape)), steps, warmup=1,
                      repeats=repeats)["mlups"]


def phase_timing(shape, nsteps=300, interpret=False):
    import numpy as np

    from bflbm_tpu import run as run_mod
    from bflbm_tpu.config import preset
    from bflbm_tpu.utils import device

    cfg = preset("mixture-fluct").replace(
        shape=shape, init="mixture", step_continue=0, nsteps=nsteps,
        plot_int=100, print_int=100, sf_every=100, sf_window=nsteps)
    cells = int(np.prod(shape))
    kw = {"pallas": dict(interpret=interpret), "jnp": {}}
    for engine in ("jnp", "pallas"):  # compile, fill the compile cache
        run_mod.run(cfg.replace(out_dir=_out_dir("warm")), engine=engine,
                    **kw[engine])
    runs = {"jnp": [], "pallas": []}
    for engine in ("jnp", "pallas", "pallas", "jnp"):
        out = _out_dir(f"time_{engine}")
        t0 = time.perf_counter()
        run_mod.run(cfg.replace(out_dir=out), engine=engine, **kw[engine])
        wall = time.perf_counter() - t0
        recs = _metrics(out)
        runs[engine].append({"mlups_call": cells * nsteps / wall / 1e6,
                             "mlups_loop": recs[-1]["mlups"],
                             "setup_compile_s": recs[0]["compile_s"],
                             "call_s": wall})
    peak = device.PEAK_HBM_BYTES_PER_S.get(device.describe()["kind"])
    res = {}
    for engine in ("jnp", "pallas"):
        chunk = _chunk_rate(cfg.replace(nsteps=100), engine, 100,
                            kw[engine].get("interpret", False))
        bps = chunk * 1e6 * MIN_BYTES_PER_CELL
        res[engine] = {"run_run": runs[engine], "mlups_chunk100": chunk,
                       "bytes_per_s_at_304B": bps,
                       "share_of_peak": bps / peak if peak else None}
    emit("timing", shape=list(shape), steps=nsteps,
         cadence={"print_int": 100, "plot_int": 100, "sf_every": 100},
         peak_hbm_bytes_per_s=peak, peak_bytes_in_use=_peak_bytes(), **res)
    shutil.rmtree(os.path.join(ROOT, "out", "chip_smoke"),
                  ignore_errors=True)


def phase_four(shape, weak_shape, nsteps=50):
    """GSPMD and halo engines over a (4, 1, 1) mesh against one card."""
    import jax
    import numpy as np

    from bflbm_tpu import run as run_mod
    from bflbm_tpu.config import preset
    from bflbm_tpu.parallel import mesh as mesh_lib

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, not 4")
    cfg = preset("mixture-fluct").replace(
        shape=shape, init="mixture", step_continue=0, nsteps=nsteps,
        plot_int=0, print_int=nsteps, sf_window=0, noise_source="hash",
        out_dir=_out_dir("one"))
    ref = run_mod.run(cfg)
    rf, rg = np.asarray(ref.f), np.asarray(ref.g)
    rkey = np.asarray(ref.key)
    del ref
    mesh = mesh_lib.make_mesh((4, 1, 1))
    res = {}
    for engine in ("jnp", "halo"):
        got = run_mod.run(cfg.replace(out_dir=_out_dir(engine)), mesh=mesh,
                          engine=engine)
        df = float(np.max(np.abs(np.asarray(got.f) - rf)))
        dg = float(np.max(np.abs(np.asarray(got.g) - rg)))
        keys = bool(np.array_equal(np.asarray(got.key), rkey))
        check(df <= ATOL and dg <= ATOL and keys,
              f"{engine} mesh vs one card: df={df} dg={dg} keys={keys}")
        res[engine] = {"max_abs_df": df, "max_abs_dg": dg}
        del got
    weak = cfg.replace(shape=weak_shape, noise_source="threefry")
    cells = int(np.prod(weak_shape))
    from bflbm_tpu.models import binary_fluid as model
    from bflbm_tpu.utils.timing import time_steps

    for engine in ("jnp", "halo"):
        _, run_chunk = run_mod.make_advance(weak, engine, 100, mesh=mesh)
        carry = {"s": mesh_lib.shard_state(model.make_initial_state(weak),
                                           mesh)}

        def once():
            carry["s"] = run_chunk(carry["s"])
            return carry["s"]

        res[engine]["weak_mlups_chunk100"] = time_steps(
            once, cells, 100, warmup=1, repeats=3)["mlups"]
        del carry
    emit("four", mesh=[4, 1, 1], shape=list(shape), steps=nsteps,
         atol=ATOL, weak_shape=list(weak_shape), **res)
    shutil.rmtree(os.path.join(ROOT, "out", "chip_smoke"),
                  ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from bflbm_tpu.utils import compile_cache, device

    device.require_gpu()
    compile_cache.enable()
    phase_device()
    n = 256
    if args.four:
        phase_four((n, n, n), (2 * n, n, n))
    else:
        phase_compile((n, n, n))
        phase_parity((n, n, n))
        phase_main((n, n, n), (n // 2,) * 3)
        phase_timing((n, n, n))
    print(device.nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": device.describe()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
