"""Run driver + CLI: the replacement for ``main_run_job.cpp``.

Implements the reference pipeline (SURVEY.md §3.1) as a library function
plus a CLI: init (mixture/stripe/droplet/checkpoint) -> scanned step loop
with frame output, online structure-factor accumulation over the trailing
window, NaN sentinel, metrics -> end-of-run checkpoint -> (deterministic
runs) trailing-window time-average stored as the equilibrium-state
artifact (main_run_job.cpp:428-439).

Usage:
    python -m bflbm_tpu.run --preset mixture-eq --out out/mixture
    python -m bflbm_tpu.run --preset droplet-eq --nsteps 2000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import LBMParams, RunConfig, preset, preset_names
from .io import checkpoint as ckpt
from .io import fields as fields_io
from .io.metrics import MetricsWriter
from .models import binary_fluid as model
from .observables import structfact as sf_lib
from .ops import hydro as hydro_ops
from .state import SimState
from .utils import compile_cache, debug


def _chunked(total: int, chunk: int):
    done = 0
    while done < total:
        n = min(chunk, total - done)
        yield done, n
        done += n


def _pick_chunk(events, nsteps: int, cap: int) -> int:
    """Steps per device execution: gcd of the event cadences, capped.

    Sparse cadences (e.g. print_int=5000 as the only event) would
    otherwise become one long device call that starves the NaN sentinel
    and the progress records.  The cap keeps every event on a chunk
    boundary by taking the largest divisor of the gcd <= cap (cap 0 =
    uncapped).  With no events there is no boundary-alignment constraint
    (the run loop handles a remainder chunk), so return min(nsteps, cap)
    rather than a divisor - a prime nsteps must not degrade the chunk
    to 1."""
    if not events:
        return min(nsteps, cap) if cap else nsteps
    chunk = events[0]
    for v in events[1:]:
        chunk = math.gcd(chunk, v)
    chunk = max(1, min(chunk, nsteps))
    if cap and chunk > cap:
        chunk = max(d for d in range(1, cap + 1) if chunk % d == 0)
    return chunk


ENGINES = ("auto", "jnp", "pallas", "halo")


def resolve_engine(cfg: RunConfig, engine: str, mesh=None,
                   interpret: bool = False) -> str:
    """The engine a run uses: 'jnp', 'pallas' (GPU step kernel, single
    device) or 'halo' (shard_map + ppermute; needs a mesh).

    'auto' is the step kernel on one GPU, in float32, without
    USE_REF_STATE, and the jnp scan otherwise (GSPMD-sharded under a
    multi-device mesh); a non-default noise_source is a jnp-engine
    selection, which 'pallas' rejects: the kernel always draws the hash
    stream (with cfg.noise_dist).  'pallas' needs a GPU, or
    interpret=True (Pallas interpreter, CPU tests), and rejects
    USE_REF_STATE and multi-device meshes."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "auto":
        kernel_ok = (jax.devices()[0].platform == "gpu"
                     and (mesh is None or mesh.size == 1)
                     and not cfg.use_ref_state
                     and cfg.noise_source == "threefry"
                     and jnp.dtype(cfg.dtype) == jnp.float32)
        return "pallas" if kernel_ok else "jnp"
    if engine == "pallas":
        if cfg.noise_source != "threefry":
            raise ValueError(
                f"noise_source={cfg.noise_source!r} selects the jnp "
                "engines' stream; engine 'pallas' always draws the hash "
                "stream (set noise_dist to choose its generator)")
        if cfg.use_ref_state:
            raise ValueError(
                "engine 'pallas' does not implement USE_REF_STATE noise; "
                "use engine='jnp'")
        if mesh is not None and mesh.size > 1:
            raise ValueError("engine 'pallas' runs on one device; use "
                             "engine='jnp' (GSPMD) or 'halo' with a mesh")
        if jax.devices()[0].platform != "gpu" and not interpret:
            raise ValueError(
                "engine 'pallas' compiles for a GPU; on "
                f"{jax.devices()[0].platform!r} pass interpret=True to "
                "run it through the Pallas interpreter")
    if engine == "halo":
        if mesh is None:
            raise ValueError("engine 'halo' needs a mesh")
        if cfg.use_ref_state:
            raise ValueError("engine 'halo' does not implement "
                             "USE_REF_STATE noise; use engine='jnp'")
    return engine


def noise_args(cfg: RunConfig, engine: str) -> dict:
    """The noise stream an engine draws: RunConfig.noise_source for the
    jnp and halo engines; the kernel engine always draws the
    coordinate-keyed hash stream."""
    return dict(noise_source="hash" if engine == "pallas"
                else cfg.noise_source, noise_dist=cfg.noise_dist)


def make_advance(cfg: RunConfig, engine: str, chunk: int, *, mesh=None,
                 interpret: bool = False, ref_state=None):
    """(step_plain, run_chunk) for a resolved engine: jitted, donating
    one-step and `chunk`-step advances of a SimState (run_chunk is None
    for chunk <= 1)."""
    p = cfg.params
    nsrc = noise_args(cfg, engine)
    if engine == "pallas":
        from .kernels import triton_step

        one_step = triton_step.make_step(p, cfg.shape, cfg.dtype,
                                         noise_dist=cfg.noise_dist,
                                         interpret=interpret)
    else:
        def one_step(s):
            return model.step(s, p, ref_state, **nsrc)[0]
    step_plain = jax.jit(one_step, donate_argnums=0)
    if engine == "halo":
        if chunk <= 2:
            raise ValueError(
                f"engine 'halo' needs chunks > 2 steps, not {chunk}")
        from .parallel import halo as halo_par

        return step_plain, halo_par.make_halo_nsteps(mesh, p, chunk, **nsrc)
    if chunk <= 1:
        return step_plain, None

    def scan_chunk(s):
        def body(st, _):
            return one_step(st), None
        out, _ = jax.lax.scan(body, s, None, length=chunk)
        return out

    return step_plain, jax.jit(scan_chunk, donate_argnums=0)


def run(cfg: RunConfig, *, mesh=None, engine: str = "auto",
        on_frame: Optional[Callable] = None,
        interpret: bool = False) -> SimState:
    """Execute a configured run; returns the final state.

    mesh: optional jax.sharding.Mesh for multi-device execution (GSPMD).
    engine: 'auto', 'jnp', 'pallas' or 'halo' (see :func:`resolve_engine`).
    on_frame(step, packed_hydro) is called at plot_int cadence.
    interpret: run engine='pallas' through the Pallas interpreter (CPU).
    """
    engine = resolve_engine(cfg, engine, mesh, interpret)
    p = cfg.params
    state = model.make_initial_state(cfg)
    if mesh is not None:
        from .parallel import mesh as mesh_lib

        state = mesh_lib.shard_state(state, mesh)

    os.makedirs(cfg.out_dir, exist_ok=True)
    metrics = MetricsWriter(os.path.join(cfg.out_dir, "metrics.jsonl"))

    # async frame writer: large frames go to background writer threads
    # (reference analog: AMReX async plotfile I/O)
    frame_writer = None
    if cfg.plot_int > 0 and cfg.plot_save and cfg.plot_fmt in ("auto",
                                                               "native"):
        nbytes = 22 * int(np.prod(cfg.shape)) * np.dtype(np.float32).itemsize
        if nbytes >= fields_io._AUTO_NATIVE_BYTES:
            from .io import native as native_io

            if native_io.available():
                frame_writer = native_io.AsyncFieldWriter()
            else:
                warnings.warn(
                    "native frame writer unavailable (native/ build "
                    "failed); writing frames synchronously", stacklevel=2)

    # USE_REF_STATE noise path: amplitudes from the stored equilibrium
    # state in the COM frame (main_run_job.cpp:216-235 + LBM_binary.H:92)
    ref_state = None
    if cfg.use_ref_state:
        if not cfg.ref_state_path:
            raise ValueError("use_ref_state requires ref_state_path")
        from .observables import stats as stats_obs

        rho_eq, phi_eq, _ = ckpt.load_equilibrium(cfg.ref_state_path)
        rho_eq = jnp.asarray(rho_eq, cfg.dtype)
        phi_eq = jnp.asarray(phi_eq, cfg.dtype)
        com_ref = np.asarray(stats_obs.center_of_mass(rho_eq))
        ref_state = (rho_eq, phi_eq, com_ref)

    nsrc = noise_args(cfg, engine)
    hydro_only = jax.jit(
        lambda s: hydro_ops.pack(model.prelude(s, p, ref_state, **nsrc)[0]))
    noise_only = (jax.jit(
        lambda s: model.prelude(s, p, ref_state, **nsrc)[1:3])
        if cfg.out_noise_int > 0 else None)

    # Bulk advancement: between observable events, advance `chunk` steps
    # in one device execution.
    events = [v for v in (cfg.plot_int, cfg.print_int, cfg.out_noise_int,
                          cfg.droplet_int,
                          cfg.sf_every if (p.noise_on and cfg.sf_window)
                          else 0) if v]
    chunk = _pick_chunk(events, cfg.nsteps, cfg.chunk_cap)
    if events and chunk < min(min(events), 50) and chunk < cfg.nsteps:
        warnings.warn(
            f"event cadences {events} give a chunk of only {chunk} "
            "step(s): every chunk pays a host round trip - make the "
            "cadences multiples of a common base", stacklevel=2)
    step_plain, run_chunk = make_advance(cfg, engine, chunk, mesh=mesh,
                                         interpret=interpret,
                                         ref_state=ref_state)
    # Noise dumps (WriteOutNoise analog, Debug.H:381-409) are exact for
    # every dumped step: out_noise_int divides the chunk size (gcd above),
    # so each dump lands on a chunk boundary where `noise_only(state)`
    # draws the split the next chunk's first step consumes.

    # structure factors over the trailing window (main_run_job.cpp:330,342-349)
    sf_state = None
    sf_start = cfg.step_continue + cfg.nsteps - cfg.sf_window
    use_sf = p.noise_on and cfg.sf_window > 0

    # frame 0 output (main_run_job.cpp:313-323)
    first = int(state.step)
    if cfg.plot_int > 0 and cfg.step_continue == 0:
        packed = hydro_only(state)
        if cfg.plot_save:
            fields_io.write_frame(cfg.out_dir, first, packed,
                                  fmt=cfg.plot_fmt)
        if on_frame:
            on_frame(first, packed)

    # equilibrium-state trailing average (deterministic runs)
    eq_accum = None
    eq_count = 0
    eq_paths = []  # frame files in the window, for the convergence report
    eq_start = cfg.step_continue + cfg.nsteps - cfg.t_window

    if run_chunk is not None:
        # compile the chunk before the clock starts, so that the mlups
        # records measure stepping; the set-up is logged once
        t_c = time.perf_counter()
        run_chunk.lower(state).compile()
        metrics.log(first, compile_s=time.perf_counter() - t_c)
    t0 = time.perf_counter()
    last = cfg.step_continue + cfg.nsteps
    step_i = first
    try:
        while step_i < last:
            n = min(chunk, last - step_i)
            if run_chunk is not None and n == chunk:
                state = run_chunk(state)
            else:
                for _ in range(n):
                    state = step_plain(state)
            step_i += n

            dump_due = (noise_only is not None
                        and step_i % cfg.out_noise_int == 0)
            need_hydro = (
                (cfg.plot_int > 0 and step_i % cfg.plot_int == 0)
                or (use_sf and step_i >= sf_start and step_i % cfg.sf_every == 0)
                or (cfg.print_int > 0 and step_i % cfg.print_int == 0)
                or (cfg.droplet_int > 0 and step_i % cfg.droplet_int == 0)
                or step_i == last
            )
            if dump_due:
                xi_f, xi_g = noise_only(state)
                fields_io.write_noise_frame(cfg.out_dir, step_i, xi_f, xi_g)

            packed = hydro_only(state) if need_hydro else None

            if use_sf and step_i >= sf_start and step_i % cfg.sf_every == 0:
                if sf_state is None:
                    sf_state = sf_lib.init_structfact(
                        len(sf_lib.REFERENCE_PAIRS), cfg.shape)
                sf_state = sf_lib.accumulate(sf_state, packed,
                                             sf_lib.REFERENCE_PAIRS)

            if cfg.plot_int > 0 and step_i % cfg.plot_int == 0:
                if cfg.plot_save:
                    path = fields_io.write_frame(cfg.out_dir, step_i, packed,
                                                 fmt=cfg.plot_fmt,
                                                 writer=frame_writer)
                if on_frame:
                    on_frame(step_i, packed)
                if not p.noise_on and cfg.t_window > 0 and step_i >= eq_start:
                    arr = np.asarray(packed)
                    eq_accum = arr if eq_accum is None else eq_accum + arr
                    eq_count += 1
                    if cfg.plot_save:
                        eq_paths.append(path)

            if cfg.droplet_int > 0 and step_i % cfg.droplet_int == 0:
                # online droplet-radius series (radius_steps_out analog:
                # the reference fits the droplet INSIDE the step loop and
                # appends (W, R) every plot_int, main_run_job.cpp:353-378
                # + Debug.H:360-378) — long campaigns get live
                # convergence monitoring instead of flying blind until
                # offline analysis; consumed by `analysis.py radius`
                metrics.log(step_i, **_droplet_record(np.asarray(packed[0])))

            if cfg.print_int > 0 and step_i % cfg.print_int == 0:
                rho = packed[0]
                rec = {"mlups": (step_i - first)
                       * np.prod(cfg.shape) / (time.perf_counter() - t0) / 1e6}
                if bool(debug.has_nonfinite(rho)):
                    ckpt.save_state(
                        os.path.join(cfg.out_dir, f"abort{step_i:07d}"), state)
                    raise FloatingPointError(
                        f"non-finite density at step {step_i}; "
                        "state checkpointed")
                st = debug.field_stats(rho)
                rec.update({k: float(v) for k, v in st.items()})
                rec["mass_f"] = float(debug.mass(state.f))
                rec["mass_g"] = float(debug.mass(state.g))
                metrics.log(step_i, **rec)

    finally:
        # drain pending async frame writes on ANY exit (an exception
        # or interrupt mid-run must not silently drop submitted frames;
        # the eq read-back below also needs the frames on disk)
        if frame_writer is not None:
            frame_writer.close()

    # end-of-run artifacts
    ckpt.save_state(
        os.path.join(cfg.out_dir, f"checkpoint{last:07d}"), state,
        extra={"config": _cfg_json(cfg)})
    if sf_state is not None:
        s = np.asarray(sf_lib.finalize(sf_state))
        np.savez(os.path.join(cfg.out_dir, f"structfact{last:07d}.npz"),
                 s_k=s, pairs=np.asarray(sf_lib.REFERENCE_PAIRS),
                 names=np.asarray(sf_lib.pair_names()))
    if eq_accum is not None and eq_count > 0:
        mean = eq_accum / eq_count
        ckpt.save_equilibrium(
            os.path.join(cfg.out_dir, "equilibrium"),
            mean[0], mean[1], mean[5])
        # PrintConvergence analog (Debug.H:276-358): deviation field
        # (1/N) sum_t |rho_t - rho_mean| over the trailing window, reported
        # as ||.||_1 (cell mean) and ||.||_inf (cell max) norms.
        conv = {"window_frames": eq_count}
        if eq_paths:
            dev = np.zeros_like(mean[0])
            for path in eq_paths:
                dev += np.abs(fields_io.read_frame(path)["rho"] - mean[0])
            dev /= len(eq_paths)
            conv.update({"rho_dev_l1": float(dev.mean()),
                         "rho_dev_linf": float(dev.max()),
                         "window_frames": len(eq_paths)})
        with open(os.path.join(cfg.out_dir, "convergence.json"), "w") as fh:
            json.dump(conv, fh)
        metrics.log(last, **conv)
    metrics.close()
    return state


def _droplet_record(rho: np.ndarray) -> dict:
    """One online droplet-fit record: tanh-profile (R, W) fit about the
    excess-mass COM (fittingDropletParams, LBM_hydrovs.H:117-213) plus
    the always-robust equivalent-sphere radius.  A non-converged tanh
    fit (e.g. mid-quench, no droplet yet) drops the (R, W) keys but
    still logs R_mass and the COM."""
    from .observables import droplet as drop_obs

    excess = rho - rho[0, 0, 0]
    com = drop_obs.center_of_mass(excess)
    rec = {"droplet_com": [float(c) for c in com],
           "droplet_R_mass": float(drop_obs.radius_from_mass(rho))}
    try:
        fit = drop_obs.fit_droplet(rho, com)
    except (RuntimeError, ValueError):
        return rec
    rec["droplet_R"] = fit["R"]
    rec["droplet_W"] = fit["W"]
    return rec


def _cfg_json(cfg: RunConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(np.dtype(cfg.dtype)) if cfg.dtype else None
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=preset_names(), default="mixture-eq")
    ap.add_argument("--out", default=None)
    ap.add_argument("--nsteps", type=int, default=None)
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--kBT", type=float, default=None)
    ap.add_argument("--alpha0", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--plot-int", type=int, default=None)
    ap.add_argument("--print-int", type=int, default=None)
    ap.add_argument("--plot-fmt", default=None,
                    choices=["auto", "npz", "native", "h5", "amrex"])
    ap.add_argument("--sf-window", type=int, default=None)
    ap.add_argument("--sf-every", type=int, default=None)
    ap.add_argument("--out-noise-int", type=int, default=None)
    ap.add_argument("--init-width", type=float, default=None,
                    help="initial tanh interface width in cells "
                         "(0 = sqrt(kappa); stabilizes deep quenches)")
    ap.add_argument("--radius", type=float, default=None,
                    help="droplet init radius (fraction of box)")
    ap.add_argument("--rho-lo", type=float, default=None)
    ap.add_argument("--rho-hi", type=float, default=None)
    ap.add_argument("--kappa", type=float, default=None)
    ap.add_argument("--tau-f", type=float, default=None)
    ap.add_argument("--tau-g", type=float, default=None)
    ap.add_argument("--ref-state", default=None,
                    help="equilibrium artifact enabling USE_REF_STATE noise")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--mesh", type=int, nargs=3, default=None,
                    help="device mesh shape (x y z)")
    ap.add_argument("--engine", choices=ENGINES, default="auto")
    ap.add_argument("--noise-dist", default=None,
                    choices=["clt4", "clt2", "u8", "bm"],
                    help="normal generator of the hash noise stream (the "
                    "kernel engine's, and the jnp engine's with "
                    "--noise-source hash); clt2: exact first/second "
                    "moments, support +-2.44 sigma")
    ap.add_argument("--noise-source", default=None,
                    choices=["threefry", "hash"],
                    help="noise stream of the jnp and halo engines; "
                    "'hash' = per-cell coordinate-keyed (RANDRAW analog, "
                    "reconstructible)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a jax.profiler trace (TensorBoard/xprof "
                    "format) covering the whole run")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: call jax.distributed.initialize() "
                    "(coordinator/process env vars per the JAX docs) "
                    "before building the mesh; the state pytree is a "
                    "plain sharded array set, so nothing else changes")
    args = ap.parse_args(argv)
    compile_cache.enable()

    if args.distributed:
        jax.distributed.initialize()

    cfg = preset(args.preset)
    if args.out:
        cfg = cfg.replace(out_dir=args.out)
    if args.nsteps is not None:
        cfg = cfg.replace(nsteps=args.nsteps)
    if args.shape is not None:
        cfg = cfg.replace(shape=tuple(args.shape))
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.plot_int is not None:
        cfg = cfg.replace(plot_int=args.plot_int)
    if args.print_int is not None:
        cfg = cfg.replace(print_int=args.print_int)
    if args.plot_fmt is not None:
        cfg = cfg.replace(plot_fmt=args.plot_fmt)
    if args.sf_window is not None:
        cfg = cfg.replace(sf_window=args.sf_window)
    if args.sf_every is not None:
        cfg = cfg.replace(sf_every=args.sf_every)
    if args.out_noise_int is not None:
        cfg = cfg.replace(out_noise_int=args.out_noise_int)
    if args.radius is not None:
        cfg = cfg.replace(init_radius=args.radius)
    if args.init_width is not None:
        cfg = cfg.replace(init_width=args.init_width)
    if args.ref_state:
        cfg = cfg.replace(use_ref_state=True, ref_state_path=args.ref_state)
    for name in ("rho_lo", "rho_hi", "kappa", "tau_f", "tau_g"):
        v = getattr(args, name)
        if v is not None:
            cfg = cfg.with_params(**{name: v})
    if args.checkpoint:
        cfg = cfg.replace(checkpoint_path=args.checkpoint, init="checkpoint")
    if args.kBT is not None:
        cfg = cfg.with_params(kBT=args.kBT)
    if args.alpha0 is not None:
        cfg = cfg.with_params(alpha0=args.alpha0)
    if args.noise_source is not None:
        cfg = cfg.replace(noise_source=args.noise_source)
    if args.noise_dist is not None:
        cfg = cfg.replace(noise_dist=args.noise_dist)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
        cfg = cfg.replace(dtype=jnp.float64)

    mesh = None
    if args.mesh is not None:
        from .parallel import mesh as mesh_lib

        mesh = mesh_lib.make_mesh(tuple(args.mesh))

    import contextlib

    prof = (jax.profiler.trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with prof:
        state = run(cfg, mesh=mesh, engine=args.engine)
    print(json.dumps({"final_step": int(state.step),
                      "out_dir": cfg.out_dir}))


if __name__ == "__main__":
    main()
