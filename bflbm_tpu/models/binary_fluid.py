"""Binary fluctuating-LBM model: initializers + the fused timestep.

Reference flow (``LBM_timestep``, LBM_binary.H:545-594) per step:
halo fills -> collide_stream -> buffer swap -> density pass -> COM ->
thermal noise -> full hydrovars.  The trailing (density/noise/hydrovars)
work of step n exists solely to feed the collide of step n+1 and the
outputs at frame n.  Functionally restructured here, one step is

    prelude:  hbar(f, g) -> draw noise -> real hydrovars
    collide:  MRT relaxation + forcing + noise in moment space
    stream:   pull shifts

which consumes/produces exactly the same (f, g, noise) sequence — the
noise drawn in step n's prelude is used both in the real-velocity
reconstruction (0.5 xi / rho term) and in the same step's collision kick,
matching the reference's pairing (SURVEY.md §3.2).  The hydro fields
returned by :func:`prelude` describe the state at the step's start, i.e.
the reference's output frame for that step index.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import LBMParams, RunConfig
from ..lattice import Q, W
from ..ops import collide as collide_ops
from ..ops import hydro as hydro_ops
from ..ops import noise as noise_ops
from ..ops import stream as stream_ops
from ..state import SimState, init_state


def prelude(state: SimState, params: LBMParams, ref_state=None, *,
            noise_source: str = "threefry", noise_dist: str = "clt4"):
    """Noise draw + real-hydrovar reconstruction for the current state.

    Returns (hydro, xi_f, xi_g, key') where key' is the advanced RNG key.
    Equivalent to the reference's end-of-step density/noise/hydrovars
    passes (LBM_binary.H:583-592) relocated to the consumer side.

    ref_state: optional (rho_eq, phi_eq, com_ref) enabling the
    reference's USE_REF_STATE noise path — amplitudes evaluated at the
    stored equilibrium state translated into the instantaneous
    center-of-mass frame (LBM_binary.H:92-106 + update_com per step).

    noise_source: "threefry" (bulk counter-based draw, default) or
    "hash" - the per-cell coordinate-keyed stream (the reference's
    RANDRAW ``draw_from_pdf_normal`` analog, LBM_binary.H:42-63).  The
    hash word is derived from the key split exactly as the GPU step
    kernel does (:func:`ops.noise.hash_word`), so a "hash" jnp trajectory
    consumes bitwise the noise of a kernel-engine trajectory.
    noise_dist: the hash stream's normal generator
    ("clt4"/"clt2"/"u8"/"bm").
    """
    hbar = hydro_ops.hydrovars_bar(state.f, state.g, params)
    key, sub = jax.random.split(state.key)
    if ref_state is not None:
        from ..observables import stats

        rho_eq, phi_eq, com_ref = ref_state
        com = stats.center_of_mass(hbar.rho)
        noise_ref = (rho_eq, phi_eq, com - jnp.asarray(com_ref))
    else:
        noise_ref = None
    if noise_source == "hash" and params.noise_on:
        xi_f, xi_g = noise_ops.thermal_noise_hash(
            noise_ops.hash_word(sub), state.step, hbar.rho, hbar.phi,
            params, noise_ref, noise_dist)
    else:
        xi_f, xi_g = noise_ops.thermal_noise(sub, hbar.rho, hbar.phi,
                                             params, noise_ref)
    h = hydro_ops.hydrovars(state.f, state.g, xi_f, xi_g, params, hbar)
    return h, xi_f, xi_g, key


def step(state: SimState, params: LBMParams, ref_state=None, *,
         noise_source: str = "threefry",
         noise_dist: str = "clt4") -> Tuple[SimState, hydro_ops.Hydro]:
    """One full LB timestep; returns (new_state, hydro-at-step-start)."""
    h, xi_f, xi_g, key = prelude(state, params, ref_state,
                                 noise_source=noise_source,
                                 noise_dist=noise_dist)
    f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g, params)
    f2 = stream_ops.stream(f1)
    g2 = stream_ops.stream(g1)
    return SimState(f=f2, g=g2, key=key, step=state.step + 1), h


def compute_hydro(state: SimState, params: LBMParams) -> hydro_ops.Hydro:
    """Hydro fields for the current state (consumes the same RNG draw the
    next step would — matches the reference writing hydrovs computed with
    the noise that feeds the following collide)."""
    h, _, _, _ = prelude(state, params)
    return h


def nsteps(state: SimState, params: LBMParams, n: int,
           noise_source: str = "threefry",
           noise_dist: str = "clt4") -> SimState:
    """Run n steps under lax.scan (jit-friendly inner loop)."""

    def body(s, _):
        s, _h = step(s, params, noise_source=noise_source,
                     noise_dist=noise_dist)
        return s, None

    out, _ = jax.lax.scan(body, state, None, length=n)
    return out


# ---------------------------------------------------------------------------
# Initializers (LBM_binary.H:598-742).  All set populations to the rest
# equilibrium f_i = w_i * density; the hydro bootstrap happens lazily in
# the first step's prelude.
# ---------------------------------------------------------------------------

def _rest_populations(rho_field: jnp.ndarray) -> jnp.ndarray:
    w = jnp.asarray(W, rho_field.dtype).reshape((Q,) + (1,) * rho_field.ndim)
    return w * rho_field[None]


def init_mixture(shape, params: LBMParams, seed: int = 12345,
                 dtype=jnp.float32, c1: float = 0.5,
                 c2: float = 0.5) -> SimState:
    """Uniform mixture rho = 2*C1, phi = 2*C2 (LBM_binary.H:598-629)."""
    rho = jnp.full(shape, 2.0 * c1, dtype)
    phi = jnp.full(shape, 2.0 * c2, dtype)
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def _grid(shape, dtype):
    return jnp.meshgrid(
        *[jnp.arange(n, dtype=dtype) for n in shape], indexing="ij"
    )


def _tanh(x):
    """tanh with the argument clamped to the saturation range.

    XLA's tanh lowering can overflow to NaN for |x| >~ 1e2 on some
    backends; tanh is exactly +-1 there at any float precision, so
    clamping is exact."""
    return jnp.tanh(jnp.clip(x, -25.0, 25.0))


def init_stripe(shape, params: LBMParams, seed: int = 12345,
                dtype=jnp.float32, frac: float = 0.5,
                width: float = 0.0) -> SimState:
    """Double-tanh slab along z (LBM_init_stripe, LBM_binary.H:664-695).

    rho rises from rho_lo to rho_hi inside |z - Lz/2| < frac*Lz/2 with
    interface width sqrt(kappa); phi = (rho_hi + rho_lo) - rho.
    width > 0 overrides sqrt(kappa) (RunConfig.init_width).
    """
    _, _, z = _grid(shape, dtype)
    lz = shape[2]
    pos = z - lz // 2
    pos_lo = -0.5 * frac * lz
    pos_hi = 0.5 * frac * lz
    width = width or float(jnp.sqrt(jnp.asarray(params.kappa)))
    rho = (params.rho_hi - params.rho_lo) * 0.5 * (
        _tanh((pos - pos_lo) / width) + _tanh((pos_hi - pos) / width)
    ) + params.rho_lo
    rho_t = params.rho_hi + params.rho_lo
    phi = rho_t - rho
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def init_droplet(shape, params: LBMParams, seed: int = 12345,
                 dtype=jnp.float32, radius: float = 0.2,
                 width: float = 0.0) -> SimState:
    """Tanh sphere of f inside g (LBM_init_droplet, LBM_binary.H:699-742).

    radius is a fraction of the box x-extent; center offsets replicate the
    reference's x/y centers at L/2. (its z uses box[0]/2, identical for
    cubic domains).  width > 0 overrides the sqrt(kappa) interface width
    — the stabilized-start protocol for deep quenches (RunConfig
    .init_width): alpha0 >= 2.0 with the sub-cell sqrt(0.1) init width
    diverges within ~10 steps in float64 as well, so this is a model
    stability boundary of the *initialization*, not a precision issue.
    """
    x, y, z = _grid(shape, dtype)
    rx = x - shape[0] / 2.0
    ry = y - shape[1] / 2.0
    rz = z - shape[0] // 2  # reference uses box[0]/2 for z (LBM_binary.H:725)
    r = jnp.sqrt(rx * rx + ry * ry + rz * rz)
    cap_r = radius * shape[0]
    width = width or float(jnp.sqrt(jnp.asarray(params.kappa)))
    rho = (params.rho_hi - params.rho_lo) * 0.5 * (
        1.0 + _tanh((cap_r - r) / width)
    ) + params.rho_lo
    rho_t = params.rho_hi + params.rho_lo
    phi = rho_t - rho
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def init_checkpoint(f: jnp.ndarray, g: jnp.ndarray, seed: int,
                    step: int) -> SimState:
    """Restart from stored populations (LBM_init, LBM_binary.H:632-661)."""
    return init_state(jnp.asarray(f), jnp.asarray(g), seed, step)


def make_initial_state(cfg: RunConfig) -> SimState:
    """Dispatch on cfg.init the way main_run_job.cpp:248-292 does."""
    p = cfg.params
    if cfg.init == "mixture":
        return init_mixture(cfg.shape, p, cfg.seed, cfg.dtype)
    if cfg.init == "stripe":
        return init_stripe(cfg.shape, p, cfg.seed, cfg.dtype, cfg.init_frac,
                           cfg.init_width)
    if cfg.init == "droplet":
        return init_droplet(cfg.shape, p, cfg.seed, cfg.dtype,
                            cfg.init_radius, cfg.init_width)
    if cfg.init == "checkpoint":
        from ..io import checkpoint as ckpt
        from ..state import SimState

        if not cfg.checkpoint_path:
            raise ValueError("init='checkpoint' requires checkpoint_path")
        state = ckpt.load_state(cfg.checkpoint_path)
        if cfg.reseed:
            # independent-ensemble continuation: replace the stored RNG
            # key so runs branching from one shared (deterministic)
            # equilibration checkpoint draw independent noise streams
            import jax

            state = SimState(f=state.f, g=state.g,
                             key=jax.random.PRNGKey(cfg.seed),
                             step=state.step)
        return state
    raise ValueError(f"unknown init kind {cfg.init!r}")
