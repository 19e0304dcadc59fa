"""Run-time configuration for the fluctuating binary LBM.

The reference configures runs by editing compile-time constants and
macros and rebuilding (``LBM_binary.H:17-30`` model globals,
``main_run_job.cpp:24-26`` system macros, ``main_run_job.cpp:77-106``
"MAIN PARAMS SETTING" block, documented in ``Parameters``).  Here this
becomes plain dataclasses + named presets; every reference recipe in
``Parameters`` is reproducible from :func:`preset`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp

# float32 machine epsilon threshold used by the reference for safe division
# (FLT_EPSILON in hydrovars, LBM_binary.H:246-264) even in double builds.
FLT_EPSILON = 1.1920928955078125e-07


@dataclass(frozen=True)
class LBMParams:
    """Physical / model parameters (reference: ``LBM_binary.H:17-30``).

    tau_f, tau_g : bare relaxation times; effective tau_bar = tau + 1/2
        (``collide``, LBM_binary.H:504-505).  kinematic viscosity
        eta = rho cs^2 (tau_bar - 1/2).
    alpha0 : cross-species coupling strength (G in the papers).
    alpha1 : square-gradient coefficient.  Disabled (0) in the reference;
        when 0 we also skip the dead 361-point grad-laplacian stencil the
        reference still evaluates (LBM_binary.H:232-235, unused result).
    kBT : thermal noise temperature.  kBT == 0 switches noise off
        (``main_run_job.cpp:63``).
    kappa : interface-width parameter; only used in initial tanh profiles
        (LBM_binary.H:681,731).
    use_sc_pseudo / sc_ref_density : Shan-Chen pseudopotential
        psi(rho) = rho0 (1 - exp(-rho/rho0)) vs raw density
        (LBM_binary.H:23-24).
    rho_lo / rho_hi : density bounds for stripe / droplet initial profiles.
    """

    tau_f: float = 0.5
    tau_g: float = 0.5
    alpha0: float = 0.0
    alpha1: float = 0.0
    kBT: float = 0.0
    kappa: float = 1.0
    use_sc_pseudo: bool = False
    sc_ref_density: float = 1.0
    rho_lo: float = 0.0
    rho_hi: float = 1.0
    div_eps: float = FLT_EPSILON  # |rho| guard for divisions

    @property
    def noise_on(self) -> bool:
        return self.kBT != 0.0

    @property
    def tau_f_bar(self) -> float:
        return self.tau_f + 0.5

    @property
    def tau_g_bar(self) -> float:
        return self.tau_g + 0.5

    @property
    def lam_f(self) -> float:
        """lambda_bar = 1/(tau+1/2), the modified relaxation frequency."""
        return 1.0 / (self.tau_f + 0.5)

    @property
    def lam_g(self) -> float:
        return 1.0 / (self.tau_g + 0.5)

    @property
    def viscosity(self) -> float:
        """Kinematic viscosity prefactor cs^2 (tau_bar - 1/2) (per unit rho)."""
        return (self.tau_f_bar - 0.5) / 3.0


@dataclass(frozen=True)
class RunConfig:
    """Execution configuration (reference: ``main_run_job.cpp:77-106``)."""

    shape: Tuple[int, int, int] = (32, 32, 32)
    params: LBMParams = field(default_factory=LBMParams)
    seed: int = 12345  # LBM_binary.H:17
    nsteps: int = 500
    step_continue: int = 0
    plot_int: int = 0          # output hydro fields every N steps (0 = off)
    plot_save: bool = True     # False: plot_int drives on_frame callbacks
    #                            only (in-memory analysis, no disk frames)
    plot_fmt: str = "auto"     # 'auto'|'npz'|'native'|'h5'|'amrex'
    #                            (amrex = reference-compatible plotfile
    #                            dirs, io/amrex.py)
    print_int: int = 0         # log scalar diagnostics every N steps
    sf_window: int = 0         # trailing window (steps) for structure factors
    sf_every: int = 100        # accumulate S(k) every N steps inside window
    t_window: int = 0          # trailing window for equilibrium-state average
    out_dir: str = "out"
    dtype: Any = jnp.float32
    use_ref_state: bool = False  # noise amplitudes from stored eq state
    ref_state_path: Optional[str] = None  # equilibrium artifact (npz)
    out_noise_int: int = 0     # dump noise fields every N steps (0 = off)
    init: str = "mixture"      # mixture | stripe | droplet | checkpoint
    init_radius: float = 0.2   # droplet radius as fraction of box
    init_frac: float = 0.5     # stripe fraction of box (main_run_job.cpp:33)
    init_width: float = 0.0    # initial tanh interface width override in
    #                            cells; 0 = reference-exact sqrt(kappa)
    #                            (LBM_binary.H:681,731).  Deep quenches
    #                            (alpha0 >= 2) blow up — in f64 too — when
    #                            sqrt(kappa) is sub-cell: the init force
    #                            spike at the un-relaxed interface exceeds
    #                            the stable range.  Setting ~1.0 relaxes
    #                            the start without changing the converged
    #                            equilibrium (benchmarks/acceptance.py
    #                            d-sweep alpha0=2.0).
    checkpoint_path: Optional[str] = None
    reseed: bool = False       # checkpoint init: replace the stored RNG
    #                            key with PRNGKey(seed) (indep ensembles)
    noise_source: str = "threefry"  # jnp/halo-engine noise stream:
    #                            "threefry" (bulk counter-based draw) or
    #                            "hash" (the per-cell coordinate-keyed
    #                            stream the GPU step kernel always draws -
    #                            the RANDRAW draw_from_pdf_normal analog,
    #                            LBM_binary.H:42-63; makes a run's noise a
    #                            pure function of (key, step, cell):
    #                            reconstructible + mesh-invariant)
    noise_dist: str = "clt4"   # normal generator for noise_source="hash"
    #                            ("clt4" byte-sum / "clt2" byte-pair /
    #                            "u8" Ladd-style uniform / "bm"
    #                            Box-Muller)
    droplet_int: int = 0       # online droplet-radius fit every N steps,
    #                            logged to metrics.jsonl (the reference
    #                            fits the droplet inside the step loop
    #                            and appends radius_steps_out every
    #                            plot_int, main_run_job.cpp:353-378 +
    #                            Debug.H:360-378; 0 = off).  Consumed by
    #                            `analysis.py radius`.
    chunk_cap: int = 1000      # max steps per device execution.  Sparse
    #                            event cadences (e.g. print_int=5000 as
    #                            the only event) would otherwise become
    #                            one long device call that starves the
    #                            NaN sentinel and the progress records.
    #                            The cap picks the largest divisor of the
    #                            event gcd <= cap so every event still
    #                            lands on a chunk boundary.  0 = uncapped.

    def with_params(self, **kw) -> "RunConfig":
        return replace(self, params=replace(self.params, **kw))

    def replace(self, **kw) -> "RunConfig":
        return replace(self, **kw)


# ----------------------------------------------------------------------------
# Named presets reproducing the recipes in the reference `Parameters` file.
# Each physical case is a two-phase protocol: deterministic equilibration
# (kBT=0) then fluctuating continuation (kBT=1e-5) from the stored
# equilibrium state — kept here as paired presets.
# ----------------------------------------------------------------------------

_PRESETS: Dict[str, RunConfig] = {}


def _register(name: str, cfg: RunConfig) -> None:
    _PRESETS[name] = cfg


_register(
    "mixture-eq",  # Parameters: Mixture Step I
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=0.0, kBT=0.0),
        nsteps=500, plot_int=10, t_window=100, init="mixture",
    ),
)
_register(
    "mixture-fluct",  # Parameters: Mixture Step II
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=0.0, kBT=1e-5),
        nsteps=600_000, step_continue=500, plot_int=2000,
        sf_window=200_000, sf_every=100, init="checkpoint",
    ),
)
_register(
    "interface-eq",  # Parameters: Flat interface Step I
    RunConfig(
        shape=(8, 256, 64),
        params=LBMParams(alpha0=1.5, kBT=0.0, kappa=0.1,
                         rho_lo=0.1, rho_hi=3.0),
        nsteps=3000, plot_int=10, t_window=500, init="stripe",
    ),
)
_register(
    "interface-fluct",  # Parameters: Flat interface Step II
    RunConfig(
        shape=(8, 256, 64),
        params=LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1,
                         rho_lo=0.1, rho_hi=3.0),
        nsteps=800_000, step_continue=3000, plot_int=1000, init="checkpoint",
    ),
)
_register(
    "droplet-eq",  # Parameters: Droplet Case I, alpha0=1.5 family
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=1.5, kBT=0.0, kappa=0.1,
                         rho_lo=0.0, rho_hi=3.0),
        nsteps=20_000, plot_int=100, t_window=1000, droplet_int=100,
        init="droplet", init_radius=0.2,
    ),
)
_register(
    "droplet-fluct",  # Parameters: Droplet Case I Step II
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1,
                         rho_lo=0.0, rho_hi=3.0),
        nsteps=600_000, step_continue=20_000, plot_int=500, droplet_int=500,
        init="checkpoint",
    ),
)
_register(
    "droplet64-eq",  # Parameters: Droplet Case II
    RunConfig(
        shape=(64, 64, 64),
        params=LBMParams(alpha0=1.5, kBT=0.0, kappa=0.1,
                         rho_lo=0.0, rho_hi=3.0),
        nsteps=50_000, plot_int=200, t_window=10_000, droplet_int=200,
        init="droplet", init_radius=0.2,
    ),
)
# Droplet alpha0 variants documented in `Parameters` / Surface_Tension.ipynb
_register(
    "droplet-a0.8-eq",  # alpha0=0.8 family (radii 0.38-0.42)
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=0.8, kBT=0.0, kappa=0.1,
                         rho_lo=0.0, rho_hi=3.0),
        nsteps=20_000, plot_int=100, t_window=1000, droplet_int=100,
        init="droplet", init_radius=0.4,
    ),
)
_register(
    "droplet-a1.7-eq",  # alpha0=1.7 family
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=1.7, kBT=0.0, kappa=0.1,
                         rho_lo=0.0, rho_hi=3.0),
        nsteps=20_000, plot_int=100, t_window=1000, droplet_int=100,
        init="droplet", init_radius=0.2,
    ),
)
_register(
    "droplet-a2.5-eq",  # alpha0=2.5, rho_hi=2 (Parameters: kappa=0.1)
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=2.5, kBT=0.0, kappa=0.1,
                         rho_lo=0.0, rho_hi=2.0),
        nsteps=20_000, plot_int=100, t_window=1000, droplet_int=100,
        init="droplet", init_radius=0.25,
    ),
)
_register(
    "droplet-a4-eq",  # alpha0=4, rho_hi=1, kappa=1e-3 (Parameters Case I)
    RunConfig(
        shape=(32, 32, 32),
        params=LBMParams(alpha0=4.0, kBT=0.0, kappa=0.001,
                         rho_lo=0.0, rho_hi=1.0),
        nsteps=20_000, plot_int=100, t_window=1000, droplet_int=100,
        init="droplet", init_radius=0.5,
    ),
)
_register(
    "droplet-msd-eq",  # xdg_msd_calc.ipynb case: 64^3, alpha0=4, r=0.2
    RunConfig(
        shape=(64, 64, 64),
        params=LBMParams(alpha0=4.0, kBT=0.0, kappa=0.001,
                         rho_lo=0.0, rho_hi=1.0),
        nsteps=20_000, plot_int=0, init="droplet", init_radius=0.2,
    ),
)
_register(
    "droplet-msd-fluct",  # xdg_msd_calc.ipynb continue dir (xi=5e-5)
    RunConfig(
        shape=(64, 64, 64),
        params=LBMParams(alpha0=4.0, kBT=5e-5, kappa=0.001,
                         rho_lo=0.0, rho_hi=1.0),
        nsteps=1_000_000, step_continue=20_000, plot_int=100, droplet_int=100,
        init="checkpoint",
    ),
)
_register(
    "bench-256",  # driver north-star benchmark config (BASELINE.json)
    RunConfig(
        shape=(256, 256, 256),
        params=LBMParams(alpha0=0.0, kBT=1e-5),
        nsteps=100, init="mixture",
    ),
)


def preset(name: str) -> RunConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}"
        ) from None


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
