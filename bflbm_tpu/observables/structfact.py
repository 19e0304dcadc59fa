"""Online pair structure factors S_AB(k) on device.

Replaces the FHDeX ``StructFact`` class + gather-to-rank-0 FFTW pipeline
(usage main_run_job.cpp:299-311, 342-349; AMReX_DFT.H:19-132) with a
running sum of DFT cross-spectra computed directly on the (sharded) field
stack — no gather, trivially SPMD.  The DFT is the split re/im matmul
transform of :mod:`bflbm_tpu.ops.rfft` (see that module's docstring).

Conventions match the notebooks' recompute recipe (Debug.ipynb cells 5-8):
unitary 1/sqrt(N) FFT normalization, optional k=0 zeroing (the reference's
``zero_avg=1``, main_run_job.cpp:50-54), fftshift on readout.

The reference's 22 selected pairs (main_run_job.cpp:301-309) over the
22-component hydro schema are provided as :data:`REFERENCE_PAIRS`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rfft
from ..ops.hydro import HYDRO_NAMES

# pairA/pairB of main_run_job.cpp:301-309, indices into HYDRO_NAMES:
# auto-correlations of rho, phi, uf, ug, ub components; cross terms
# rho-phi, ufx-ugx, afx-afx, ub cross-correlations, and the
# noise/bare-velocity combinations used by Mixture.ipynb cell 1.
REFERENCE_PAIRS: Tuple[Tuple[int, int], ...] = (
    (0, 0), (1, 1), (0, 1), (2, 2), (3, 3), (4, 4), (6, 6), (7, 7), (8, 8),
    (2, 6), (9, 9), (15, 15), (16, 16), (17, 17), (15, 16), (18, 18),
    (19, 19), (20, 20), (21, 21), (20, 21), (20, 18), (21, 18),
)


def pair_names(pairs=REFERENCE_PAIRS, names=HYDRO_NAMES):
    return tuple(f"{names[a]}*{names[b]}" for a, b in pairs)


class StructFactState(NamedTuple):
    """Running sums of Re/Im of A_hat(k) conj(B_hat(k)) per pair."""

    accum_re: jax.Array   # (npairs, X, Y, Z)
    accum_im: jax.Array   # (npairs, X, Y, Z)
    count: jax.Array      # int32 scalar


def init_structfact(npairs: int, shape, dtype=jnp.float32) -> StructFactState:
    z = jnp.zeros((npairs,) + tuple(shape), dtype)
    return StructFactState(accum_re=z, accum_im=z,
                           count=jnp.zeros((), jnp.int32))


def accumulate(sf: StructFactState, fields: jnp.ndarray,
               pairs: Sequence[Tuple[int, int]] = REFERENCE_PAIRS
               ) -> StructFactState:
    """Add one frame.  fields: (C, X, Y, Z) packed component stack."""
    n = float(np.prod(fields.shape[1:]))
    used = sorted({i for ab in pairs for i in ab})
    idx = {c: i for i, c in enumerate(used)}
    sub = fields[jnp.asarray(used)].astype(sf.accum_re.dtype)
    re, im = rfft.fft3(sub)
    scale = 1.0 / n  # (1/sqrt(N))^2 applied to the product
    # A * conj(B) = (ar br + ai bi) + i (ai br - ar bi)
    prod_re = jnp.stack([
        (re[idx[a]] * re[idx[b]] + im[idx[a]] * im[idx[b]]) * scale
        for a, b in pairs
    ])
    prod_im = jnp.stack([
        (im[idx[a]] * re[idx[b]] - re[idx[a]] * im[idx[b]]) * scale
        for a, b in pairs
    ])
    return StructFactState(
        accum_re=sf.accum_re + prod_re,
        accum_im=sf.accum_im + prod_im,
        count=sf.count + 1,
    )


def finalize(sf: StructFactState, zero_avg: bool = True,
             shift: bool = True) -> np.ndarray:
    """Mean cross-spectra as a complex numpy array; optionally zero k=0 and
    fftshift (reference WritePlotFile semantics, zero_avg=1)."""
    cnt = max(int(sf.count), 1)
    s = np.asarray(sf.accum_re) / cnt + 1j * (np.asarray(sf.accum_im) / cnt)
    if zero_avg:
        s[:, 0, 0, 0] = 0.0
    if shift:
        s = np.fft.fftshift(s, axes=(-3, -2, -1))
    return s


# ---------------------------------------------------------------------------
# Direct (offline) spectra — the Debug.ipynb cells 5-8 recipe, for tests
# and analysis scripts.
# ---------------------------------------------------------------------------

def spectrum(field: jnp.ndarray, remove_mean: bool = True) -> jnp.ndarray:
    """|F[field]|^2 with unitary normalization; field (X,Y,Z) real."""
    return rfft.power_spectrum(field, remove_mean=remove_mean)


def radial_average(sk: np.ndarray, nbins: int = 0):
    """Spherically averaged S(|k|); returns (k_centers, S_mean).

    Uses integer-frequency radii |k_idx| with k=0 excluded (matching the
    notebooks' flat-S(k) equilibrium checks).  Input must be UNshifted
    (k=0 at index 0).
    """
    sk = np.asarray(sk)
    kmag = rfft.fftfreq_grid(sk.shape).ravel()
    vals = sk.ravel()
    mask = kmag > 0
    kmag, vals = kmag[mask], vals[mask]
    nbins = nbins or int(kmag.max())
    edges = np.linspace(0, kmag.max(), nbins + 1)
    which = np.digitize(kmag, edges) - 1
    k_out, s_out = [], []
    for b in range(nbins):
        sel = which == b
        if sel.any():
            k_out.append(kmag[sel].mean())
            s_out.append(vals[sel].mean())
    return np.asarray(k_out), np.asarray(s_out)
