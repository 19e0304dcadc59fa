"""Isotropic 19-point lattice stencils (gradient / laplacian / grad-laplacian).

Reference: ``LBM_binary.H:134-194``.  The reference evaluates these as
per-cell neighbor loops over ghost cells filled by ``FillBoundary``; here
they are compositions of periodic ``jnp.roll`` shifts, which XLA fuses
into shifted reads on a single device and lowers to collective permutes
across a sharded mesh - no explicit halo plumbing needed on the jnp
path.

All stencils optionally pass the field through the Shan-Chen
pseudopotential psi(n) = n0 (1 - exp(-n/n0)) first (``use_sc_pseudo``,
LBM_binary.H:141,156,184).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..lattice import C, CS2, W

# +- direction pairs (i, j) with c_j = -c_i, skipping the rest velocity.
_PAIRS: Tuple[Tuple[int, int], ...] = tuple(
    (i, int(np.argwhere((C == -C[i]).all(axis=1))[0, 0]))
    for i in range(1, 19)
    if C[i][np.argmax(C[i] != 0)] > 0  # first nonzero component positive
)
assert len(_PAIRS) == 9


def shift(field: jnp.ndarray, cvec, axes=(-3, -2, -1)) -> jnp.ndarray:
    """Return field evaluated at x + cvec (periodic)."""
    sh = [int(-c) for c in cvec]
    ax = [a for a, s in zip(axes, sh) if s != 0]
    sh = [s for s in sh if s != 0]
    if not sh:
        return field
    return jnp.roll(field, sh, ax)


def pseudopotential(field: jnp.ndarray, use_sc: bool, ref_density: float):
    """Shan-Chen pseudopotential transform (LBM_binary.H:141)."""
    if not use_sc:
        return field
    return ref_density * (1.0 - jnp.exp(-field / ref_density))


def gradient(field: jnp.ndarray, use_sc: bool = False,
             ref_density: float = 1.0, axes=(-3, -2, -1)) -> jnp.ndarray:
    """19-point isotropic gradient; returns shape (3, *field.shape).

    grad_d psi(x) = (1/cs^2) sum_i w_i psi(x + c_i) c_{i,d}
    (LBM_binary.H:134-150).  Implemented as 9 antisymmetric +-pair
    differences (the rest velocity and the symmetric part drop out).
    """
    psi = pseudopotential(field, use_sc, ref_density)
    out = [jnp.zeros_like(field) for _ in range(3)]
    for i, j in _PAIRS:
        diff = shift(psi, C[i], axes) - shift(psi, C[j], axes)
        coeff = float(W[i] / CS2)
        for d in range(3):
            if C[i, d] != 0:
                out[d] = out[d] + (coeff * float(C[i, d])) * diff
    return jnp.stack(out)


def laplacian(field: jnp.ndarray, use_sc: bool = False,
              ref_density: float = 1.0, axes=(-3, -2, -1)) -> jnp.ndarray:
    """19-point lattice laplacian (LBM_binary.H:152-168).

    lap psi(x) = (2/cs^2) sum_i w_i (psi(x + c_i) - psi(x)).
    """
    psi = pseudopotential(field, use_sc, ref_density)
    acc = jnp.zeros_like(field)
    wsum = 0.0
    for i, j in _PAIRS:
        acc = acc + float(W[i]) * (shift(psi, C[i], axes) + shift(psi, C[j], axes))
        wsum += float(2.0 * W[i])
    return (2.0 / CS2) * (acc - wsum * psi)


def grad_laplacian(field: jnp.ndarray, use_sc: bool = False,
                   ref_density: float = 1.0, axes=(-3, -2, -1)) -> jnp.ndarray:
    """Gradient of the laplacian, the reference's 361-neighbor double stencil
    (``grad_laplacian_2nd``, LBM_binary.H:170-194), expressed as the
    composition gradient(laplacian(psi)) which is algebraically identical:

        sum_j w_j c_{j,d} [ sum_i w_i (psi(x+c_j+c_i) - psi(x+c_j)) ] * 2/cs^4

    The reference evaluates this even though its output feeds only the
    disabled ``alpha1`` term (LBM_binary.H:256-257); here callers gate it
    behind ``alpha1 != 0`` (see SURVEY.md §2.2).

    Note the pseudopotential transform applies to the *innermost* field
    only, matching the reference; we therefore pre-transform once and run
    both stencils in raw-field mode.
    """
    psi = pseudopotential(field, use_sc, ref_density)
    return gradient(laplacian(psi, False, ref_density, axes), False,
                    ref_density, axes)
