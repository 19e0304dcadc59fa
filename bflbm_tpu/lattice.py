"""D3Q19 lattice model for the fluctuating binary LBM.

The reference implementation (``LBM_d3q19.H``) hard-codes the moment
transform (``moments()``, ``LBM_d3q19.H:100-156``) and its inverse
(``populations()``, ``LBM_d3q19.H:167-247``) as hand-unrolled adds in the
Duenweg/Schiller orthogonal basis ("Lattice Boltzmann simulations of soft
matter systems", Duenweg & Ladd).  Here we instead *construct* the basis
from its defining polynomials in the lattice velocities and obtain the
transform matrices ``M`` (moments = M @ f) and ``M_INV`` (f = M_INV @ m)
from the discrete orthogonality relation

    sum_i w_i e_k(c_i) e_l(c_i) = b_k delta_kl,
    M[k, i]    = e_k(c_i),
    M_INV[i, k] = w_i e_k(c_i) / b_k.

This reproduces the reference transforms exactly (the mode norms ``b_k``
match the table at ``LBM_d3q19.H:56-76``; validated in
``tests/test_lattice.py``) as a pair of 19x19 matrices applied over the
population axis.

Velocity ordering follows the reference (``LBM_d3q19.H:12-32``):
rest; +-x, +-y, +-z faces; xy, yz, xz edge diagonals.  Keeping the same
ordering makes cross-validation against reference data trivial; nothing
physical depends on it.
"""

from __future__ import annotations

import numpy as np

Q = 19  # number of discrete velocities (nvel, LBM_d3q19.H:4)
CS2 = 1.0 / 3.0  # lattice speed of sound squared (LBM_d3q19.H:6)
CS4 = CS2 * CS2

# Discrete velocity set, order matching LBM_d3q19.H:12-32.
C = np.array(
    [
        [0, 0, 0],
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
        [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
        [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
        [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
    ],
    dtype=np.int64,
)

# Quadrature weights: 1/3 rest, 1/18 faces, 1/36 edges (LBM_d3q19.H:34-54).
W = np.where(
    (C == 0).all(axis=1),
    1.0 / 3.0,
    np.where(np.abs(C).sum(axis=1) == 1, 1.0 / 18.0, 1.0 / 36.0),
).astype(np.float64)


def _basis_polynomials() -> np.ndarray:
    """Evaluate the 19 Duenweg/Schiller basis polynomials on the velocity set.

    Returns the moment matrix ``M`` with ``M[k, i] = e_k(c_i)``.

    k =  0      : 1                      (mass)
    k =  1..3   : c_x, c_y, c_z          (momentum)
    k =  4      : c^2 - 1                (bulk stress)
    k =  5      : 3 c_x^2 - c^2          (shear stress, diagonal)
    k =  6      : c_y^2 - c_z^2
    k =  7..9   : c_x c_y, c_y c_z, c_x c_z
    k = 10..12  : (3 c^2 - 5) c_{x,y,z}  (ghost: third-order)
    k = 13      : (c_y^2 - c_z^2) c_x
    k = 14      : (c_z^2 - c_x^2) c_y
    k = 15      : (c_x^2 - c_y^2) c_z
    k = 16      : 3 c^4 - 6 c^2 + 1      (ghost: fourth-order)
    k = 17      : (2 c^2 - 3)(3 c_x^2 - c^2)
    k = 18      : (2 c^2 - 3)(c_y^2 - c_z^2)
    """
    cx, cy, cz = (C[:, 0].astype(np.float64), C[:, 1].astype(np.float64),
                  C[:, 2].astype(np.float64))
    c2 = cx * cx + cy * cy + cz * cz
    rows = [
        np.ones(Q),
        cx, cy, cz,
        c2 - 1.0,
        3.0 * cx * cx - c2,
        cy * cy - cz * cz,
        cx * cy, cy * cz, cx * cz,
        (3.0 * c2 - 5.0) * cx,
        (3.0 * c2 - 5.0) * cy,
        (3.0 * c2 - 5.0) * cz,
        (cy * cy - cz * cz) * cx,
        (cz * cz - cx * cx) * cy,
        (cx * cx - cy * cy) * cz,
        3.0 * c2 * c2 - 6.0 * c2 + 1.0,
        (2.0 * c2 - 3.0) * (3.0 * cx * cx - c2),
        (2.0 * c2 - 3.0) * (cy * cy - cz * cz),
    ]
    return np.stack(rows, axis=0)


# Moment matrix and its inverse via weighted orthogonality.
M = _basis_polynomials()
# Mode norms b_k = sum_i w_i e_k(c_i)^2; must equal LBM_d3q19.H:56-76.
B = np.einsum("i,ki,ki->k", W, M, M)
M_INV = (W[:, None] * M.T) / B[None, :]

# Reference table of mode norms (LBM_d3q19.H:56-76) — kept ONLY as a
# cross-check fixture for tests; the live values are derived above.
B_REFERENCE = np.array(
    [1.0, 1 / 3, 1 / 3, 1 / 3, 2 / 3, 4 / 3, 4 / 9, 1 / 9, 1 / 9, 1 / 9,
     2 / 3, 2 / 3, 2 / 3, 2 / 9, 2 / 9, 2 / 9, 2.0, 4 / 3, 4 / 9],
    dtype=np.float64,
)

# Index groups handy elsewhere.
MOMENTUM_MODES = (1, 2, 3)      # conserved momentum modes
STRESS_MODES = tuple(range(4, 10))
GHOST_MODES = tuple(range(10, 19))


def _tensor_weights() -> np.ndarray:
    """Second-order tensor weights ``wg[i][a][b]`` (LBM_d3q19.H:78-98).

    The reference declares this table but never references it from any
    kernel (SURVEY §2.1); it is provided here as a constructed constant
    for completeness.  Rather than transcribing the 19x3x3 table, we
    build it from its moment-space content: expanding the reference
    values in the orthogonal basis (wg_i^{ab} = sum_k G_k^{ab} M_INV[i,k])
    shows exactly nine non-zero rows with simple rational coefficients —

        G_0  = -I/6                 G_16 = +I/3          (isotropic part)
        G_5  = diag(2,-1,-1)/3      G_17 = -2 G_5
        G_6  = diag(0, 1,-1)/3      G_18 = -2 G_6        (diagonal shear)
        G_7  = (xy+yx)/3,  G_8 = (yz+zy)/3,  G_9 = (xz+zx)/3

    i.e. the traceless stress projectors plus their fourth-order ghost
    partners (e17 = (2c^2-3) e5, e18 = (2c^2-3) e6) with coefficient -2,
    and an isotropic -e0/6 + e16/3 pair.  Equality with the reference's
    literal table is pinned in ``tests/test_lattice.py``.
    """
    G = np.zeros((Q, 3, 3))
    eye = np.eye(3)
    G[0] = -eye / 6.0
    G[16] = eye / 3.0
    G[5] = np.diag([2.0, -1.0, -1.0]) / 3.0
    G[6] = np.diag([0.0, 1.0, -1.0]) / 3.0
    G[17] = -2.0 * G[5]
    G[18] = -2.0 * G[6]
    for k, (a, b) in ((7, (0, 1)), (8, (1, 2)), (9, (0, 2))):
        G[k, a, b] = G[k, b, a] = 1.0 / 3.0
    return np.einsum("ik,kab->iab", M_INV, G)


WG = _tensor_weights()

# Pressure-tensor extraction: P_ab = sum_i f_i c_ia c_ib expressed in
# moment space, P_ab = sum_k PT[k,a,b] m_k (used by the hydrovars(m)
# stress diagnostic, LBM_d3q19.H:258-286).
PTENS = np.einsum("ik,ia,ib->kab", M_INV, C.astype(np.float64),
                  C.astype(np.float64))


def sanity() -> None:
    """Raise if the constructed basis is inconsistent (import-time cheap)."""
    assert np.allclose(B, B_REFERENCE), "mode norms disagree with D3Q19 table"
    assert np.allclose(M @ M_INV, np.eye(Q), atol=1e-14)
    assert np.allclose(W.sum(), 1.0)
    assert np.allclose(np.einsum("i,id->d", W, C.astype(np.float64)), 0.0)
    # second moment isotropy: sum_i w_i c_ia c_ib = cs2 delta_ab
    assert np.allclose(
        np.einsum("i,ia,ib->ab", W, C.astype(float), C.astype(float)),
        CS2 * np.eye(3), atol=1e-15,
    )


sanity()
