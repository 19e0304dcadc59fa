"""Population <-> moment transforms.

Reference: hand-unrolled ``moments()`` / ``populations()``
(``LBM_d3q19.H:100-156`` / ``:167-247``).  The jnp engine applies both as
one tensordot against the constant basis matrices from
:mod:`bflbm_tpu.lattice`; the GPU step kernel uses the hand-factored
per-cell schedules below (``_eof_*``), verified against the same
matrices at import.

All contractions run at Precision.HIGHEST: a float32 matmul may
otherwise run in TF32 on the GPU (about three decimal digits), which
makes the per-step moments->populations round trip lossy at the 1e-3
level - fatal for mass conservation and kBT~1e-5 fluctuation
statistics.  These are 19-wide contractions; full precision costs
little next to the memory traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

from ..lattice import M, M_INV, Q


def moments(f: jnp.ndarray) -> jnp.ndarray:
    """m_k = sum_i M[k,i] f_i over the leading population axis."""
    mat = jnp.asarray(M, dtype=f.dtype)
    return jnp.tensordot(mat, f, axes=([1], [0]),
                         precision=jax.lax.Precision.HIGHEST)


def populations(m: jnp.ndarray) -> jnp.ndarray:
    """f_i = sum_k M_INV[i,k] m_k over the leading moment axis."""
    mat = jnp.asarray(M_INV, dtype=m.dtype)
    return jnp.tensordot(mat, m, axes=([1], [0]),
                         precision=jax.lax.Precision.HIGHEST)


# Per-cell factored transforms for kernels.  c[2p+2] == -c[2p+1] in the
# reference ordering and every Duenweg/Schiller basis row is
# parity-definite under c -> -c, so moments split into an even sector
# (pair sums f_i + f_ibar) and an odd sector (pair differences).  Beyond
# that split the rows share whole pair-GROUP sums: the three
# diagonal-plane sums and the axis sum enter m0/m4/m5/m6/m16/m17/m18 as
# a unit, the odd groups (dp_a +- dp_b) serve both the momentum rows
# m1-m3 and the ghost rows m10-m15, and on the inverse side the six
# diagonal pairs differ only in the sign of ONE kinetic-moment term
# around three shared 7-term cores (H1/H2/H3 below).  Hand-scheduling
# those shared partials takes ~68 adds per species forward and ~114 back
# (against 19x19 = 361 multiply-adds each way).  The schedules hardcode
# the D3Q19 basis STRUCTURE; _verify_eof() checks the net matrices
# against M / M_INV at import.  Reference: the unrolled transforms
# LBM_d3q19.H:90-150 (same moments, each row computed independently).
_PAIRS = tuple((2 * p + 1, 2 * p + 2) for p in range(9))


def _eof_mom(pops):
    """Factored forward transform: 19 populations -> 19 moments."""
    sp = [pops[i] + pops[j] for i, j in _PAIRS]
    dp = [pops[i] - pops[j] for i, j in _PAIRS]
    f0 = pops[0]
    # shared even partials
    v12 = sp[1] + sp[2]
    s_ax = sp[0] + v12
    s_d1 = sp[3] + sp[4]
    s_d2 = sp[5] + sp[6]
    s_d3 = sp[7] + sp[8]
    s_di = (s_d1 + s_d2) + s_d3
    u = s_d1 + s_d3
    u2 = s_d1 - s_d3
    t1 = sp[0] + sp[0]
    q2 = s_d2 + s_d2
    w12 = sp[1] - sp[2]
    # shared odd partials
    a1 = dp[3] + dp[4]
    a2 = dp[3] - dp[4]
    b1 = dp[5] + dp[6]
    b2 = dp[5] - dp[6]
    c1 = dp[7] + dp[8]
    c2 = dp[7] - dp[8]
    ac = a1 + c1
    ab = a2 + b1
    bc = b2 + c2
    m = [None] * Q
    m[0] = f0 + (s_ax + s_di)
    m[1] = dp[0] + ac
    m[2] = dp[1] + ab
    m[3] = dp[2] + bc
    m[4] = s_di - f0
    m[5] = (t1 + u) - (v12 + q2)
    m[6] = w12 + u2
    m[7] = sp[3] - sp[4]
    m[8] = sp[5] - sp[6]
    m[9] = sp[7] - sp[8]
    m[10] = ac - (dp[0] + dp[0])
    m[11] = ab - (dp[1] + dp[1])
    m[12] = bc - (dp[2] + dp[2])
    m[13] = a1 - c1
    m[14] = b1 - a2
    m[15] = c2 - b2
    m[16] = f0 + (s_di - (s_ax + s_ax))
    m[17] = (u + v12) - (t1 + q2)
    m[18] = u2 - w12
    return m


def _eof_mom_c(pops):
    """Conserved rows of the factored forward transform: [m0, m1, m2, m3].

    Exact-relaxation fast path (tau = 1/2 -> lambda_bar = 1, the default
    of every reference recipe, LBM_binary.H:74-80): the MRT collision
    replaces ALL non-conserved moments by m_eq (+ forcing + noise), so
    the streamed state's stress/ghost moments are computed only to be
    discarded — the forward transform shrinks to the four conserved
    rows.  The expression trees are the _eof_mom ones verbatim, so the
    conserved moments stay bitwise equal to the full transform's.
    """
    sp = [pops[i] + pops[j] for i, j in _PAIRS]
    dp = [pops[i] - pops[j] for i, j in _PAIRS]
    f0 = pops[0]
    v12 = sp[1] + sp[2]
    s_ax = sp[0] + v12
    s_d1 = sp[3] + sp[4]
    s_d2 = sp[5] + sp[6]
    s_d3 = sp[7] + sp[8]
    s_di = (s_d1 + s_d2) + s_d3
    a1 = dp[3] + dp[4]
    a2 = dp[3] - dp[4]
    b1 = dp[5] + dp[6]
    b2 = dp[5] - dp[6]
    c1 = dp[7] + dp[8]
    c2 = dp[7] - dp[8]
    ac = a1 + c1
    ab = a2 + b1
    bc = b2 + c2
    return [f0 + (s_ax + s_di), dp[0] + ac, dp[1] + ab, dp[2] + bc]


def _eof_pops(mom):
    """Factored back transform: 19 moments -> 19 populations, rest
    population by exact-mass telescoping: out[0] = m0 - sum(out[1:]), so
    the stored mass is the mass moment up to one rounding (see the
    exact-mass note in ops/collide.py)."""
    # even parts (pair sums / 2)
    a = (mom[0] - mom[16]) * (1.0 / 18.0)
    b5 = mom[5] - mom[17]
    c6 = mom[6] - mom[18]
    s5 = mom[5] + mom[17]
    s6 = mom[6] + mom[18]
    tb = b5 * (1.0 / 24.0)
    tc = c6 * 0.125
    e34 = a - tb
    d = mom[0] * (1.0 / 36.0) + mom[4] * (1.0 / 24.0) \
        + mom[16] * (1.0 / 72.0)
    p5 = s5 * (1.0 / 48.0)
    p6 = s6 * 0.0625
    h1 = d + (p5 + p6)
    h2 = d - s5 * (1.0 / 24.0)
    h3 = d + (p5 - p6)
    x7 = mom[7] * 0.25
    x8 = mom[8] * 0.25
    x9 = mom[9] * 0.25
    ev = [a + b5 * (1.0 / 12.0), e34 + tc, e34 - tc,
          h1 + x7, h1 - x7, h2 + x8, h2 - x8, h3 + x9, h3 - x9]
    # odd parts (pair differences / 2)
    p1 = mom[1] * (1.0 / 12.0)
    p2 = mom[2] * (1.0 / 12.0)
    p3 = mom[3] * (1.0 / 12.0)
    q10 = mom[10] * (1.0 / 24.0)
    q11 = mom[11] * (1.0 / 24.0)
    q12 = mom[12] * (1.0 / 24.0)
    r13 = mom[13] * 0.125
    r14 = mom[14] * 0.125
    r15 = mom[15] * 0.125
    od = [(mom[1] - mom[10]) * (1.0 / 6.0),
          (mom[2] - mom[11]) * (1.0 / 6.0),
          (mom[3] - mom[12]) * (1.0 / 6.0),
          (p1 + p2) + (q10 + q11) + (r13 - r14),
          (p1 - p2) + (q10 - q11) + (r13 + r14),
          (p2 + p3) + (q11 + q12) + (r14 - r15),
          (p2 - p3) + (q11 - q12) + (r14 + r15),
          (p1 + p3) + (q10 + q12) + (r15 - r13),
          (p1 - p3) + (q10 - q12) - (r13 + r15)]
    out = [None] * Q
    for p, (i, j) in enumerate(_PAIRS):
        out[i] = ev[p] + od[p]
        out[j] = ev[p] - od[p]
    s = None
    for i, j in _PAIRS:
        ps = out[i] + out[j]
        s = ps if s is None else s + ps
    out[0] = mom[0] - s
    return out


def _eof_pops_c10(mom):
    """:func:`_eof_pops` specialized to ghost moments 10..18 == 0.

    This is the deterministic exact-relaxation (tau = 1/2) case: the
    post-collide moment vector is m_eq (+ Guo forcing), whose ghost rows
    vanish identically (LBM_binary.H:381-399 zero them), so all q/r
    partials of the inverse drop out.  Rest population by the same
    exact-mass telescoping.
    """
    a = mom[0] * (1.0 / 18.0)
    tb = mom[5] * (1.0 / 24.0)
    tc = mom[6] * 0.125
    e34 = a - tb
    d = mom[0] * (1.0 / 36.0) + mom[4] * (1.0 / 24.0)
    p5 = mom[5] * (1.0 / 48.0)
    p6 = mom[6] * 0.0625
    h1 = d + (p5 + p6)
    h2 = d - mom[5] * (1.0 / 24.0)
    h3 = d + (p5 - p6)
    x7 = mom[7] * 0.25
    x8 = mom[8] * 0.25
    x9 = mom[9] * 0.25
    ev = [a + mom[5] * (1.0 / 12.0), e34 + tc, e34 - tc,
          h1 + x7, h1 - x7, h2 + x8, h2 - x8, h3 + x9, h3 - x9]
    p1 = mom[1] * (1.0 / 12.0)
    p2 = mom[2] * (1.0 / 12.0)
    p3 = mom[3] * (1.0 / 12.0)
    od = [mom[1] * (1.0 / 6.0), mom[2] * (1.0 / 6.0),
          mom[3] * (1.0 / 6.0),
          p1 + p2, p1 - p2, p2 + p3, p2 - p3, p1 + p3, p1 - p3]
    out = [None] * Q
    for p, (i, j) in enumerate(_PAIRS):
        out[i] = ev[p] + od[p]
        out[j] = ev[p] - od[p]
    s = None
    for i, j in _PAIRS:
        ps = out[i] + out[j]
        s = ps if s is None else s + ps
    out[0] = mom[0] - s
    return out


def _verify_eof():
    """Identity-matrix check of the factored schedules vs M / M_INV."""
    eye = [np.eye(Q)[k] for k in range(Q)]
    mf = np.stack(_eof_mom(eye))          # row k = moment k of basis pops
    if not np.allclose(mf, M, rtol=0.0, atol=1e-13):
        return False
    pf = np.stack(_eof_pops(eye))
    if not np.allclose(pf, M_INV, rtol=0.0, atol=1e-13):
        return False
    mc = np.stack(_eof_mom_c(eye))        # conserved rows only
    if not np.allclose(mc, M[:4], rtol=0.0, atol=1e-13):
        return False
    eye10 = [np.eye(10)[k] for k in range(10)]
    pc = np.stack(_eof_pops_c10(eye10))   # columns 0..9 of M_INV
    return bool(np.allclose(pc, M_INV[:, :10], rtol=0.0, atol=1e-13))


if not _verify_eof():
    raise AssertionError("factored transforms disagree with M / M_INV")
