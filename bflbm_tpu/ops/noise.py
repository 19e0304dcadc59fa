"""Fluctuation-dissipation thermal noise for the binary FLBM.

Reference: ``thermal_noise`` (``LBM_binary.H:73-132``), Adhikari-style
per-relaxation-mode noise:

* mass mode (a=0): zero (LBM_binary.H:113-114);
* momentum modes (a=1..3): amplitude
  sqrt(2 (lam - lam^2/2) kBT |rho phi / rho_t|) with the g-species draw
  anti-correlated, xi_g = -xi_f (diffusive momentum exchange noise,
  LBM_binary.H:117-118);
* stress + ghost modes (a=4..18): amplitude
  sqrt(2 (lam - lam^2/2) kBT / cs^2 * b_a * |rho|), independent per
  species (LBM_binary.H:125-126);

with lam = 1/(tau + 1/2).  The reference also hard-wires
``tau_g_bar = tau_f_bar`` (LBM_binary.H:80); we use the per-species lam
(identical for the default tau_f = tau_g = 1/2 and strictly more general
otherwise).

The reference draws from per-thread sequential RNG engines
(``ParallelForRNG``), making results decomposition-dependent.  Here draws
are counter-based (threefry key folded with the step index), so the noise
field is bitwise reproducible for any device mesh.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LBMParams
from ..lattice import B, CS2, Q


def _roll3(field: jnp.ndarray, shift):
    """Periodic translation by an integer 3-vector (COM-frame shift:
    cell x samples the reference state at x - shift, matching the
    reference's shifted-coordinate lookup)."""
    out = field
    for d in range(3):
        out = jnp.roll(out, shift[d], axis=d)
    return out


def noise_amplitudes(rho, phi, params: LBMParams, dtype=None):
    """Per-mode noise std-devs; returns (amp_mom, amp_ghost_f, amp_ghost_g).

    amp_mom: (X,Y,Z) shared momentum-mode amplitude.
    amp_ghost_*: (15, X, Y, Z) for modes a=4..18.
    """
    dtype = dtype or rho.dtype
    lam_f = params.lam_f
    lam_g = params.lam_g
    pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * params.kBT
    pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * params.kBT
    rhot = rho + phi
    reduced = jnp.where(jnp.abs(rhot) > params.div_eps, rho * phi / rhot, 0.0)
    amp_mom = jnp.sqrt(jnp.asarray(pref_f, dtype) * jnp.abs(reduced))
    b_ghost = jnp.asarray(B[4:], dtype).reshape((Q - 4,) + (1,) * rho.ndim)
    amp_gf = jnp.sqrt((pref_f / CS2) * b_ghost * jnp.abs(rho)[None])
    amp_gg = jnp.sqrt((pref_g / CS2) * b_ghost * jnp.abs(phi)[None])
    return amp_mom, amp_gf, amp_gg


def _amplitude_fields(rho, phi, params: LBMParams, dtype, ref_state):
    """The (rho, phi) pair the amplitudes are evaluated at: the live
    densities, or — USE_REF_STATE (LBM_binary.H:92-106) — a stored
    equilibrium state translated by the integer COM displacement."""
    if ref_state is None:
        return rho, phi
    rho_eq, phi_eq, com_shift = ref_state
    shift = jnp.round(com_shift).astype(jnp.int32)
    return (_roll3(jnp.asarray(rho_eq, dtype), shift),
            _roll3(jnp.asarray(phi_eq, dtype), shift))


def _apply_amplitudes(n: jnp.ndarray, rho, phi, params: LBMParams,
                      dtype) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(33, X, Y, Z) standard normals -> per-mode noise moments.

    Channel order (the hash stream's draw order, :func:`hash_channels`):
    0-2 momentum (shared, g anti-correlated), 3-17 f ghost modes a=4..18,
    18-32 g ghost modes.
    """
    shape = rho.shape
    amp_mom, amp_gf, amp_gg = noise_amplitudes(rho, phi, params, dtype)
    n_mom, n_gf, n_gg = n[:3], n[3:18], n[18:33]
    zero = jnp.zeros((1,) + shape, dtype)
    xi_mom = amp_mom[None] * n_mom
    xi_f = jnp.concatenate([zero, xi_mom, amp_gf * n_gf])
    xi_g = jnp.concatenate([zero, -xi_mom, amp_gg * n_gg])
    return xi_f, xi_g


def thermal_noise(key: jax.Array, rho: jnp.ndarray, phi: jnp.ndarray,
                  params: LBMParams,
                  ref_state=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Draw per-mode noise moments (xi_f, xi_g), each shape (19, X, Y, Z).

    ref_state: optional (rho_eq, phi_eq, com_shift) — the reference's
    ``USE_REF_STATE`` path (LBM_binary.H:92-106): amplitudes evaluated at
    a stored equilibrium state translated by the integer center-of-mass
    displacement instead of the instantaneous densities.
    """
    shape = rho.shape
    dtype = rho.dtype
    if not params.noise_on:
        z = jnp.zeros((Q,) + shape, dtype)
        return z, z
    rho, phi = _amplitude_fields(rho, phi, params, dtype, ref_state)
    # One fused draw: 3 momentum + 15 f-ghost + 15 g-ghost normals.
    n = jax.random.normal(key, (N_NORMALS,) + shape, dtype)
    return _apply_amplitudes(n, rho, phi, params, dtype)


# ---------------------------------------------------------------------------
# Coordinate-keyed counter RNG (the reference's RANDRAW
# ``draw_from_pdf_normal`` analog, LBM_binary.H:42-63).
#
# normal draw = f(word, step, global cell index, draw index): the same
# value comes out wherever and in whatever block a cell is computed, so
# the GPU step kernel (kernels/triton_step.py) and the jnp engine consume
# bitwise the same stream.  Two rounds of the `lowbias32` integer
# finalizer (full-avalanche bijective mixer) keyed as
#
#     h1 = mix(cell ^ word)                     (once per cell)
#     h2 = mix(h1 + (step*64 + draw) * GOLDEN)  (per draw)
#
# ~10 integer ops per draw.  The per-draw counters are scalars
# (:func:`hash_counters`), so a kernel receives them precomputed and runs
# only the per-cell part (:func:`hash_channels`).
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B9
# draw-counter stride per step (>= 34 draws, a power of two so
# `step << 6 | draw` is injective for step < 2^25)
_DRAW_STRIDE = 64
N_NORMALS = 33           # 3 momentum + 15 ghost(f) + 15 ghost(g)
_NPAIR = (N_NORMALS + 1) // 2
# words each generator consumes for its 2 * _NPAIR draws
HASH_WORDS = {"clt4": 2 * _NPAIR, "clt2": _NPAIR,
              "u8": (2 * _NPAIR + 3) // 4, "bm": 2 * _NPAIR}


def _u32(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _mix32(x):
    """lowbias32 finalizer (Wellons): bijective, full-avalanche."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_counters(word, step, ndraws: int) -> jnp.ndarray:
    """uint32 (1 + ndraws,): the per-call key ``word`` followed by the
    per-draw counters ``(step*64 + a) * GOLDEN`` (int32 wrap-around)."""
    gold = jnp.int32(np.int32(np.uint32(_GOLDEN)))
    a = jnp.arange(ndraws, dtype=jnp.int32)
    cnt = (jnp.asarray(step, jnp.int32) * jnp.int32(_DRAW_STRIDE) + a) * gold
    return _u32(jnp.concatenate([jnp.asarray(word, jnp.int32)[None], cnt]))


def cell_index(gx, gy, gz, domain) -> jnp.ndarray:
    """int32 row-major global cell index of (gx, gy, gz) in `domain`."""
    _, Y, Z = domain
    return (gx * Y + gy) * Z + gz


def hash_channels(cell, keys, dtype, dist: str = "clt4"):
    """2 * _NPAIR standard-normal draws at int32 `cell` indices, in
    noise-channel order (the first N_NORMALS are consumed).

    keys: indexable of uint32 scalars, ``hash_counters(word, step, n)``
    with n = HASH_WORDS[dist].  dist: "clt4" (byte-sum, default), "clt2"
    (byte-pair halves, 2 normals/word), "u8" (single-byte uniform
    deviates, 4/word - cheapest) or "bm" (Box-Muller, exact Gaussian).
    Plain jnp/lax arithmetic, so the same code runs in jnp and inside a
    Pallas kernel."""
    h1 = _mix32(_u32(cell) ^ keys[0])
    ws = [_mix32(h1 + keys[1 + a]) for a in range(HASH_WORDS[dist])]
    if dist == "clt4":
        return [_clt4_normal(w, dtype) for w in ws]
    if dist == "clt2":
        return [v for w in ws for v in _clt2_pair(w, dtype)]
    if dist == "u8":
        return [d for w in ws for d in _u8_quad(w, dtype)][:2 * _NPAIR]
    if dist == "bm":
        us = [_unit_uniform(w, dtype) for w in ws]
        out = []
        for p in range(_NPAIR):
            r = jnp.sqrt(-2.0 * jnp.log(us[2 * p]))
            th = 6.283185307179586 * us[2 * p + 1]
            out += [r * jnp.cos(th), r * jnp.sin(th)]
        return out
    raise ValueError(f"unknown noise_dist {dist!r}")


def _region_cells(origin, region, domain):
    """Global cell indices of `region` placed at `origin` (x, y may be
    negative down to -X/-Y and wrap periodically; z is whole)."""
    X, Y, _ = domain
    ox, oy = origin
    ix = jax.lax.broadcasted_iota(jnp.int32, region, 0) + (ox + X)
    iy = jax.lax.broadcasted_iota(jnp.int32, region, 1) + (oy + Y)
    iz = jax.lax.broadcasted_iota(jnp.int32, region, 2)
    return cell_index(jax.lax.rem(ix, jnp.int32(X)),
                      jax.lax.rem(iy, jnp.int32(Y)), iz, domain)


def hash_normals(word, step, origin, region, domain, dtype,
                 dist: str = "clt4"):
    """(n1, n2): the even and odd noise channels (_NPAIR each) of the
    coordinate-keyed stream on `region` at `origin` in `domain`."""
    keys = hash_counters(word, step, HASH_WORDS[dist])
    n = hash_channels(_region_cells(origin, region, domain), keys, dtype,
                      dist)
    return n[0::2], n[1::2]


def _unit_uniform(w, dtype):
    """uint32 word -> U(0,1) from its top 24 bits, strictly inside."""
    i24 = jax.lax.bitcast_convert_type(w >> 8, jnp.int32)
    return i24.astype(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


# CLT-4 byte-sum normal: one uint32 word -> sum of its 4 bytes (four
# i.i.d. discrete uniforms on 0..255), standardized.  Exact mean and
# variance, symmetric, excess kurtosis -0.3, support +-3.45 sigma -
# statistically equivalent to a Gaussian for every fluctuation
# observable this framework validates (noise covariance, equilibrium
# S(k), capillary spectrum and MSD are second-moment statistics;
# higher-cumulant corrections enter at O(kBT^2)).  Precedent: Ladd's
# original FLBM used variance-matched uniform noise (J. Fluid Mech.
# 271, 1994).  One int->float convert + ~10 integer ops per normal, no
# transcendentals.
_CLT4_VAR = 4.0 * (65536.0 - 1.0) / 12.0    # var of the 0..1020 byte sum
_CLT4_SCALE = float(1.0 / np.sqrt(_CLT4_VAR))
_CLT4_OFF = float(-510.0 / np.sqrt(_CLT4_VAR))


def _clt4_normal(w, dtype):
    """uint32 word -> standardized byte-sum normal (see above).

    SWAR pairwise sum: bytes 0+1 and 2+3 land in the two 16-bit halves
    of one add (no overflow: 510 < 2^16), then the halves fold."""
    t = (w & jnp.uint32(0x00FF00FF)) + ((w >> 8) & jnp.uint32(0x00FF00FF))
    s = (t & jnp.uint32(0xFFFF)) + (t >> 16)
    i = jax.lax.bitcast_convert_type(s, jnp.int32)
    return i.astype(dtype) * _CLT4_SCALE + _CLT4_OFF


# CLT-2 byte-pair normal: each 16-bit half of one uint32 word -> sum of
# its 2 bytes, standardized - TWO normals per word.  Exact mean and
# variance like CLT-4, heavier truncation: support +-2.44 sigma, excess
# kurtosis -0.6 (inside Ladd's uniform-noise precedent at -1.2).
_CLT2_VAR = 2.0 * (65536.0 - 1.0) / 12.0    # var of a 0..510 byte-pair sum
_CLT2_SCALE = float(1.0 / np.sqrt(_CLT2_VAR))
_CLT2_OFF = float(-255.0 / np.sqrt(_CLT2_VAR))


def _clt2_pair(w, dtype):
    """uint32 word -> (n_lo, n_hi) standardized byte-pair normals.  The
    halves of one mixed word are independent to the same degree
    consecutive words are (the mixer avalanches all bits)."""
    t = (w & jnp.uint32(0x00FF00FF)) + ((w >> 8) & jnp.uint32(0x00FF00FF))
    lo = jax.lax.bitcast_convert_type(t & jnp.uint32(0xFFFF), jnp.int32)
    hi = jax.lax.bitcast_convert_type(t >> 16, jnp.int32)
    return (lo.astype(dtype) * _CLT2_SCALE + _CLT2_OFF,
            hi.astype(dtype) * _CLT2_SCALE + _CLT2_OFF)


# u8 single-byte uniform "normal": each byte of a word, standardized -
# FOUR variance-matched draws per word.  This is Ladd's original FLBM
# noise (variance-matched UNIFORM deviates, J. Fluid Mech. 271, 1994):
# support +-1.73 sigma, excess kurtosis -1.2, exact mean and variance.
_U8_VAR = (65536.0 - 1.0) / 12.0          # var of a uniform 0..255 byte
_U8_SCALE = float(1.0 / np.sqrt(_U8_VAR))
_U8_OFF = float(-127.5 / np.sqrt(_U8_VAR))


def _u8_quad(w, dtype):
    """uint32 word -> 4 standardized byte-uniform draws (see above)."""
    out = []
    for sh in (0, 8, 16, 24):
        b = jax.lax.bitcast_convert_type(
            (w >> sh) & jnp.uint32(0xFF), jnp.int32)
        out.append(b.astype(dtype) * _U8_SCALE + _U8_OFF)
    return out


def hash_normal_stack(word, step, shape, dtype,
                      dist: str = "clt4") -> jnp.ndarray:
    """(33, X, Y, Z) standard normals of the coordinate-keyed stream, in
    noise-channel order: a pure function of (word, step, global cell), so
    a jnp run and a kernel run with the same (word, step) sequence draw
    bitwise the same noise, on any device mesh."""
    keys = hash_counters(word, step, HASH_WORDS[dist])
    cells = _region_cells((jnp.int32(0), jnp.int32(0)), tuple(shape),
                          tuple(shape))
    return jnp.stack(hash_channels(cells, keys, dtype, dist)[:N_NORMALS])


def thermal_noise_hash(word, step, rho: jnp.ndarray, phi: jnp.ndarray,
                       params: LBMParams, ref_state=None,
                       dist: str = "clt4") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`thermal_noise` with the coordinate-keyed hash stream
    (see :func:`hash_normal_stack`) in place of the threefry bulk draw.

    With the per-step (word, step) derivation of
    :func:`hash_word`, the jnp engine draws bitwise the noise of the GPU
    step kernel (tests/test_triton_step.py).
    """
    shape = rho.shape
    dtype = rho.dtype
    if not params.noise_on:
        z = jnp.zeros((Q,) + shape, dtype)
        return z, z
    rho, phi = _amplitude_fields(rho, phi, params, dtype, ref_state)
    n = hash_normal_stack(word, step, shape, dtype, dist)
    return _apply_amplitudes(n, rho, phi, params, dtype)


def hash_word(sub: jax.Array) -> jnp.ndarray:
    """The per-step int32 key word of the hash stream, drawn from the
    step's split RNG key (the same split the threefry stream consumes)."""
    return jax.random.randint(
        sub, (1,), minval=jnp.iinfo(jnp.int32).min,
        maxval=jnp.iinfo(jnp.int32).max, dtype=jnp.int32)[0]


def normal_stack(sub: jax.Array, step, shape, dtype,
                 noise_source: str = "threefry",
                 dist: str = "clt4") -> jnp.ndarray:
    """(33, X, Y, Z) standard normals for one step from either stream."""
    if noise_source == "hash":
        return hash_normal_stack(hash_word(sub), step, shape, dtype, dist)
    return jax.random.normal(sub, (N_NORMALS,) + tuple(shape), dtype)
