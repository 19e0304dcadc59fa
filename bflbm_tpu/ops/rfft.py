"""3D DFT as separable real cos/sin matmuls (split re/im).

Replaces the reference's gather-to-one-rank FFTW/cuFFT pipeline
(``amrex_fftw_r2c_3d``, AMReX_DFT.H:19-132) with real matmuls that
shard trivially (each axis contraction is local after an all-to-all that
XLA inserts as needed).  Cost is O(N^4) per axis vs O(N^3 log N) for an
FFT; at the structure-factor cadence (every ~100 steps) it is a small
share of a run, and ``jnp.fft`` (cuFFT on the GPU) is the candidate
replacement (ROADMAP.md).

All transforms keep (re, im) as separate real arrays and run at
Precision.HIGHEST (TF32 operand truncation would swamp kBT~1e-5
fluctuation spectra).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=32)
def _dft_mats_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (C, S) with C[k,x]=cos(2 pi k x/n), S[k,x]=sin(2 pi k x/n)."""
    k = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    ang = 2.0 * np.pi * (k * x % n) / n
    return np.cos(ang), np.sin(ang)


def _apply_axis(re: jnp.ndarray, im: jnp.ndarray, axis: int, dtype):
    """DFT along one axis: X_k = sum_x e^{-2 pi i k x / N} x_x."""
    n = re.shape[axis]
    c_np, s_np = _dft_mats_np(n)
    c = jnp.asarray(c_np, dtype)
    s = jnp.asarray(s_np, dtype)
    hp = jax.lax.Precision.HIGHEST

    def mm(mat, arr):
        out = jnp.tensordot(mat, arr, axes=([1], [axis]), precision=hp)
        return jnp.moveaxis(out, 0, axis)

    re_out = mm(c, re) + mm(s, im)
    im_out = mm(c, im) - mm(s, re)
    return re_out, im_out


def fft3(field: jnp.ndarray, axes=(-3, -2, -1)) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Real-input 3D DFT; returns (re, im) full spectra (same shape)."""
    dtype = field.dtype
    re = field
    im = jnp.zeros_like(field)
    nd = field.ndim
    for ax in axes:
        re, im = _apply_axis(re, im, ax % nd, dtype)
    return re, im


def power_spectrum(field: jnp.ndarray, remove_mean: bool = True,
                   unitary: bool = True) -> jnp.ndarray:
    """|F[field]|^2; unitary = 1/sqrt(N) normalization (Debug.ipynb recipe)."""
    x = field - jnp.mean(field) if remove_mean else field
    re, im = fft3(x)
    p = re * re + im * im
    if unitary:
        p = p / np.prod(x.shape[-3:])
    return p


def fftfreq_grid(shape) -> np.ndarray:
    """|k| magnitude grid in integer-frequency units (host-side)."""
    freqs = [np.fft.fftfreq(n) * n for n in shape]
    kx, ky, kz = np.meshgrid(*freqs, indexing="ij")
    return np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
