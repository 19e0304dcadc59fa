"""Streaming step as periodic pull shifts.

Reference: push-scheme scatter ``stream_push`` (LBM_binary.H:519-531),
which writes f(x) into fNew(x + c_i).  In XLA a scatter is the slow
form; the pull formulation fNew_i(x) = f_i(x - c_i) is identical (both
say the post-stream population at site y in direction i is the
pre-stream population at y - c_i) and lowers to fused shifted copies on
one device and to collective permutes across a sharded mesh.  (The GPU
step kernel, kernels/triton_step.py, pushes: there each target is one
store.)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lattice import C


def stream(f: jnp.ndarray, axes=(-3, -2, -1)) -> jnp.ndarray:
    """Pull-stream all 19 directions: out_i(x) = f_i(x - c_i)."""
    outs = []
    for i in range(C.shape[0]):
        sh = [int(s) for s in C[i]]
        ax = [a for a, s in zip(axes, sh) if s != 0]
        sh = [s for s in sh if s != 0]
        fi = f[i]
        outs.append(jnp.roll(fi, sh, ax) if sh else fi)
    return jnp.stack(outs)
