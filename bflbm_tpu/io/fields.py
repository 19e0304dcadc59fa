"""Hydro-field frame output (plotfile analog).

The reference writes AMReX plotfiles consumed by yt in the notebooks
(WriteSingleLevelPlotfile, main_run_job.cpp:35-55).  Here frames are
compressed npz keyed by the 22-component schema names
(:data:`bflbm_tpu.ops.hydro.HYDRO_NAMES`) so the analysis package and any
numpy-based workflow can read them directly.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..ops.hydro import HYDRO_NAMES


_AUTO_NATIVE_BYTES = 32 * 2 ** 20  # frames above this use the native writer


def frame_path(out_dir: str, step: int, ndigits: int = 7,
               ext: str = "npz") -> str:
    return os.path.join(out_dir, f"plt{step:0{ndigits}d}.{ext}")


def write_frame(out_dir: str, step: int, packed_hydro,
                fmt: str = "auto", writer=None) -> str:
    """packed_hydro: (22, X, Y, Z) array following HYDRO_NAMES order.

    fmt: 'npz' | 'native' | 'h5' | 'auto' (native CRC container for
    large frames — np.savez_compressed is prohibitively slow at 256^3).
    writer: optional io.native.AsyncFieldWriter — large frames are
    snapshotted (memcpy at submit) and written by its background
    threads so the step loop never blocks on disk (the analog of
    AMReX's async VisMF plotfile path)."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.asarray(packed_hydro)
    if fmt == "auto":
        fmt = "native" if arr.nbytes >= _AUTO_NATIVE_BYTES else "npz"
    if fmt == "amrex":
        from . import amrex

        path = os.path.join(out_dir, f"plt{step:07d}")
        amrex.write_plotfile(path, arr, HYDRO_NAMES, time=float(step),
                             step=step)
        return path
    if fmt == "h5":
        from . import hdf5

        if not hdf5.available():
            raise RuntimeError("fmt='h5' requires h5py")
        return hdf5.write_frame_h5(frame_path(out_dir, step, ext="h5"),
                                   step, arr, HYDRO_NAMES)
    if fmt == "native":
        from . import native

        if writer is not None:
            path = frame_path(out_dir, step, ext="bflbm")
            writer.submit(path, list(HYDRO_NAMES),
                          [np.ascontiguousarray(arr[i])
                           for i in range(len(HYDRO_NAMES))])
            return path
        if native.available():
            path = frame_path(out_dir, step, ext="bflbm")
            native.write_fields(
                path, {n: arr[i] for i, n in enumerate(HYDRO_NAMES)})
            return path
    path = frame_path(out_dir, step)
    np.savez_compressed(path, step=step,
                        **{n: arr[i] for i, n in enumerate(HYDRO_NAMES)})
    return path


def read_frame(path: str) -> Dict[str, np.ndarray]:
    if os.path.isdir(path):
        # AMReX plotfile directory — the reference's own output format
        # (WriteSingleLevelPlotfile / VisMF, AMReX_FileIO.H:18-113)
        from . import amrex

        fields, meta = amrex.read_plotfile(path)
        fields["step"] = np.asarray(meta["step"])
        return fields
    if path.endswith(".h5"):
        from . import hdf5

        return hdf5.read_frame_h5(path)
    if path.endswith(".bflbm"):
        from . import native

        out = native.read_fields(path)
        import re

        m = re.search(r"plt(\d+)\.bflbm$", path)
        if m:
            out["step"] = np.asarray(int(m.group(1)))
        return out
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def write_noise_frame(out_dir: str, step: int, xi_f, xi_g) -> str:
    """Dump the 19-component per-mode noise fields (WriteOutNoise analog,
    Debug.H:381-409; consumed by the NoiseCovariance analysis)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"noise{step:07d}.npz")
    np.savez_compressed(path, step=step, xi_f=np.asarray(xi_f),
                        xi_g=np.asarray(xi_g))
    return path
