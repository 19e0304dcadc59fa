"""Multi-chip runs: device mesh, engines, decomposition invariance.

Mirrors the reference's MPI domain decomposition
(``main_run_job.cpp:140-147`` / ``BoxArray.maxSize``) with a
``jax.sharding.Mesh`` over the spatial axes and two engines

  * ``auto``  - GSPMD: jit the whole step with NamedSharding-annotated
    state; XLA inserts the halo collectives,
  * ``halo``  - shard_map: explicit 2-deep halos via ``lax.ppermute``,
    one exchange per step.

This example runs on N VIRTUAL CPU devices (works on a laptop), shows
the same API as a multi-GPU host, and demonstrates the property the
reference cannot offer: the threefry noise stream is keyed globally, so
every mesh layout consumes the SAME drawn normals and trajectories
agree to float rounding (the reference's per-rank RNG engines make the
physics depend on the decomposition).

Run:  python examples/09_multichip.py            # 8 virtual devices
      python -m bflbm_tpu.run --distributed ...  # real multi-host runs
"""

import os
import sys

# virtual devices must be configured before jax initializes
N_DEV = int(os.environ.get("BFLBM_EXAMPLE_DEVICES", "8"))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={N_DEV}")

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # examples/ + repo root
from _common import ensure_dir, example_argparser, setup_backend, show

ap = example_argparser(__doc__, "out/examples/multichip")
args = ap.parse_args()
args.cpu = True  # virtual host devices live on the CPU platform
setup_backend(args)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from bflbm_tpu import run as run_mod  # noqa: E402
from bflbm_tpu.config import preset  # noqa: E402
from bflbm_tpu.parallel import mesh as mesh_lib  # noqa: E402

ensure_dir(args.out)
n = 16 * args.scale
base = preset("mixture-fluct").replace(
    shape=(n, n, n), nsteps=20, step_continue=0, init="mixture",
    plot_int=20, sf_window=0)

devs = jax.devices()
print(f"{len(devs)} devices on platform {devs[0].platform!r}")

# single device (reference trajectory) ----------------------------------
cfg1 = base.replace(out_dir=os.path.join(args.out, "single"))
run_mod.run(cfg1, mesh=mesh_lib.make_mesh((1, 1, 1), devices=devs[:1]))

results = {}
for name, shape, engine in (
        ("gspmd_x8", (N_DEV, 1, 1), "auto"),
        ("gspmd_2x4", (2, 4, 1) if N_DEV == 8 else (N_DEV, 1, 1), "auto"),
        ("shardmap_halo_x8", (N_DEV, 1, 1), "halo"),
):
    cfg = base.replace(out_dir=os.path.join(args.out, name))
    run_mod.run(cfg, mesh=mesh_lib.make_mesh(shape), engine=engine)
    results[name] = {"mesh": shape, "engine": engine}

# decomposition invariance: same noise stream on every layout ------------
from bflbm_tpu.io import fields as fields_io  # noqa: E402

ref = fields_io.read_frame(os.path.join(args.out, "single",
                                        f"plt{base.nsteps:07d}.npz"))
for name, info in results.items():
    d = fields_io.read_frame(os.path.join(args.out, name,
                                          f"plt{base.nsteps:07d}.npz"))
    dmax = max(float(np.abs(ref["rho"] - d["rho"]).max()),
               float(np.abs(ref["ufx"] - d["ufx"]).max()))
    info["max_abs_delta_vs_single_device"] = dmax
    info["same_noise_stream"] = bool(dmax < 1e-5)
show("decomposition invariance (kBT=1e-5, 20 steps; float-rounding "
     "level deltas only — same normals on every layout)", results)
