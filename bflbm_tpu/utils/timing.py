"""Wall-clock + MLUPS benchmarking helpers (replaces the reference's
ParallelDescriptor::second()/ReduceRealMax timing, main_run_job.cpp:416-420)."""

from __future__ import annotations

import time
from typing import Callable

import jax


def time_steps(run: Callable[[], object], cells: int, steps: int,
               warmup: int = 1, repeats: int = 3) -> dict:
    """Benchmark a compiled step loop: run() advances `steps` steps and
    returns its outputs, which are waited for with block_until_ready
    inside the timed region (JAX dispatch is asynchronous)."""
    for _ in range(warmup):
        jax.block_until_ready(run())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    best = min(times)
    mlups = cells * steps / best / 1e6
    return {
        "best_s": best,
        "times_s": times,
        "mlups": mlups,
        "glups": mlups / 1e3,
        "ns_per_cell_step": best / (cells * steps) * 1e9,
    }
