"""Shared helpers for the worked examples.

Each example mirrors one of the reference's workflow notebooks (see
examples/README.md for the map) at a size that runs in a minute or two.
Pass ``--cpu`` to force the CPU backend (a quick local run on a machine
with a GPU); sizes and step counts scale up with ``--scale``.
"""

import argparse
import json
import os


def example_argparser(desc: str, out_default: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--out", default=out_default,
                    help="artifact directory for this example")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--scale", type=int, default=1,
                    help="multiply domain edge / steps (1 = smoke size)")
    ap.add_argument("--smoke", action="store_true",
                    help="minimal-step CI mode: exercises the full "
                    "pipeline end-to-end in seconds; the physics "
                    "numbers are NOT converged (tests/test_examples.py "
                    "sweeps every example this way)")
    return ap


def pick(args, full, smoke):
    """full-size value, or the tiny one under --smoke."""
    return smoke if getattr(args, "smoke", False) else full


def setup_backend(args) -> None:
    """Select the backend BEFORE the first jax operation; the variable
    is also set so any subprocess inherits the choice."""
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")


def show(title: str, obj) -> None:
    print(f"== {title} ==")
    print(json.dumps(obj, indent=2, default=float))


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
