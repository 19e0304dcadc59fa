"""Test configuration: run on CPU with 8 virtual devices so sharding tests
exercise a real Mesh without accelerators (SURVEY.md §4.7), and enable
x64 so physics checks can validate the f32 path against f64.

The platform is the CPU unless JAX_PLATFORMS names another: on a GPU
machine ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs
the tests marked ``gpu``.  They decide inside a fixture (``gpu_device``)
whether a card is present, never at import: every xdist worker must
collect the same tests."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip (tests marked ``gpu``)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return gpus[0]
