"""The worked examples (examples/) parse and expose the common CLI.

Full runs take minutes each; they are exercised by hand / in
verification (each was validated end-to-end on CPU).  Here we pin that
every script imports its harness and builds its argparser (--help exits
0 before any jax work), so API drift in example code is caught by CI.
"""

import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "[0-9]*.py")))


def test_examples_present():
    assert len(EXAMPLES) >= 10


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_help(path):
    r = subprocess.run([sys.executable, path, "--help"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert "--cpu" in r.stdout and "--scale" in r.stdout
    assert "--smoke" in r.stdout


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_smoke(path, tmp_path):
    """Every worked example runs END-TO-END at --smoke size (the
    migration surface of examples/README.md; SURVEY.md §4's
    notebooks-as-tests mandate).  Physics numbers are unconverged by
    design — this pins that the pipelines (run -> analysis -> report)
    execute.  ~30-120 s each on CPU; run via `pytest -m slow
    tests/test_examples.py`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, path, "--cpu", "--smoke",
         "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=1200, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
