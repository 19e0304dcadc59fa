"""Engine selection and the run loop around the step kernel: which engine
``run.run`` takes, what it refuses, chunk-split invariance, the
multi-device engines against one device, the compile-cache location,
and the scripts that must refuse to measure a CPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from bflbm_tpu import run as run_mod
from bflbm_tpu.config import preset
from bflbm_tpu.parallel import mesh as mesh_lib
from bflbm_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp_path, **kw):
    base = dict(shape=(4, 8, 8), init="mixture", step_continue=0, nsteps=12,
                plot_int=0, print_int=4, sf_window=0,
                out_dir=str(tmp_path / "out"))
    base.update(kw)
    return preset("mixture-fluct").replace(**base)


@pytest.mark.parametrize("kw,engine,want", [
    ({}, "auto", "jnp"),                            # no GPU here
    ({"noise_source": "hash"}, "auto", "jnp"),
    ({}, "jnp", "jnp"),
    ({"noise_source": "hash"}, "jnp", "jnp"),
])
def test_resolve_engine(tmp_path, kw, engine, want):
    assert run_mod.resolve_engine(_cfg(tmp_path, **kw), engine) == want


def test_pallas_on_cpu_needs_explicit_interpret(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="interpret=True"):
        run_mod.resolve_engine(cfg, "pallas")
    with pytest.raises(ValueError, match="interpret=True"):
        run_mod.run(cfg, engine="pallas")
    assert run_mod.resolve_engine(cfg, "pallas", interpret=True) == "pallas"


@pytest.mark.parametrize("kw,engine,mesh_shape,match", [
    ({"use_ref_state": True, "ref_state_path": "eq"}, "pallas", None,
     "USE_REF_STATE"),
    ({"use_ref_state": True, "ref_state_path": "eq"}, "halo", (4, 1, 1),
     "USE_REF_STATE"),
    ({}, "pallas", (4, 1, 1), "one device"),
    ({"noise_source": "hash"}, "pallas", None, "noise_source"),
    ({}, "halo", None, "needs a mesh"),
    ({}, "kernel", None, "unknown engine"),
])
def test_engine_rejections(tmp_path, kw, engine, mesh_shape, match):
    mesh = (mesh_lib.make_mesh(mesh_shape, devices=jax.devices()[:4])
            if mesh_shape else None)
    with pytest.raises(ValueError, match=match):
        run_mod.resolve_engine(_cfg(tmp_path, **kw), engine, mesh,
                               interpret=True)


def test_make_advance_chunks(tmp_path):
    cfg = _cfg(tmp_path)
    _, chunk = run_mod.make_advance(cfg, "jnp", 1)
    assert chunk is None
    mesh = mesh_lib.make_mesh((4, 1, 1), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="chunks > 2"):
        run_mod.make_advance(cfg, "halo", 2, mesh=mesh)


@pytest.mark.parametrize("print_int", [3, 6])
def test_kernel_chunk_split_invariance(tmp_path, print_int):
    """The kernel engine through run.run: the final state does not depend
    on how the run is cut into chunks (12 = 1 x 12, 2 x 6, 4 x 3), and
    equals the jnp engine on the same hash stream."""
    cfg = _cfg(tmp_path)
    whole = run_mod.run(cfg.replace(print_int=0,
                                    out_dir=str(tmp_path / "whole")),
                        engine="pallas", interpret=True)
    split = run_mod.run(cfg.replace(print_int=print_int),
                        engine="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(split.f), np.asarray(whole.f))
    np.testing.assert_array_equal(np.asarray(split.key),
                                  np.asarray(whole.key))
    ref = run_mod.run(cfg.replace(noise_source="hash",
                                  out_dir=str(tmp_path / "jnp")),
                      engine="jnp")
    np.testing.assert_allclose(np.asarray(split.f), np.asarray(ref.f),
                               rtol=0, atol=2e-5)
    recs = [json.loads(line) for line in
            open(os.path.join(cfg.out_dir, "metrics.jsonl"))]
    assert "compile_s" in recs[0] and recs[0]["step"] == 0
    assert [r["step"] for r in recs if "mlups" in r] == list(
        range(print_int, 13, print_int))


def test_kernel_run_frames_sk_checkpoint_resume(tmp_path):
    """The main path on the kernel engine: frames, S(k), checkpoint, and
    a resume that continues the uninterrupted trajectory bitwise."""
    cfg = _cfg(tmp_path, nsteps=8, plot_int=4, print_int=4, sf_window=8,
               sf_every=4)
    full = run_mod.run(cfg.replace(nsteps=12), engine="pallas",
                       interpret=True)
    first = run_mod.run(cfg.replace(out_dir=str(tmp_path / "a")),
                        engine="pallas", interpret=True)
    out = str(tmp_path / "a")
    assert sorted(f for f in os.listdir(out) if f.startswith("plt")) == [
        "plt0000000.npz", "plt0000004.npz", "plt0000008.npz"]
    with np.load(os.path.join(out, "structfact0000008.npz")) as d:
        assert d["s_k"].shape == (22, 4, 8, 8)
        assert np.isfinite(d["s_k"]).all()
    resumed = run_mod.run(cfg.replace(
        init="checkpoint", checkpoint_path=os.path.join(out,
                                                        "checkpoint0000008"),
        step_continue=8, nsteps=4, sf_window=0,
        out_dir=str(tmp_path / "b")), engine="pallas", interpret=True)
    assert int(first.step) == 8 and int(resumed.step) == 12
    np.testing.assert_array_equal(np.asarray(resumed.f), np.asarray(full.f))


@pytest.mark.parametrize("engine", ["jnp", "halo"])
def test_mesh_411_matches_one_device(tmp_path, engine):
    """GSPMD ('jnp' under a mesh) and 'halo' over a (4, 1, 1) mesh of
    virtual devices reproduce the one-device run on the hash stream (the
    comparison chip_smoke.py --four makes on four cards at 256^3)."""
    cfg = _cfg(tmp_path, shape=(16, 8, 8), nsteps=8, print_int=8,
               noise_source="hash")
    one = run_mod.run(cfg.replace(out_dir=str(tmp_path / "one")))
    mesh = mesh_lib.make_mesh((4, 1, 1), devices=jax.devices()[:4])
    got = run_mod.run(cfg, mesh=mesh, engine=engine)
    np.testing.assert_array_equal(np.asarray(got.key), np.asarray(one.key))
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(one.f),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.g), np.asarray(one.g),
                               rtol=0, atol=2e-5)


def test_cli_noise_dist(tmp_path, monkeypatch):
    """--noise-dist sets the hash generator; the kernel-only knobs of the
    old accelerator are gone."""
    # the CLI enables the compile cache: keep it out of the checkout
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    out = str(tmp_path / "cli")
    run_mod.main(["--preset", "mixture-eq", "--shape", "4", "4", "8",
                  "--nsteps", "2", "--kBT", "1e-5", "--noise-source",
                  "hash", "--noise-dist", "u8", "--out", out,
                  "--plot-int", "0"])
    meta = json.load(open(os.path.join(out, "checkpoint0000002.json")))
    assert meta["config"]["noise_dist"] == "u8"
    assert meta["config"]["noise_source"] == "hash"
    with pytest.raises(SystemExit):
        run_mod.main(["--block", "2"])


def test_compile_cache_env_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    assert compile_cache.enable() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        assert compile_cache.enable() == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_cpu(script):
    r = _run_script([script], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "MLUPS" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
