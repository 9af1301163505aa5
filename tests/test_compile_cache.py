"""Where the persistent compilation cache lives (utils/compile_cache.py):
JAX_COMPILATION_CACHE_DIR when set, else one fixed, gitignored directory
inside the checkout."""

import json
import os
import subprocess
import sys

import jax

from psgradientsdf.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_names_the_cache(tmp_path, monkeypatch):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert compile_cache.enabled()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(REPO, ".jax_cache") == compile_cache.DEFAULT_DIR
    assert compile_cache.cache_dir() == d          # no pid, time or temp name
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cli_run_writes_cache_to_env_dir(tmp_path):
    """A CLI run with the variable set compiles into that directory."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_e2e_tum_tracking import make_tum_dataset

    data = str(tmp_path / "data") + "/"
    out = str(tmp_path / "out") + "/"
    cache = str(tmp_path / "cache")
    make_tum_dataset(data, n_frames=4, H=48, W=64)
    cfg = {"input": data, "output": out, "pose filename": "none.txt",
           "datatype": "tum", "first": 0, "last": 3, "voxel size": 0.015,
           "zmin": 0.3, "zmax": 3.5, "sharpness threshold": 0.0,
           "grid dim": 32}
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    proc = subprocess.run(
        [sys.executable, "-m", "psgradientsdf.cli", "--config_file",
         cfg_path, "--no-refine", "--platform", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.listdir(cache), "no cache entries written"
    events = [json.loads(l) for l in open(out + "metrics.jsonl")]
    dirs = [e["dir"] for e in events if e["event"] == "compile_cache"]
    assert dirs == [cache], dirs
