"""Where the persistent XLA compilation cache lives — decided in one place.

If JAX_COMPILATION_CACHE_DIR is set, that directory is the cache: JAX reads
the variable itself, and nothing here names another.  Otherwise the cache
goes to `.jax_cache` at the root of the checkout (listed in .gitignore).
The path is fixed on purpose: it never depends on a temp name, a pid or the
time, so a second run finds what the first one compiled.  On the GPU the
cache also keeps XLA's autotuning results, so a warm run neither recompiles
nor re-autotunes.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The cache directory this process uses (env var, else the default)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on for this process; returns its directory.

    Idempotent.  When the env var is set JAX has already taken it as the
    cache directory, and this only confirms it."""
    d = cache_dir()
    if (jax.config.jax_compilation_cache_dir or "") != d:
        jax.config.update("jax_compilation_cache_dir", d)
    return d


def enabled() -> bool:
    """True when a persistent cache directory is in force."""
    return bool(jax.config.jax_compilation_cache_dir)
