"""Persistent XLA compilation cache setup.

Compiling the full-size programs takes tens of seconds each, so the CLI
entry points keep JAX's persistent compilation cache. Where the
``JAX_COMPILATION_CACHE_DIR`` environment variable is set, JAX already
uses that directory and nothing here overrides it. Otherwise the cache
lives at the fixed in-checkout path ``<repo>/.jax_cache``: the directory is
part of each entry's key, so a path that moved between runs (a pid, a
temporary name, the time) would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["cache_dir", "enable_persistent_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_DEFAULT = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def cache_dir(environ=None) -> Path:
    """The directory the persistent cache uses: ``$JAX_COMPILATION_CACHE_DIR``
    if set, else ``<repo>/.jax_cache``."""
    env = os.environ if environ is None else environ
    return Path(env[_ENV]) if env.get(_ENV) else _DEFAULT


def enable_persistent_cache() -> Path:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
