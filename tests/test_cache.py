"""Compile-cache directory rule (utils/cache.py).

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and nothing in code
sets another; otherwise the cache is the fixed in-checkout
``<repo>/.jax_cache`` — never a path made from a pid, a temporary name or
the time, since the directory is part of every entry's key. The test
process itself never enables the persistent cache (tests/conftest.py
records why), so the end-to-end check runs in a subprocess.
"""

import os
import subprocess
import sys
from pathlib import Path

from overiva_jax.utils.cache import cache_dir

REPO = Path(__file__).resolve().parent.parent


def test_env_var_is_the_cache(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
    assert cache_dir(env) == tmp_path / "cc"


def test_default_is_fixed_in_checkout_path():
    assert cache_dir({}) == REPO / ".jax_cache"
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == REPO / ".jax_cache"
    assert cache_dir({}) == cache_dir({})


def test_enable_keeps_env_dir_in_fresh_process(tmp_path):
    """In a fresh process with the variable set, enabling the cache leaves
    JAX's own setting (read from the environment) in place, returns that
    directory twice over, and creates it."""
    target = tmp_path / "jax-cc"
    code = (
        "import jax\n"
        "from overiva_jax.utils.cache import enable_persistent_cache\n"
        "a = enable_persistent_cache(); b = enable_persistent_cache()\n"
        "print(a); print(b); print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(target))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(target)] * 3
    assert target.is_dir()
