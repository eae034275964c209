"""Persistent XLA compilation cache.

Each fresh process pays seconds to minutes of compilation per program
class; the persistent cache turns that into a disk read.  Opt-in (the
tests, ``bench.py`` and ``chip_smoke.py`` call :func:`enable`;
BVC_COMPCACHE=0 disables) so library users keep JAX's defaults.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other path.  Otherwise the cache lives at one fixed
directory inside the checkout (``.jax_cache/``, git-ignored): the path is
part of the cache key, so a directory that moved would never hit.
"""

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable() -> bool:
    if os.environ.get("BVC_COMPCACHE", "1") == "0":
        return False
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return True
