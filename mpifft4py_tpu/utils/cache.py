"""Plan caching — the FFTW "wisdom" analog (SURVEY.md §5 checkpoint/resume).

The reference's FFTW plans could be saved as wisdom files so later runs skip
planning.  The XLA equivalent is the persistent compilation cache: first use
of each (shape, dtype, mesh) transform compiles (the "planning" step); with
the cache enabled, later *processes* reload the compiled executable.

    from mpifft4py_tpu.utils.cache import enable_wisdom_cache
    enable_wisdom_cache()       # call before the first jit

Placement rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it.  Otherwise the cache lives at a fixed
path inside the checkout, ``<repo>/.jax_cache`` — a fixed path, because the
directory is part of the cache key, so a path with a PID or a time in it
never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_wisdom_cache(path: str | None = None) -> str:
    """Enable the persistent XLA compilation cache; returns its directory.

    ``path`` overrides the default ``<repo>/.jax_cache``; it is ignored when
    ``JAX_COMPILATION_CACHE_DIR`` is set (the environment wins, and no
    ``jax_compilation_cache_dir`` is set in code).  Call before the first
    compilation.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        cache_dir = env
    else:
        cache_dir = os.path.expanduser(path) if path else REPO_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program, however small/fast-compiling.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir
