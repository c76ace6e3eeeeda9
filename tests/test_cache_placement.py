"""Compile-cache placement (``utils.cache.enable_wisdom_cache``).

With ``JAX_COMPILATION_CACHE_DIR`` set, no code sets
``jax_compilation_cache_dir`` — JAX reads the variable itself.  Without it
the cache lives at the fixed ``<repo>/.jax_cache``, which git ignores.  The
config updates are recorded, never applied: the tests do not turn the
cache on."""

import os

import pytest

import jax

from mpifft4py_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recorded(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(cache.os, "makedirs", lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("explicit", [None, "elsewhere"])
def test_env_var_wins_and_nothing_overrides_it(recorded, monkeypatch, explicit):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert cache.enable_wisdom_cache(explicit) == "/some/cache"
    assert "jax_compilation_cache_dir" not in recorded


def test_default_is_fixed_path_in_checkout(recorded, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_wisdom_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cache.REPO_CACHE_DIR
    assert recorded["jax_compilation_cache_dir"] == path
    assert recorded["jax_persistent_cache_min_compile_time_secs"] == 0


def test_explicit_path_without_env(recorded, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_wisdom_cache("~/c") == os.path.expanduser("~/c")
    assert recorded["jax_compilation_cache_dir"] == os.path.expanduser("~/c")


def test_gitignore_lists_cache():
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert ".jax_cache/" in lines


def test_tests_leave_cache_off():
    assert not jax.config.jax_compilation_cache_dir
