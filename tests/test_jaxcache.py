"""Where the persistent compilation cache goes."""
from pathlib import Path

import jax

from slamtpu.runtime import jaxcache

REPO = Path(__file__).resolve().parents[1]


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    return calls


def test_env_var_is_left_to_jax(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    calls = _record_updates(monkeypatch)
    jaxcache.enable_persistent_cache()
    assert calls == []


def test_default_is_a_fixed_dir_at_the_checkout_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    jaxcache.enable_persistent_cache()
    jaxcache.enable_persistent_cache()
    expected = ("jax_compilation_cache_dir", str(REPO / ".jax_cache"))
    assert calls == [expected, expected]


def test_default_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_tests_keep_their_cache_outside_the_checkout():
    cache = Path(jax.config.jax_compilation_cache_dir).resolve()
    assert REPO not in cache.parents and cache != REPO
