"""Where the persistent compilation cache lives (utils/compile_cache.py)."""
import os

import jax

from reflectance_filtering.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_enable_sets_no_dir_when_env_var_is_set(monkeypatch, tmp_path):
    """With the variable set, JAX reads it itself; the program must not
    point the cache anywhere else (or create the checkout dir)."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_persistent_compilation_cache() == str(
        tmp_path / "c")
    assert "jax_compilation_cache_dir" not in dict(calls)


def test_enable_uses_checkout_dir_without_env_var(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "CHECKOUT_CACHE_DIR",
                        str(tmp_path / ".jax_cache"))
    d = compile_cache.enable_persistent_compilation_cache()
    assert d == str(tmp_path / ".jax_cache") and os.path.isdir(d)
    assert dict(calls)["jax_compilation_cache_dir"] == d
