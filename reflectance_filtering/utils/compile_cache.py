"""Persistent XLA compilation cache.

The reference CLIs are one-shot processes (decompose_with_trained_CNN.py,
filter_reflectance.py — the reference README.md:71-91 invokes them per
image), so every process start would recompile each (H, W) shape.  JAX's
persistent compilation cache serializes compiled executables to disk keyed
by HLO fingerprint, so a later process with the same shapes reloads them.

Where the cache lives:
  * ``JAX_COMPILATION_CACHE_DIR``, when it is set: JAX reads that variable
    itself, and this module sets no other directory;
  * otherwise ``.jax_cache/`` in the checkout's root (listed in
    .gitignore) — a fixed path, because the path is part of the cache's
    key and a directory that moves never hits.

Best-effort by design: a backend whose plugin cannot serialize executables
skips caching (jax_raise_persistent_cache_errors stays False).
"""
import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_compilation_cache() -> str:
    """Turn on JAX's disk compilation cache; returns its directory.  Call
    before the first compilation."""
    import jax

    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # cache anything that took real compile effort; tiny programs stay
    # out so the directory doesn't fill with trivia
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
