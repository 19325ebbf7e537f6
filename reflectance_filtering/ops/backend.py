"""The one backend switch of the product path.

Every operation that has a hand-written kernel asks :func:`use_kernels`
which implementation to run: on the GPU the Pallas/Triton kernel, on the
CPU the plain ``jax.numpy`` reference (which is also the test oracle).
Any other backend raises — nothing falls back silently.  Two contexts fix
the choice at trace time instead: :func:`references_only`, which the
benchmark uses to measure what the kernels buy end to end, and
:func:`kernels_for`, which serving uses to export for a platform the host
may not have.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import jax

_FIXED: Optional[bool] = None


@contextlib.contextmanager
def _fixed(choice: bool):
    global _FIXED
    prev, _FIXED = _FIXED, choice
    try:
        yield
    finally:
        _FIXED = prev


def references_only():
    """Within this block (at trace time) the plain references run instead
    of the kernels."""
    return _fixed(False)


def kernels_for(platforms: Sequence[str]):
    """Within this block (at trace time) the dispatch chooses for the
    lowering ``platforms`` instead of the running backend: the kernels for
    ``("cuda",)`` alone, the plain references for any other set (the
    Triton kernels lower only for cuda)."""
    return _fixed(tuple(platforms) == ("cuda",))


def use_kernels() -> bool:
    """True on the GPU (kernel path), False on the CPU (plain reference)."""
    if _FIXED is not None:
        return _FIXED
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(
        "unsupported JAX backend {!r}: the product path runs on an NVIDIA "
        "GPU (Triton kernels) or on the CPU (plain references)".format(
            backend))
