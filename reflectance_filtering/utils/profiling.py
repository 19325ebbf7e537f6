"""Tracing / profiling utilities.

The reference instrumented with ad-hoc timeit spans and persisted rates to
plain-text artifacts (SURVEY.md §5.1: helper:275-298, 530-552).  This
module keeps that plain-text contract and adds the device-level tool — the
JAX profiler, whose traces open in XProf/TensorBoard.

Usage::

    with span("predict") as s: ...
    print(s.seconds)

    with device_trace("/tmp/trace"):   # XLA-level trace of everything inside
        run_pipeline(...)
"""
from __future__ import annotations

import contextlib
import os
import timeit
from typing import Iterator, Optional


class Span:
    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self._start: Optional[float] = None


@contextlib.contextmanager
def span(name: str, verbose: bool = False) -> Iterator[Span]:
    """Wall-clock span (the reference's timeit.default_timer idiom)."""
    s = Span(name)
    s._start = timeit.default_timer()
    try:
        yield s
    finally:
        s.seconds = timeit.default_timer() - s._start
        if verbose:
            print("[span] {}: {:.4f}s".format(name, s.seconds))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX profiler trace (view with xprof / tensorboard --logdir)."""
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def write_rate_artifact(path: str, num_items: int, seconds: float):
    """Persist an items/second rate the way the reference wrote
    framerates/*.txt (helper:548-552)."""
    parent = os.path.dirname(path)
    if parent:  # bare filename: write to the current directory
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(str(num_items / seconds))
