"""Baselines, iterated GF, profiling utils."""
import os

import numpy as np
import jax.numpy as jnp

from reflectance_filtering.ops.baselines import rescaling_baseline
from reflectance_filtering.ops.guided import (
    guided_filter, guided_filter_iterated)
from reflectance_filtering.utils.profiling import (
    span, write_rate_artifact)


def test_rescaling_baseline_range(rng):
    imgs = rng.rand(2, 16, 16, 3).astype(np.float32)
    r, s = rescaling_baseline(jnp.asarray(imgs))
    r = np.asarray(r)
    for b in range(2):
        assert abs(r[b].min() - 0.55) < 1e-6
        assert abs(r[b].max() - 1.0) < 1e-6
    # lambertian: intensity = r * s
    np.testing.assert_allclose(np.asarray(s) * r, imgs.mean(-1),
                               rtol=1e-5, atol=1e-6)


def test_rescaling_baseline_flat_image():
    imgs = jnp.full((1, 8, 8, 3), 0.5, jnp.float32)
    r, s = rescaling_baseline(imgs)
    np.testing.assert_allclose(np.asarray(r), 0.55, rtol=1e-6)


def test_iterated_gf_equals_manual_chain(rng):
    g = (rng.rand(24, 24, 3) * 255).astype(np.float32)
    p = (rng.rand(24, 24, 3) * 255).astype(np.float32)
    got = np.asarray(guided_filter_iterated(jnp.asarray(g), jnp.asarray(p),
                                            4, 9.0, iterations=3))
    x = jnp.asarray(p)
    for _ in range(3):
        x = guided_filter(jnp.asarray(g), x, 4, 9.0)
    np.testing.assert_allclose(got, np.asarray(x), rtol=1e-5, atol=1e-3)


def test_span_and_rate_artifact(tmp_path):
    with span("work") as s:
        sum(range(1000))
    assert s.seconds is not None and s.seconds >= 0
    path = str(tmp_path / "framerates" / "x.txt")
    write_rate_artifact(path, 100, 2.0)
    with open(path) as f:
        assert float(f.read()) == 50.0
