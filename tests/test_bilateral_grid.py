"""Bilateral-grid fast mode: approximate, opt-in, never the parity path.

Validated against the exact XLA-scan joint bilateral (itself cv2-gated in
test_filters.py).  Error thresholds are ~2-3x the observed values on a
natural-statistics image (mean 0.4 / p99 1.7 / max 2.6 uint8 levels at
the default ss=8, sr=8) — the residual is the disk-vs-separable spatial
truncation mismatch, not grid resolution.
"""
import numpy as np

from reflectance_filtering.ops.bilateral import joint_bilateral_filter
from reflectance_filtering.ops.bilateral_grid import (
    bilateral_grid_gray, bilateral_grid_u8)


def _natural(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(120 + 70 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
                  + 15 * rng.randn(h, w), 0, 255)
    img[h // 3:2 * h // 3, w // 3:2 * w // 3] = np.clip(
        img[h // 3:2 * h // 3, w // 3:2 * w // 3] + 70, 0, 255)
    return img.astype(np.uint8)


def test_grid_close_to_exact_self(rng):
    img = _natural(rng, 96, 128)
    g3 = np.repeat(img[..., None], 3, -1)
    exp = np.asarray(joint_bilateral_filter(
        g3.astype(np.float32), g3.astype(np.float32), -1, 20.0, 22.0))
    got = bilateral_grid_u8(g3, g3, 20.0, 22.0)
    d = np.abs(got.astype(np.float64) - exp)
    assert d.mean() <= 1.0
    assert np.percentile(d, 99) <= 4.0
    assert d.max() <= 8.0


def test_grid_joint_neq_src(rng):
    joint = _natural(rng, 64, 96)
    src = (rng.rand(64, 96) * 255).astype(np.uint8)
    j3 = np.repeat(joint[..., None], 3, -1)
    exp = np.asarray(joint_bilateral_filter(
        j3.astype(np.float32), src.astype(np.float32), -1, 20.0, 22.0))
    got = bilateral_grid_u8(j3, src, 20.0, 22.0)
    d = np.abs(got.astype(np.float64) - exp)
    # uniform-noise src is the adversarial case for the grid (no
    # self-regularization); observed mean 1.6 / p99 8.3
    assert d.mean() <= 2.5 and np.percentile(d, 99) <= 12.0


from reflectance_filtering.utils.testimages import pink_noise as _pink


def test_grid_quality_point_p99(rng):
    """The documented quality operating point (ss=8, sr=6) holds p99
    error <= 1 uint8 level per image across the 6-class
    quality set (hard edge / noise / binary / low-contrast / wedges /
    1/f pink noise)."""
    import jax.numpy as jnp
    h, w = 256, 256
    yy, xx = np.mgrid[0:h, 0:w]
    study = np.clip(120 + 80 * np.sin(xx / 60.0) * np.cos(yy / 45.0)
                    + 30 * np.sin((xx + yy) / 15.0)
                    + 20 * rng.rand(h, w), 0, 255)
    study[60:120, 60:120] = 220
    imgs = np.floor(np.stack([
        study,
        rng.rand(h, w) * 255,
        (rng.rand(h, w) > 0.5) * 255.0,
        np.clip(128 + 25 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
                + 8 * rng.rand(h, w), 0, 255),
        (np.floor(xx / 32) * 36.0) % 256,
        _pink(rng, h, w),
    ])).astype(np.float32)
    xj = jnp.asarray(imgs)
    approx = np.asarray(bilateral_grid_gray(
        xj, xj[:, None], 20.0 / 3.0, 22.0, ss=8, sr=6))[:, 0]
    for i in range(len(imgs)):
        i3 = np.repeat(imgs[i][..., None], 3, -1)
        exact = np.asarray(joint_bilateral_filter(i3, i3, -1, 20.0,
                                                  22.0))[..., 0]
        d = np.abs(np.clip(np.rint(approx[i]), 0, 255)
                   - np.clip(np.rint(exact), 0, 255))
        assert np.percentile(d, 99) <= 1.0, (i, np.percentile(d, 99))
        assert d.max() <= 4.0, (i, d.max())


def test_grid_batched_channels(rng):
    import jax.numpy as jnp
    j = np.floor(rng.rand(2, 40, 48) * 256).astype(np.float32)
    s = np.floor(rng.rand(2, 3, 40, 48) * 256).astype(np.float32)
    out = np.asarray(bilateral_grid_gray(jnp.asarray(j), jnp.asarray(s),
                                         10.0, 8.0))
    assert out.shape == (2, 3, 40, 48)
    assert np.isfinite(out).all()
    assert out.min() >= -1 and out.max() <= 256
