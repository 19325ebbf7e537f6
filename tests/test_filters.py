"""Filter kernel tests.

Oracles:
  * box filter: direct float64 numpy windowed mean with explicit border.
  * guided filter: float64 numpy implementation of He et al. (independent
    code path from the jnp one).
  * joint bilateral: cv2.bilateralFilter — OpenCV itself — for the
    joint == src case (identical algorithm; jointBilateralFilter only
    changes where the range weight reads from), plus a direct numpy oracle
    for joint != src.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from reflectance_filtering.ops.boxfilter import box_filter
from reflectance_filtering.ops.guided import guided_filter, guided_filter_u8
from reflectance_filtering.ops.bilateral import (
    joint_bilateral_filter, joint_bilateral_filter_u8, opencv_bilateral_params)


# ---------------------------------------------------------------------------
# box filter
# ---------------------------------------------------------------------------

def _np_box(x, radius, border):
    mode = {"reflect": "symmetric", "reflect101": "reflect"}[border]
    pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (x.ndim - 2)
    xp = np.pad(x.astype(np.float64), pad, mode=mode)
    w = 2 * radius + 1
    out = np.zeros_like(x, dtype=np.float64)
    for dy in range(w):
        for dx in range(w):
            out += xp[dy:dy + x.shape[0], dx:dx + x.shape[1]]
    return out / (w * w)


@pytest.mark.parametrize("radius", [1, 3, 8, 45])
@pytest.mark.parametrize("border", ["reflect", "reflect101"])
def test_box_filter_matches_numpy(radius, border, rng):
    x = (rng.rand(97, 121) * 255).astype(np.float32)
    got = np.asarray(box_filter(jnp.asarray(x), radius, border=border))
    exp = _np_box(x, radius, border)
    # f32 block-prefix noise: bounded by ulp(BLOCK*255) ~ 8e-3, image-size
    # independent; far below the 0.5 uint8 rounding threshold.
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=5e-3)


def test_box_filter_channels(rng):
    x = (rng.rand(40, 50, 3) * 255).astype(np.float32)
    got = np.asarray(box_filter(jnp.asarray(x), 5))
    exp = _np_box(x, 5, "reflect")
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=5e-3)


def test_box_filter_precision_on_large_squared_values(rng):
    """The failure mode a naive global cumsum has: squared 0-255 values on a
    big image — error must stay tiny (guided-filter variance path)."""
    x = (rng.rand(600, 2048) * 255).astype(np.float32)
    x2 = x * x
    got = np.asarray(box_filter(jnp.asarray(x2), 45))
    exp = _np_box(x2, 45, "reflect")
    err = np.abs(got - exp).max()
    assert err < 0.05, err  # in (0-255)^2 units; eps is >= 3 in practice


# ---------------------------------------------------------------------------
# guided filter
# ---------------------------------------------------------------------------

def _np_guided_color(I, p, radius, eps):
    """Float64 He et al. guided filter, color guide, loop-free numpy."""
    I = I.astype(np.float64)
    p = p.astype(np.float64)

    def box(x):
        return _np_box(x, radius, "reflect")

    mean_I = box(I)
    out = np.zeros_like(p)
    for c in range(p.shape[2]):
        pc = p[:, :, c]
        mean_p = box(pc)
        cov = np.stack([box(I[:, :, k] * pc) - mean_I[:, :, k] * mean_p
                        for k in range(3)], axis=-1)          # [H,W,3]
        var = np.zeros(I.shape[:2] + (3, 3))
        for i in range(3):
            for j in range(3):
                var[:, :, i, j] = (box(I[:, :, i] * I[:, :, j]) -
                                   mean_I[:, :, i] * mean_I[:, :, j])
            var[:, :, i, i] += eps
        a = np.linalg.solve(var, cov[..., None])[..., 0]       # [H,W,3]
        b = mean_p - np.sum(a * mean_I, axis=-1)
        mean_a = np.stack([box(a[:, :, k]) for k in range(3)], axis=-1)
        mean_b = box(b)
        out[:, :, c] = np.sum(mean_a * I, axis=-1) + mean_b
    return out


def _np_guided_gray(I, p, radius, eps):
    I = I.astype(np.float64)
    p = p.astype(np.float64)

    def box(x):
        return _np_box(x, radius, "reflect")

    mean_I = box(I)
    mean_p = box(p)
    var_I = box(I * I) - mean_I ** 2
    cov = box(I * p) - mean_I * mean_p
    a = cov / (var_I + eps)
    b = mean_p - a * mean_I
    return box(a) * I + box(b)


def test_guided_gray_matches_numpy(rng):
    I = (rng.rand(60, 70) * 255).astype(np.float32)
    p = (rng.rand(60, 70) * 255).astype(np.float32)
    got = np.asarray(guided_filter(jnp.asarray(I), jnp.asarray(p), 8, 9.0))
    exp = _np_guided_gray(I, p, 8, 9.0)
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("radius,eps", [(4, 3.0), (16, 49.0)])
def test_guided_color_matches_numpy(radius, eps, rng):
    I = (rng.rand(70, 80, 3) * 255).astype(np.float32)
    p = (rng.rand(70, 80, 3) * 255).astype(np.float32)
    got = np.asarray(guided_filter(jnp.asarray(I), jnp.asarray(p),
                                   radius, eps))
    exp = _np_guided_color(I, p, radius, eps)
    np.testing.assert_allclose(got, exp, rtol=1e-3, atol=0.05)


def test_guided_identity_property(rng):
    """Filtering the guide by itself with eps -> 0 approaches identity."""
    I = (rng.rand(64, 64, 3) * 255).astype(np.float32)
    got = np.asarray(guided_filter(jnp.asarray(I), jnp.asarray(I), 6, 1e-4))
    np.testing.assert_allclose(got, I, atol=1.0)


def test_guided_u8_rounding(rng):
    I = (rng.rand(40, 40, 3) * 255).astype(np.uint8)
    p = (rng.rand(40, 40, 3) * 255).astype(np.uint8)
    out = guided_filter_u8(I, p, 4, 9.0)
    assert out.dtype == np.uint8
    f = np.asarray(guided_filter(jnp.asarray(I), jnp.asarray(p), 4, 9.0))
    np.testing.assert_array_equal(out, np.clip(np.rint(f), 0, 255))


# ---------------------------------------------------------------------------
# joint bilateral filter
# ---------------------------------------------------------------------------

def test_param_preprocessing_matches_opencv():
    radius, gcc, gsc, taps = opencv_bilateral_params(-1, 20.0, 22.0)
    assert radius == 33  # round(1.5*22)
    assert gcc == -0.5 / 400.0
    # disk tap count for r=33
    assert len(taps) == sum(
        1 for i in range(-33, 34) for j in range(-33, 34)
        if (i * i + j * j) ** 0.5 <= 33)
    radius, _, _, _ = opencv_bilateral_params(9, 20.0, 22.0)
    assert radius == 4  # d//2
    radius, _, _, _ = opencv_bilateral_params(-1, 20.0, 0.1)
    assert radius == 1  # clamped


def _np_jbf(joint, src, d, sc, ss):
    """Direct numpy oracle following the OpenCV algorithm."""
    radius, gcc, gsc, taps = opencv_bilateral_params(d, sc, ss)
    jp = np.pad(joint.astype(np.float64),
                [(radius, radius), (radius, radius), (0, 0)], mode="reflect")
    sp = np.pad(src.astype(np.float64),
                [(radius, radius), (radius, radius), (0, 0)], mode="reflect")
    H, W = src.shape[:2]
    acc = np.zeros_like(src, dtype=np.float64)
    wsum = np.zeros((H, W))
    for dy, dx, sw in taps:
        dy, dx = int(dy) + radius, int(dx) + radius
        js = jp[dy:dy + H, dx:dx + W]
        ssl = sp[dy:dy + H, dx:dx + W]
        diff = np.abs(js - joint).sum(axis=-1)
        w = sw * np.exp(diff * diff * gcc)
        acc += w[..., None] * ssl
        wsum += w
    return acc / wsum[..., None]


def test_jbf_matches_numpy_oracle_joint_neq_src(rng):
    joint = (rng.rand(40, 44, 3) * 255).astype(np.uint8)
    src = (rng.rand(40, 44, 3) * 255).astype(np.uint8)
    got = np.asarray(joint_bilateral_filter(joint, src, -1, 20.0, 3.0))
    exp = _np_jbf(joint, src, -1, 20.0, 3.0)
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("sc,ss", [(20.0, 3.0), (30.0, 5.0)])
def test_jbf_self_matches_cv2_bilateral(sc, ss, rng):
    """joint == src: identical to cv2.bilateralFilter. Allow <=1 uint8 level
    on a tiny fraction of pixels (LUT-exp vs float-exp rounding)."""
    import cv2
    img = (rng.rand(64, 80, 3) * 255).astype(np.uint8)
    got = joint_bilateral_filter_u8(img, img, -1, sc, ss)
    exp = cv2.bilateralFilter(img, -1, sc, ss)
    diff = np.abs(got.astype(int) - exp.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02, (diff > 0).mean()


def test_jbf_smooth_region_is_mean_like(rng):
    """On a constant joint image the filter degenerates to a disk mean."""
    joint = np.full((40, 40, 3), 128, np.uint8)
    src = (rng.rand(40, 40, 3) * 255).astype(np.uint8)
    got = np.asarray(joint_bilateral_filter(joint, src, -1, 20.0, 4.0))
    radius, _, gsc, taps = opencv_bilateral_params(-1, 20.0, 4.0)
    sp = np.pad(src.astype(np.float64),
                [(radius,) * 2, (radius,) * 2, (0, 0)], mode="reflect")
    acc = np.zeros_like(src, np.float64)
    wsum = 0.0
    for dy, dx, sw in taps:
        dy, dx = int(dy) + radius, int(dx) + radius
        acc += sw * sp[dy:dy + 40, dx:dx + 40]
        wsum += sw
    np.testing.assert_allclose(got, acc / wsum, rtol=1e-4, atol=2e-3)


def test_jbf_gray_inputs(rng):
    joint = (rng.rand(32, 32) * 255).astype(np.uint8)
    src = (rng.rand(32, 32) * 255).astype(np.uint8)
    out = joint_bilateral_filter_u8(joint, src, -1, 15.0, 3.0)
    assert out.shape == (32, 32)
    assert out.dtype == np.uint8


def test_fast_guided_filter_close_to_exact(rng):
    """Fast Guided Filter (He 2015) with subsampling should track the
    exact filter on smooth natural-ish images; subsample=1 is exact."""
    from reflectance_filtering.ops.guided import (
        fast_guided_filter, guided_filter_planar)
    import jax.numpy as jnp
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    guide = np.stack([120 + 60 * np.sin(xx / 9.0),
                      100 + 50 * np.cos(yy / 7.0),
                      90 + 40 * np.sin((xx + yy) / 11.0)])[None]
    src = (guide[:, :1] * 0.7 +
           10 * rng.rand(1, 1, 64, 64).astype(np.float32))
    exact = np.asarray(guided_filter_planar(
        jnp.asarray(guide), jnp.asarray(src), 8, 9.0))
    fast = np.asarray(fast_guided_filter(
        jnp.asarray(guide), jnp.asarray(src), 8, 9.0, subsample=2))
    same = np.asarray(fast_guided_filter(
        jnp.asarray(guide), jnp.asarray(src), 8, 9.0, subsample=1))
    assert np.abs(fast - exact).mean() < 1.0     # < 1 uint8 level on avg
    np.testing.assert_allclose(same, exact, rtol=1e-4, atol=1e-2)
