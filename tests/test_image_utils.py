"""Tests for utils/image.py — parity with the reference's numeric quirks.

The reference implementations (image_utils.py:32-92) are re-stated here as
independent oracles so the framework's vectorized versions are checked
against the exact indexing-based formulation the reference used.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from reflectance_filtering.utils import image as iu


def _ref_srgb_to_rgb(srgb):
    ret = np.zeros_like(srgb)
    idx0 = srgb <= 0.04045
    idx1 = srgb > 0.04045
    ret[idx0] = srgb[idx0] / 12.92
    ret[idx1] = np.power((srgb[idx1] + 0.055) / 1.055, 2.4)
    return ret


def _ref_rgb_to_srgb(rgb):
    ret = np.zeros_like(rgb)
    idx0 = rgb <= 0.0031308
    idx1 = rgb > 0.0031308
    ret[idx0] = rgb[idx0] * 12.92
    ret[idx1] = np.power(1.055 * rgb[idx1], 1.0 / 2.4) - 0.055
    return ret


def test_srgb_to_rgb_matches_reference_float64(rng):
    x = rng.rand(64, 64, 3)
    np.testing.assert_array_equal(iu.srgb_to_rgb(x), _ref_srgb_to_rgb(x))


def test_rgb_to_srgb_matches_reference_float64(rng):
    x = rng.rand(64, 64, 3)
    np.testing.assert_array_equal(iu.rgb_to_srgb(x), _ref_rgb_to_srgb(x))


def test_gamma_roundtrip_matches_reference_roundtrip(rng):
    # NOTE: Bell's rgb_to_srgb is (1.055*x)^(1/2.4) - 0.055, which is NOT the
    # exact inverse of srgb_to_rgb — the roundtrip error is a reference quirk
    # we must reproduce, so compare roundtrips, not identity.
    x = rng.rand(32, 32, 3).astype(np.float32)
    ours = iu.rgb_to_srgb(iu.srgb_to_rgb(x))
    ref = _ref_rgb_to_srgb(_ref_srgb_to_rgb(x))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours, x, atol=0.05)  # close but not exact


def test_jnp_matches_numpy(rng):
    x = rng.rand(16, 16, 3).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(iu.srgb_to_rgb_jnp(jnp.asarray(x))),
        iu.srgb_to_rgb(x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(iu.rgb_to_srgb_jnp(jnp.asarray(x))),
        iu.rgb_to_srgb(x), rtol=1e-5, atol=1e-6)


def test_all_uint8_srgb_values(rng):
    # the CNN input path maps uint8/255 through srgb_to_rgb; check every level
    levels = np.arange(256, dtype=np.float64) / 255.0
    np.testing.assert_array_equal(iu.srgb_to_rgb(levels),
                                  _ref_srgb_to_rgb(levels))


def test_normalize_percentile_lower_quirk(rng):
    img = rng.rand(50, 50) * 10.0
    out = iu.normalize(img)
    # reference formulation
    expected = img.copy()
    expected /= np.percentile(img, 99.9, method="lower")
    expected = np.clip(expected, 0, 1)
    np.testing.assert_array_equal(out, expected)
    assert out.max() <= 1.0


def test_normalize_leaves_01_images_alone(rng):
    img = rng.rand(10, 10) * 0.9
    np.testing.assert_array_equal(iu.normalize(img), img)


def test_colorize_matches_reference(rng):
    # reference colorize runs on the RAW uint8 image (0-255 values)
    intensity = rng.rand(20, 20).astype(np.float32) + 0.1
    image = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
    refl, shad = iu.colorize(intensity, image)
    norm_input = np.mean(image, axis=2)
    shading = norm_input / intensity
    reflectance = image / np.maximum(shading, 1e-3)[:, :, np.newaxis]
    np.testing.assert_array_equal(shad, shading)
    np.testing.assert_array_equal(refl, reflectance)


def test_imwrite_truncation_semantics(tmp_path, rng):
    import cv2
    img = rng.rand(8, 8, 3).astype(np.float32) * 0.5
    path = str(tmp_path / "x.png")
    iu.imwrite(path, img)
    back = cv2.imread(path)
    # float path: normalize (max<=1 -> identity ... here max<1 so no-op),
    # *255, truncate
    expected = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(back, expected)


def test_imwrite_uint8_verbatim(tmp_path, rng):
    import cv2
    img = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "y.png")
    iu.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)


def test_imread_missing_raises(tmp_path):
    with pytest.raises(IOError):
        iu.imread(str(tmp_path / "nope.png"))
