"""Native IO runtime tests (C++ thread-pooled decoder, native/).

Skipped gracefully if the toolchain can't build the library — the
framework falls back to cv2 decoding in that case (native_loader.py).
"""
import os

import numpy as np
import pytest

from reflectance_filtering.data import native_loader as nl


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths = []
    arrays = []
    for i in range(6):
        img = (rng.rand(50, 70, 3) * 255).astype(np.uint8)
        p = str(d / "{}.png".format(i))
        cv2.imwrite(p, img[:, :, ::-1])  # file stores BGR; loader gives RGB
        paths.append(p)
        arrays.append(img)
    jpg = str(d / "x.jpg")
    cv2.imwrite(jpg, arrays[0][:, :, ::-1])
    return paths, arrays, jpg


def test_native_builds():
    assert nl.native_available(), "native IO library failed to build"


def test_image_size(images):
    paths, arrays, _ = images
    assert nl.image_size(paths[0]) == (50, 70)


def test_png_decode_exact(images):
    paths, arrays, _ = images
    batch = nl.load_batch_rgb(paths, 50, 70)
    for i in range(len(paths)):
        np.testing.assert_array_equal(batch[i], arrays[i])


def test_jpeg_decode(images):
    import cv2
    _, arrays, jpg = images
    got = nl.load_batch_rgb([jpg], 50, 70)[0]
    ref = cv2.imread(jpg)[:, :, ::-1]
    np.testing.assert_array_equal(got, ref)


def test_resize_close_to_cv2(images):
    import cv2
    paths, arrays, _ = images
    got = nl.load_batch_rgb(paths[:1], 32, 48)[0]
    ref = cv2.resize(arrays[0], (48, 32),
                     interpolation=cv2.INTER_LINEAR)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1  # float rounding at half-pixel centers


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        nl.load_batch_rgb([str(tmp_path / "nope.png")], 8, 8)


def test_batch_feeds_decompose_pipeline(images):
    """Native batch -> device pipeline integration."""
    import jax.numpy as jnp
    from reflectance_filtering.models.caffe_io import (
        load_reference_weights)
    from reflectance_filtering.models.networks import (
        reference_params_from_caffe, reflectance_net_apply)
    from reflectance_filtering.utils.image import srgb_to_rgb

    paths, _, _ = images
    batch = nl.load_batch_rgb(paths, 32, 32)
    linear = srgb_to_rgb(batch.astype(np.float32) / 255.0).astype(np.float32)
    params = reference_params_from_caffe(load_reference_weights())
    refl = np.asarray(reflectance_net_apply(params, jnp.asarray(linear)))
    assert refl.shape == (len(paths), 32, 32, 1)
    assert np.all((refl > 0) & (refl < 1))


def test_empty_batch_returns_empty_array():
    from reflectance_filtering.data.native_loader import load_batch_rgb
    out = load_batch_rgb([], 8, 8)
    assert out.shape == (0, 8, 8, 3) and out.dtype == np.uint8


def test_probe_rejects_absurd_header(tmp_path):
    """A corrupt PNG header claiming terapixel dims must fail the probe
    (not feed a ~TB np.empty in the batch loader's size grouping)."""
    import struct
    import zlib
    ihdr = struct.pack(">II5B", 200000, 200000, 8, 2, 0, 0, 0)
    chunk = b"IHDR" + ihdr
    png = (b"\x89PNG\r\n\x1a\n"
           + struct.pack(">I", len(ihdr)) + chunk
           + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF))
    p = tmp_path / "huge.png"
    p.write_bytes(png)
    with pytest.raises(IOError):
        nl.image_size(str(p))


def test_bad_dimensions_raise_value_error(images):
    import pytest
    from reflectance_filtering.data.native_loader import load_batch_rgb
    with pytest.raises(ValueError):
        load_batch_rgb([images[0]], 0, 64)
    with pytest.raises(ValueError):
        load_batch_rgb([images[0]], 64, -1)
