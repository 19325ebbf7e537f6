"""Image numerics and IO conventions.

Behavioral contract mirrors the reference's image_utils.py
(the reference's image_utils.py:32-92) exactly, including its quirks:

  * sRGB <-> linear is the Bell-2014 piecewise curve with thresholds
    0.04045 / 0.0031308, exponent 2.4, slope 12.92 (image_utils.py:32-49).
  * ``imwrite`` of non-uint8 input normalizes by the 99.9th percentile with
    ``interpolation='lower'`` semantics, clips to [0,1], optionally encodes
    sRGB, then scales by 255 and *truncates* to uint8 (image_utils.py:60-73).
  * ``colorize`` runs on whatever value range it is given — the reference
    CLI feeds it the RAW uint8 BGR image (decompose_with_trained_CNN.py:122),
    so shading comes out in 0-255 units; reproduced verbatim for parity.
  * ``imread`` returns uint8 BGR HWC via OpenCV (image_utils.py:52-57).
    Where OpenCV is not installed, PNG files are read and written through
    the zlib codec in utils/png.py with the same uint8 results (gray files
    read as 3 equal channels, alpha dropped, as cv2.IMREAD_COLOR does).

Two parallel implementations are provided: numpy (host-side, used by CLI /
file IO paths where bit-parity with the reference matters) and jax.numpy
(device-side, fused into the XLA program for the batched pipeline).
"""
from __future__ import annotations

import zlib

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Gamma curves (Bell 2014 piecewise sRGB)
# ---------------------------------------------------------------------------

_SRGB_LIN_THRESH = 0.04045
_LIN_SRGB_THRESH = 0.0031308
_SRGB_SLOPE = 12.92
_SRGB_EXP = 2.4


def srgb_to_rgb(srgb):
    """sRGB -> linear RGB (numpy). Matches image_utils.py:32-39."""
    srgb = np.asarray(srgb)
    return np.where(
        srgb <= _SRGB_LIN_THRESH,
        srgb / _SRGB_SLOPE,
        np.power(np.maximum((srgb + 0.055) / 1.055, 0.0), _SRGB_EXP),
    )


def rgb_to_srgb(rgb):
    """linear RGB -> sRGB (numpy). Matches image_utils.py:42-49."""
    rgb = np.asarray(rgb)
    return np.where(
        rgb <= _LIN_SRGB_THRESH,
        rgb * _SRGB_SLOPE,
        np.power(np.maximum(1.055 * rgb, 0.0), 1.0 / _SRGB_EXP) - 0.055,
    )


def srgb_to_rgb_jnp(srgb):
    """sRGB -> linear RGB (device). Same math as :func:`srgb_to_rgb`."""
    return jnp.where(
        srgb <= _SRGB_LIN_THRESH,
        srgb / _SRGB_SLOPE,
        jnp.power(jnp.maximum((srgb + 0.055) / 1.055, 0.0), _SRGB_EXP),
    )


def rgb_to_srgb_jnp(rgb):
    """linear RGB -> sRGB (device). Same math as :func:`rgb_to_srgb`."""
    return jnp.where(
        rgb <= _LIN_SRGB_THRESH,
        rgb * _SRGB_SLOPE,
        jnp.power(jnp.maximum(1.055 * rgb, 0.0), 1.0 / _SRGB_EXP) - 0.055,
    )


# ---------------------------------------------------------------------------
# Host-side file IO (OpenCV byte semantics, as the reference)
# ---------------------------------------------------------------------------

def _cv2():
    """OpenCV if installed, else None (then PNG goes through utils/png)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imread(filename):
    """Read an image as uint8 BGR HWC; raise on failure (image_utils.py:52-57)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(filename)
    else:
        from . import png
        try:
            img = png.read(filename)
        except (OSError, ValueError, zlib.error):
            img = None
        else:
            img = (np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2
                   else np.ascontiguousarray(img[..., 2::-1]))
    if img is None:
        raise IOError("Input image not readable: {}".format(filename))
    return img


def write_u8(filename, image_u8):
    """Write a uint8 gray [H, W], BGR [H, W, 3] or BGRA [H, W, 4] image."""
    image_u8 = np.asarray(image_u8)
    cv2 = _cv2()
    if cv2 is not None:
        success = cv2.imwrite(filename, image_u8)
    else:
        from . import png
        if not filename.lower().endswith(".png"):
            raise IOError("without OpenCV only PNG can be written: "
                          "{}".format(filename))
        if image_u8.ndim == 3 and image_u8.shape[-1] in (3, 4):
            image_u8 = np.concatenate([image_u8[..., 2::-1],
                                       image_u8[..., 3:]], axis=-1)
        try:
            png.write(filename, image_u8)
            success = True
        except OSError:
            success = False
    if not success:
        raise IOError(
            "Not able to write {}, does the folder exist?".format(filename))


def imwrite(filename, image, sRGB=False):
    """Write an image, normalizing non-uint8 input first (image_utils.py:60-73).

    Float input: divide by the 99.9th percentile (interpolation='lower'),
    clip to [0,1], optionally sRGB-encode, scale by 255, truncate to uint8.
    """
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = normalize(image)
        if sRGB:
            image = rgb_to_srgb(image)
        image = (image * 255).astype(np.uint8)
    write_u8(filename, image)


def normalize(img):
    """Scale to [0,1] by the 99.9th percentile ('lower') if max > 1.

    Matches image_utils.py:84-92 including the interpolation='lower' choice
    (numpy>=2 spells it method='lower').
    """
    img = np.array(img, copy=True)
    if np.max(img) > 1:
        img = img / np.percentile(img, 99.9, method="lower")
        img = np.clip(img, 0, 1)
    return img


def colorize(intensity, image, eps=1e-3):
    """Reconstruct color reflectance/shading from scalar reflectance intensity.

    shading = mean_c(image) / intensity; reflectance = image / max(shading, eps).
    The caller decides the value range of ``image`` — the reference CLI passes
    raw uint8 BGR (decompose_with_trained_CNN.py:122, image_utils.py:76-81).
    """
    image = np.asarray(image)
    norm_input = np.mean(image, axis=2)
    shading = norm_input / intensity
    reflectance = image / np.maximum(shading, eps)[:, :, np.newaxis]
    return reflectance, shading


def colorize_jnp(intensity, image, eps=1e-3):
    """Device-side :func:`colorize` for the fused batched pipeline."""
    norm_input = jnp.mean(image, axis=-1)
    shading = norm_input / intensity
    reflectance = image / jnp.maximum(shading, eps)[..., None]
    return reflectance, shading


# ---------------------------------------------------------------------------
# Layout helpers (device arrays are NHWC; reference file formats are NCHW/BGR)
# ---------------------------------------------------------------------------

def bgr_uint8_to_linear_rgb(img_bgr_u8):
    """uint8 BGR HWC -> float32 linear RGB HWC in [0,1].

    Mirrors imgCV2_to_caffeBlob (decompose_with_trained_CNN.py:57-69) minus
    the NCHW transpose (device layout here is NHWC).  Computes in float32
    (gate-pinned); the predict/decompose family linearizes in float64 like
    the reference's numpy path — see rgb_uint8_to_linear.
    """
    img = img_bgr_u8[:, :, ::-1].astype(np.float32) / 255.0
    return srgb_to_rgb(img).astype(np.float32)


def rgb_uint8_to_linear(rgb_u8):
    """uint8 RGB HWC -> float32 linear RGB, computed in float64.

    The ONE linearization used by the predict/decompose family
    (train_with_barrista_helper.py:653-662 runs numpy default float64
    before the blob's float32 cast).  Deliberately distinct from
    bgr_uint8_to_linear_rgb's float32 compute (the inference-CLI parity
    anchor): keep each entry point on its gate-tested dtype.
    """
    return srgb_to_rgb(rgb_u8.astype(np.float64) / 255.0).astype(
        np.float32)


def nchw_to_nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def nhwc_to_nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))
