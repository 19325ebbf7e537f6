"""Joint bilateral filter with OpenCV-compatible semantics.

Replaces native component N3 (cv2.ximgproc.jointBilateralFilter, SURVEY.md
§2.3), invoked by the reference as ``jointBilateralFilter(joint, image,
d=-1, sigmaColor, sigmaSpace)`` on uint8 images (filter_reflectance.py:60-64).

OpenCV semantics reproduced exactly (validated against cv2.bilateralFilter,
which is the same algorithm with joint == src):

  * sigma_color/sigma_space <= 0 are clamped to 1.
  * d <= 0  =>  radius = round(1.5 * sigma_space); radius = max(radius, 1);
    window is the *disk* of taps with sqrt(dx^2+dy^2) <= radius.
  * spatial weight  exp(-(dx^2+dy^2) / (2 sigma_space^2))
  * range weight    exp(-(sum_c |J_c(q)-J_c(p)|)^2 / (2 sigma_color^2)),
    computed on the *joint* (guidance) image values.
  * border BORDER_REFLECT_101; float32 accumulation; round-to-nearest-even
    on the uint8 output (cvRound).

Implementation: :func:`joint_bilateral_filter` is the plain reference, a
`lax.scan` over the tap list in which each step slices the reflect-padded
joint/src at a (dy, dx) offset and updates whole-image accumulators.  It
is the test oracle and the CPU path.  On the GPU the product path runs
one Pallas kernel on the Triton route (ops/bilateral_triton.py) that
keeps a tile's accumulators on chip; :func:`bilateral_planar` is the one
dispatch point between the two.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .backend import use_kernels


def opencv_bilateral_params(d: int, sigma_color: float, sigma_space: float
                            ) -> Tuple[int, float, float, np.ndarray]:
    """Replicate OpenCV's parameter preprocessing.

    Returns (radius, gauss_color_coeff, gauss_space_coeff,
    taps[[dy, dx, space_weight], ...]) with the disk mask applied in
    OpenCV's tap order (row-major over the square, skipping r > radius).
    """
    if sigma_color <= 0:
        sigma_color = 1.0
    if sigma_space <= 0:
        sigma_space = 1.0
    gauss_color_coeff = -0.5 / (sigma_color * sigma_color)
    gauss_space_coeff = -0.5 / (sigma_space * sigma_space)
    if d <= 0:
        radius = int(round(sigma_space * 1.5))
    else:
        radius = d // 2
    radius = max(radius, 1)

    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(i * i + j * j)
            if r > radius:
                continue
            w = math.exp((i * i + j * j) * gauss_space_coeff)
            taps.append((i, j, w))
    return radius, gauss_color_coeff, gauss_space_coeff, np.asarray(
        taps, dtype=np.float64)


@functools.partial(jax.jit, static_argnames=("radius", "h", "w"))
def _jbf_scan(joint_pad, src_pad, joint_center, tap_offsets, tap_weights,
              gauss_color_coeff, radius: int, h: int, w: int):
    """Scan over taps.  joint_pad/src_pad: [H+2r, W+2r, C] float32;
    joint_center: [H, W, C]."""

    def step(carry, tap):
        acc, wsum = carry
        off, sw = tap
        dy, dx = off[0], off[1]
        js = jax.lax.dynamic_slice(
            joint_pad, (dy, dx, 0), (h, w, joint_pad.shape[2]))
        ss = jax.lax.dynamic_slice(
            src_pad, (dy, dx, 0), (h, w, src_pad.shape[2]))
        diff = jnp.sum(jnp.abs(js - joint_center), axis=-1)
        wgt = sw * jnp.exp(diff * diff * gauss_color_coeff)
        return (acc + wgt[..., None] * ss, wsum + wgt), None

    acc0 = jnp.zeros_like(src_pad, shape=(h, w, src_pad.shape[2]))
    wsum0 = jnp.zeros((h, w), jnp.float32)
    (acc, wsum), _ = jax.lax.scan(
        step, (acc0, wsum0), (tap_offsets, tap_weights))
    return acc / wsum[..., None]


def joint_bilateral_filter(joint, src, d: int = -1,
                           sigma_color: float = 20.0,
                           sigma_space: float = 22.0):
    """Float joint bilateral filter.

    joint: [H,W,C_j] or [H,W]; src: [H,W,C] or [H,W]; values in the units
    sigma_color refers to (0-255 for the reference pipeline).  Returns
    float32 of src's shape.
    """
    joint = jnp.asarray(joint, jnp.float32)
    src = jnp.asarray(src, jnp.float32)
    squeeze = src.ndim == 2
    if joint.ndim == 2:
        joint = joint[..., None]
    if src.ndim == 2:
        src = src[..., None]
    h, w = src.shape[:2]

    radius, gcc, _gsc, taps = opencv_bilateral_params(
        d, sigma_color, sigma_space)

    pad = [(radius, radius), (radius, radius), (0, 0)]
    joint_pad = jnp.pad(joint, pad, mode="reflect")  # BORDER_REFLECT_101
    src_pad = jnp.pad(src, pad, mode="reflect")

    tap_offsets = jnp.asarray(taps[:, :2].astype(np.int32) + radius)
    tap_weights = jnp.asarray(taps[:, 2].astype(np.float32))

    out = _jbf_scan(joint_pad, src_pad, joint, tap_offsets, tap_weights,
                    jnp.float32(gcc), radius, h, w)
    return out[..., 0] if squeeze else out


def _bilateral_planar_reference(joint, src, d, sigma_color, sigma_space,
                                joint_reps):
    joint = jnp.repeat(jnp.moveaxis(joint, 1, -1), joint_reps, axis=-1)
    src = joint if src is None else jnp.moveaxis(src, 1, -1)
    out = jax.vmap(lambda j, s: joint_bilateral_filter(
        j, s, d, sigma_color, sigma_space))(joint, src)
    if src is joint and joint_reps > 1:
        out = out[..., ::joint_reps]
    return jnp.moveaxis(out, -1, 1)


def bilateral_planar(joint, src=None, d: int = -1,
                     sigma_color: float = 20.0, sigma_space: float = 22.0,
                     joint_reps: int = 1):
    """Joint bilateral filter on planar stacks — the product dispatch.

    joint: [N, Cj, H, W] with Cj in {1, 3}; src: [N, Cs, H, W] with Cs in
    {1, 3}, or None to filter ``joint`` by itself.  ``joint_reps`` is the
    number of identical channels a single joint plane stands for (cv2
    sums |delta| over channels, so a gray image stored as 3 channels
    weighs 3|delta|).  Returns float32 [N, Cs, H, W] (Cs = Cj when src is
    None).  GPU: the Triton kernel; CPU: the plain reference."""
    joint = jnp.asarray(joint, jnp.float32)
    if src is not None:
        src = jnp.asarray(src, jnp.float32)
    if use_kernels():
        from .bilateral_triton import bilateral_triton
        return bilateral_triton(joint, src, d, sigma_color, sigma_space,
                                joint_reps=joint_reps)
    return _bilateral_planar_reference(joint, src, d, sigma_color,
                                       sigma_space, joint_reps)


def _mono(x: np.ndarray) -> bool:
    """A [H, W] plane, or [H, W, C] whose channels are all equal."""
    return x.ndim == 2 or bool((x[..., :1] == x).all())


def _planar(x: np.ndarray, mono: bool) -> np.ndarray:
    """[H, W] / [H, W, C] uint8 -> [1, C', H, W] float32 (C' = 1 if mono)."""
    if x.ndim == 2:
        x = x[..., None]
    if mono:
        x = x[..., :1]
    return np.moveaxis(x.astype(np.float32), -1, 0)[None]


def joint_bilateral_filter_u8(joint_u8, src_u8, d: int = -1,
                              sigma_color: float = 20.0,
                              sigma_space: float = 22.0) -> np.ndarray:
    """uint8 wrapper with cvRound (round-half-to-even) output — the filter
    CLI's path.

    Images whose channels are all equal (the CNN's decoded -r.png) are
    filtered as one plane: a mono joint enters the kernel with
    ``joint_reps`` = its channel count, a mono src is filtered once and
    replicated.  joint == src filters the image by itself."""
    j = np.asarray(joint_u8)
    s = np.asarray(src_u8)
    self_joint = j is s or (j.shape == s.shape and np.array_equal(j, s))
    j_mono = _mono(j)
    s_mono = _mono(s)
    j_reps = j.shape[-1] if (j.ndim == 3 and j_mono) else 1
    jp = _planar(j, j_mono)
    if self_joint:
        out = bilateral_planar(jp, None, d, sigma_color, sigma_space,
                               joint_reps=j_reps)
    else:
        out = bilateral_planar(jp, _planar(s, s_mono), d, sigma_color,
                               sigma_space, joint_reps=j_reps)
    out = np.moveaxis(np.asarray(out)[0], 0, -1)
    if s.ndim == 2:
        out = out[..., 0]
    elif out.shape[-1] != s.shape[-1]:
        out = np.repeat(out, s.shape[-1], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
