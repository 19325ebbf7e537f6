"""Guided filter (He et al. 2013) with OpenCV ximgproc-compatible semantics.

Replaces native component N4 (cv2.ximgproc.guidedFilter, SURVEY.md §2.3),
invoked by the reference as
``guidedFilter(guide=joint, src=image, radius=int(sigma_spatial),
eps=sigma_color)`` on uint8 0-255 images (filter_reflectance.py:67-70) —
eps is therefore in (0-255)^2 units and NOT rescaled, matching OpenCV.

Algorithm (color guide I, per-channel src p):
    mean_I   = box(I)                  (3)
    mean_p   = box(p)
    cov_Ip   = box(I*p)   - mean_I*mean_p          (3)
    var_I    = box(I⊗I)   - mean_I⊗mean_I + eps·Id (3x3 symmetric)
    a        = var_I^{-1} cov_Ip                    (3)
    b        = mean_p - a·mean_I
    q        = box(a)·I + box(b)

Gray guide degenerates to the scalar formulas.  The 3x3 solve is an
explicit symmetric cofactor inverse — branch-free elementwise math that
XLA fuses; the whole filter is ~15 box filters, all O(1)/pixel.  There is
no hand-written kernel: on the GPU the block-local cumsum box filters
(ops/boxfilter.py) and the elementwise solve are plain XLA fusions.

Semantics derivation vs opencv_contrib's ximgproc/src/guided_filter.cpp
(pinned per VERDICT r1; ximgproc is absent from this environment, so the
behavior is reproduced from the source):
  * GuidedFilterImpl converts guide and src to CV_32F up front
    (convertToWorkType) — integer inputs are filtered in float, matching
    our float32 path on uint8 0-255 values;
  * every mean is ``boxFilter(src, dst, CV_32F, Size(2r+1, 2r+1),
    Point(-1,-1), true, BORDER_REFLECT)`` — normalized window, and the
    border mode is explicitly BORDER_REFLECT (symmetric: ``b a | a b``),
    NOT the OpenCV default BORDER_REFLECT_101.  Hence _BORDER='reflect'
    here;
  * the color-guide system is solved by explicit symmetric 3x3 inverse
    (calcDet + the adjugate), same closed form as _guided_filter_color;
  * output conversion back to the src depth uses Mat::convertTo, i.e.
    saturate_cast(round-half-to-even on x86 via cvRound) — we use rint
    (also half-to-even), validated against independent float64 oracles in
    tests/test_filters.py and tests/test_golden_gate.py (incl. the
    README's published c3 s45 and c7 s52 combos on 512x768 inputs), and
    WHDR-level parity is gated in the pipeline tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .boxfilter import box_filter

_BORDER = "reflect"


def _box(x, radius):
    return box_filter(x, radius, border=_BORDER)


def _guided_filter_color(I, p, radius: int, eps: float):
    """Color (3-channel) guide; p is [..., H, W, C_src]."""
    mean_I = _box(I, radius)                               # [...,H,W,3]
    mean_p = _box(p, radius)                               # [...,H,W,Cs]

    # covariance of guide with src, per src channel: [...,H,W,3,Cs]
    Ip = I[..., :, None] * p[..., None, :]
    cov_Ip = _box(Ip.reshape(Ip.shape[:-2] + (-1,)), radius).reshape(Ip.shape)
    cov_Ip = cov_Ip - mean_I[..., :, None] * mean_p[..., None, :]

    # symmetric 3x3 variance of the guide (+ eps on the diagonal)
    II = I[..., :, None] * I[..., None, :]                  # [...,H,W,3,3]
    var_I = _box(II.reshape(II.shape[:-2] + (-1,)), radius).reshape(II.shape)
    var_I = var_I - mean_I[..., :, None] * mean_I[..., None, :]

    rr = var_I[..., 0, 0] + eps
    rg = var_I[..., 0, 1]
    rb = var_I[..., 0, 2]
    gg = var_I[..., 1, 1] + eps
    gb = var_I[..., 1, 2]
    bb = var_I[..., 2, 2] + eps

    # cofactors of the symmetric matrix
    c00 = gg * bb - gb * gb
    c01 = gb * rb - rg * bb
    c02 = rg * gb - gg * rb
    c11 = rr * bb - rb * rb
    c12 = rb * rg - rr * gb
    c22 = rr * gg - rg * rg
    det = rr * c00 + rg * c01 + rb * c02
    inv_det = 1.0 / det

    # a = var^{-1} cov, per src channel
    a0 = (c00[..., None] * cov_Ip[..., 0, :] +
          c01[..., None] * cov_Ip[..., 1, :] +
          c02[..., None] * cov_Ip[..., 2, :]) * inv_det[..., None]
    a1 = (c01[..., None] * cov_Ip[..., 0, :] +
          c11[..., None] * cov_Ip[..., 1, :] +
          c12[..., None] * cov_Ip[..., 2, :]) * inv_det[..., None]
    a2 = (c02[..., None] * cov_Ip[..., 0, :] +
          c12[..., None] * cov_Ip[..., 1, :] +
          c22[..., None] * cov_Ip[..., 2, :]) * inv_det[..., None]
    a = jnp.stack([a0, a1, a2], axis=-2)                    # [...,H,W,3,Cs]

    b = mean_p - jnp.sum(a * mean_I[..., :, None], axis=-2)  # [...,H,W,Cs]

    mean_a = _box(a.reshape(a.shape[:-2] + (-1,)), radius).reshape(a.shape)
    mean_b = _box(b, radius)
    q = jnp.sum(mean_a * I[..., :, None], axis=-2) + mean_b
    return q


def _box_stack(x, radius):
    """Box filter over H, W of every plane of [N, K, H, W]."""
    n, k, h, w = x.shape
    return box_filter(x.reshape(n * k, h, w, 1), radius,
                      border=_BORDER).reshape(x.shape)


_PAIRS = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _planar_coefficients(I, p, radius: int, eps):
    """Box means of the guided filter's coefficients, channels-planar.

    I: [N, 3, H, W]; p: [N, C, H, W] -> [N, 4C, H, W] holding box(a0),
    box(a1), box(a2), box(b) (C planes each).  All box filters run on
    plane stacks: one pass over the moment planes
    [I(3) | p(C) | I*p(3C) | unique(I x I)(6)], one over the coefficient
    planes.  Same math as :func:`_guided_filter_color`."""
    n, _, h, wid = I.shape
    c = p.shape[1]
    Ip = (I[:, :, None] * p[:, None]).reshape(n, 3 * c, h, wid)
    II = jnp.stack([I[:, a] * I[:, b] for a, b in _PAIRS], axis=1)
    moments = _box_stack(jnp.concatenate([I, p, Ip, II], axis=1), radius)
    mean_I = moments[:, 0:3]
    mean_p = moments[:, 3:3 + c]
    cov_Ip = moments[:, 3 + c:3 + c + 3 * c].reshape(n, 3, c, h, wid)
    cov_Ip = cov_Ip - mean_I[:, :, None] * mean_p[:, None]
    m = moments[:, 3 + c + 3 * c:]

    rr = m[:, 0] - mean_I[:, 0] * mean_I[:, 0] + eps
    rg = m[:, 1] - mean_I[:, 0] * mean_I[:, 1]
    rb = m[:, 2] - mean_I[:, 0] * mean_I[:, 2]
    gg = m[:, 3] - mean_I[:, 1] * mean_I[:, 1] + eps
    gb = m[:, 4] - mean_I[:, 1] * mean_I[:, 2]
    bb = m[:, 5] - mean_I[:, 2] * mean_I[:, 2] + eps

    c00 = gg * bb - gb * gb
    c01 = gb * rb - rg * bb
    c02 = rg * gb - gg * rb
    c11 = rr * bb - rb * rb
    c12 = rb * rg - rr * gb
    c22 = rr * gg - rg * rg
    inv_det = 1.0 / (rr * c00 + rg * c01 + rb * c02)

    cov0, cov1, cov2 = cov_Ip[:, 0], cov_Ip[:, 1], cov_Ip[:, 2]  # [N,C,H,W]
    a0 = (c00[:, None] * cov0 + c01[:, None] * cov1 +
          c02[:, None] * cov2) * inv_det[:, None]
    a1 = (c01[:, None] * cov0 + c11[:, None] * cov1 +
          c12[:, None] * cov2) * inv_det[:, None]
    a2 = (c02[:, None] * cov0 + c12[:, None] * cov1 +
          c22[:, None] * cov2) * inv_det[:, None]

    b = mean_p - (a0 * mean_I[:, 0:1] + a1 * mean_I[:, 1:2] +
                  a2 * mean_I[:, 2:3])                      # [N,C,H,W]
    return _box_stack(jnp.concatenate([a0, a1, a2, b], axis=1), radius)


def _apply_coefficients(means, I):
    """q = box(a) . I + box(b) from :func:`_planar_coefficients`' output."""
    c = means.shape[1] // 4
    return (means[:, :c] * I[:, 0:1] + means[:, c:2 * c] * I[:, 1:2]
            + means[:, 2 * c:3 * c] * I[:, 2:3] + means[:, 3 * c:])


def _guided_filter_gray(I, p, radius: int, eps: float):
    """Scalar guide; I is [..., H, W], p is [..., H, W, C_src].

    Internally channelized ([..., H, W, 1]) so the box filter sees spatial
    axes in the same positions for batched and unbatched input.
    """
    Ic = I[..., None]
    mean_I = _box(Ic, radius)
    mean_p = _box(p, radius)
    corr_Ip = _box(Ic * p, radius)
    corr_II = _box(Ic * Ic, radius)
    var_I = corr_II - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return _box(a, radius) * Ic + _box(b, radius)


@functools.partial(jax.jit, static_argnames=("radius",))
def guided_filter_planar(guide, src, radius: int, eps):
    """Planar guided filter: guide [N,3,H,W], src [N,C,H,W] float32 ->
    [N,C,H,W] (the 3x GF chain's and the GF pipeline's layout)."""
    guide = guide.astype(jnp.float32)
    eps = jnp.asarray(eps, jnp.float32)
    means = _planar_coefficients(guide, src.astype(jnp.float32), radius, eps)
    return _apply_coefficients(means, guide)


@functools.partial(jax.jit, static_argnames=("radius", "batched"))
def guided_filter(guide, src, radius: int, eps, batched: bool = False):
    """Guided filter on float arrays in guide-value units (0-255 for the
    reference pipeline).

    Unbatched: guide [H,W,3] (color) or [H,W] (gray); src [H,W,C] or [H,W].
    Batched (batched=True): guide [N,H,W,3] or [N,H,W]; src [N,H,W,C] or
    [N,H,W].  Native batching — the box filters run on the whole batch in
    one pass, far faster than vmap-ing the unbatched path.
    """
    eps = jnp.asarray(eps, jnp.float32)
    spatial_nd = 3 if batched else 2
    squeeze = src.ndim == spatial_nd
    if squeeze:
        src = src[..., None]
    guide = guide.astype(jnp.float32)
    src = src.astype(jnp.float32)
    if guide.ndim == spatial_nd + 1 and guide.shape[-1] == 3:
        q = _guided_filter_color(guide, src, radius, eps)
    elif guide.ndim == spatial_nd:
        q = _guided_filter_gray(guide, src, radius, eps)
    else:
        raise ValueError("guide shape {} invalid (batched={})".format(
            guide.shape, batched))
    return q[..., 0] if squeeze else q


def guided_filter_iterated(guide, src, radius: int, eps,
                           iterations: int = 3, planar: bool = False):
    """Repeatedly guided-filter ``src`` against the same guide — the
    Zoran-style '3x iterated GF' chain of BASELINE.json config 4
    (reference README.md:88).  planar=True takes/returns [N,C,H,W]."""
    out = src
    for _ in range(iterations):
        if planar:
            out = guided_filter_planar(guide, out, radius, eps)
        else:
            out = guided_filter(guide, out, radius, eps,
                                batched=(jnp.ndim(src) == 4))
    return out


def fast_guided_filter(guide, src, radius: int, eps, subsample: int = 4):
    """Fast Guided Filter (He & Sun 2015, arXiv:1505.00996): compute the
    a,b coefficient fields at 1/s resolution and joint-upsample them —
    O(1/s^2) of the exact filter's cost with near-identical output on
    natural images.

    OPTIONAL speed mode beyond the reference's capability surface (the
    exact filter is the parity path).  guide [N,3,H,W], src [N,C,H,W]
    planar float32; subsample=1 degenerates to the exact filter.
    """
    if subsample <= 1:
        return guided_filter_planar(guide, src, radius, eps)
    h, wid = guide.shape[2:]
    hs, ws = max(1, h // subsample), max(1, wid // subsample)
    rs = max(1, int(round(radius / subsample)))

    def down(x):
        return jax.image.resize(x.astype(jnp.float32),
                                x.shape[:2] + (hs, ws), "bilinear")

    # low-res exact filter, but keep box(a), box(b) instead of q
    means = _planar_coefficients(down(guide), down(src), rs, eps)
    up = jax.image.resize(means, means.shape[:2] + (h, wid), "bilinear")
    return _apply_coefficients(up, guide.astype(jnp.float32))


def fast_guided_filter_u8(guide_u8, src_u8, radius: int, eps,
                          subsample: int = 4) -> np.ndarray:
    """uint8 wrapper for :func:`fast_guided_filter` — the CLI's opt-in
    approximate speed mode (``--subsample`` on filter_type=guided).

    Gray guides are replicated to 3 channels (the planar path takes
    colour guides only); for a 2-D gray guide this differs from the
    exact filter's scalar formulas, but the CNN's decoded -r.png is
    already 3 identical channels, so that product case is unchanged."""
    guide_u8 = np.asarray(guide_u8)
    src_u8 = np.asarray(src_u8)
    if subsample <= 1:
        return guided_filter_u8(guide_u8, src_u8, radius, eps)
    g = guide_u8 if guide_u8.ndim == 3 else np.repeat(
        guide_u8[..., None], 3, axis=-1)
    gp = jnp.asarray(np.moveaxis(g, -1, 0)[None].astype(np.float32))
    sa = (np.moveaxis(src_u8, -1, 0) if src_u8.ndim == 3
          else src_u8[None])[None]
    mono = bool((sa[:, :1] == sa).all())
    sp = jnp.asarray((sa[:, :1] if mono else sa).astype(np.float32))
    q = np.asarray(fast_guided_filter(gp, sp, radius, float(eps),
                                      subsample))
    if mono:
        q = np.broadcast_to(q, sa.shape)
    q = np.moveaxis(q[0], 0, -1)
    if src_u8.ndim == 2:
        q = q[..., 0]
    return np.clip(np.rint(q), 0, 255).astype(np.uint8)


def guided_filter_u8(guide_u8, src_u8, radius: int, eps) -> np.ndarray:
    """uint8 wrapper with OpenCV rounding: float math, rint, clip to 0-255."""
    q = np.asarray(guided_filter(jnp.asarray(guide_u8),
                                 jnp.asarray(src_u8), radius, eps))
    return np.clip(np.rint(q), 0, 255).astype(np.uint8)
