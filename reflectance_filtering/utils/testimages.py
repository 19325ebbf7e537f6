"""Shared synthetic-workload generators for the parity gate, benchmarks
and tests, and the float64 numpy oracles they score against.

These define the *image classes* and the *packed IIW-style comparison
blob* the framework's fidelity gates score against; keeping one
definition ensures the on-chip gate (bench.py), the regression tests and
the measurement scripts all exercise the same workload (a silent
divergence here would mean the gate and the tests stop testing the same
thing).
"""
from __future__ import annotations

import numpy as np


def pink_noise(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """1/f 'pink' noise — the natural-image power spectrum: random phase
    over a 1/f amplitude spectrum, span-normalized and floored to uint8
    levels.  Returns float64 values in {0..255} (callers cast).

    The closest acquirable stand-in for real photos in this environment
    (no dataset images ship with the repo); used in the grid quality set
    and the bench parity gallery."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    img = np.real(np.fft.ifft2(np.exp(2j * np.pi * rng.rand(h, w)) / rad))
    return np.floor((img - img.min()) / (img.max() - img.min() + 1e-12)
                    * 255.0)


def make_synthetic_comps(seed: int, k: int, batch: int = None) -> np.ndarray:
    """Deterministic packed IIW-style comparison blob [K+1, 6] (or
    [B, K+1, 6] with ``batch``): rows [x1, y1, x2, y2, darker, weight]
    in normalized coordinates, darker in {0,1,2}, random weights, and
    the metadata last row [num_comparisons, 1.0, 0, nan...] — the
    builder contract of data/builder.py (reference
    createNumpyArrayWithComparisonsForIIW.py:616-649)."""
    rr = np.random.RandomState(seed)
    b = 1 if batch is None else batch
    c = np.full((b, k + 1, 6), np.nan, np.float32)
    c[:, :k, :4] = rr.rand(b, k, 4)
    c[:, :k, 4] = rr.randint(0, 3, (b, k))
    c[:, :k, 5] = rr.rand(b, k)
    c[:, k, 0] = k
    c[:, k, 1] = 1.0
    c[:, k, 2] = 0
    return c[0] if batch is None else c


def flagship_forward64(raw, img_bgr_u8: np.ndarray) -> np.ndarray:
    """float64 numpy forward of the flagship CNN straight off the
    caffemodel blobs (``caffe_io.parse_caffemodel``'s dict): uint8 BGR
    [..., H, W, 3] -> reflectance intensity [..., H, W]."""
    x = img_bgr_u8[..., ::-1].astype(np.float64) / 255.0
    x = np.where(x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4))
    skips = []
    for i in range(5):
        x = np.maximum(x @ raw["conv%d" % i][0][:, :, 0, 0].T
                       + raw["conv%d" % i][1].reshape(-1), 0.0)
        skips.append(x)
    pre = (np.concatenate(skips, axis=-1)
           @ raw["fuse_skip_layers"][0][:, :, 0, 0].T
           + raw["fuse_skip_layers"][1].reshape(-1))
    return (1.0 / (1.0 + np.exp(-pre)))[..., 0]


def box64(x: np.ndarray, r: int) -> np.ndarray:
    """Normalized (2r+1)^2 box over the first two axes, BORDER_REFLECT,
    as float64 integral images."""
    n = 2 * r + 1
    p = np.pad(x, ((r, r), (r, r)) + ((0, 0),) * (x.ndim - 2),
               mode="symmetric")
    c = np.pad(np.cumsum(np.cumsum(p, 0), 1),
               ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))
    return (c[n:, n:] - c[:-n, n:] - c[n:, :-n] + c[:-n, :-n]) / (n * n)


def guided_filter64(guide: np.ndarray, src: np.ndarray, r: int,
                    eps: float) -> np.ndarray:
    """He et al.'s colour-guide filter in float64 (OpenCV's
    BORDER_REFLECT box means): guide [H, W, 3], src [H, W] -> [H, W]."""
    guide = guide.astype(np.float64)
    src = src.astype(np.float64)
    mi, mp = box64(guide, r), box64(src, r)
    cov = box64(guide * src[..., None], r) - mi * mp[..., None]
    var = (box64(guide[..., :, None] * guide[..., None, :], r)
           - mi[..., :, None] * mi[..., None, :] + eps * np.eye(3))
    a = np.linalg.solve(var, cov[..., None])[..., 0]
    b = mp - np.sum(a * mi, axis=-1)
    return np.sum(box64(a, r) * guide, axis=-1) + box64(b, r)
