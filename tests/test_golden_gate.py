"""Hardened end-to-end parity gate (VERDICT r1 item 4).

Extends test_golden_pipeline.py's single smooth 96x128 image to a suite
of stressors, all driven through the *shipped CLI file paths* (uint8 PNG
in, uint8 PNG out):

  * natural-statistics image (1/f spectrum + hard-edged constant patches)
  * large image (512x768)
  * odd sizes (97x131, 45x67)
  * sigma/radius sweep incl. the README's published combos — bilateral
    c20 s22 (README.md:34), guided c3 s45 and c7 s52 (README.md:58,66)

Oracles: cv2.bilateralFilter (OpenCV itself, exact for joint==src) for
the bilateral; an integral-image float64 He-et-al. implementation for the
guided filter (cv2.ximgproc is absent from this image — the BORDER_REFLECT
/ f32-convert / rounding semantics are pinned in ops/guided.py's
docstring); float64 numpy forward off the caffemodel blobs for the CNN.

Gate: every uint8 output within 1 level of the oracle everywhere, small
flipped-pixel fraction, WHDR delta < 0.1% absolute.
"""
import os
import zlib

import numpy as np
import pytest

from reflectance_filtering.cli.decompose import decompose_image
from reflectance_filtering.cli.filter import read_filter_write
from reflectance_filtering.losses.bell import compute_whdr
from test_golden_pipeline import _oracle_cnn, _synthetic_judgments


# ---------------------------------------------------------------------------
# image generators
# ---------------------------------------------------------------------------

def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 80 * np.sin(xx / 20.0),
                    100 + 60 * np.cos(yy / 15.0),
                    90 + 50 * np.sin((xx + yy) / 25.0)], axis=-1)
    return np.clip(img + 15 * rng.rand(h, w, 3), 0, 255).astype(np.uint8)


def _natural(rng, h, w):
    """1/f ('pink') spectrum per channel — the classic natural-image
    statistic — plus hard-edged constant patches (piecewise-constant
    reflectance structure)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    chans = []
    for _ in range(3):
        phase = np.exp(2j * np.pi * rng.rand(h, w))
        img = np.real(np.fft.ifft2(phase / rad))
        img = (img - img.min()) / (img.max() - img.min() + 1e-12)
        chans.append(img)
    img = np.stack(chans, axis=-1)
    for _ in range(6):
        x0 = rng.randint(0, max(w - 8, 1))
        y0 = rng.randint(0, max(h - 8, 1))
        ww = rng.randint(4, max(w // 3, 5))
        hh = rng.randint(4, max(h // 3, 5))
        img[y0:y0 + hh, x0:x0 + ww] = rng.rand(3)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


IMAGES = {
    "smooth-96x128": lambda rng: _smooth(rng, 96, 128),
    "natural-128x160": lambda rng: _natural(rng, 128, 160),
    "odd-97x131": lambda rng: _natural(rng, 97, 131),
    "tiny-odd-45x67": lambda rng: _smooth(rng, 45, 67),
    "large-512x768": lambda rng: _natural(rng, 512, 768),
}


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """All test images written to disk + decomposed once through the CLI."""
    import cv2
    root = tmp_path_factory.mktemp("gate")
    out = {}
    for name, make in IMAGES.items():
        # crc32, not hash(): str hash is salted per interpreter, which
        # would make the gate images (and any failure) unreproducible
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        img = make(rng)
        path = str(root / (name + ".png"))
        cv2.imwrite(path, img)
        outdir = str(root / name)
        os.makedirs(outdir, exist_ok=True)
        decompose_image(path, outdir)
        rpath = os.path.join(outdir, name + "-r.png")
        out[name] = (path, img, rpath, outdir)
    return out


# ---------------------------------------------------------------------------
# fast float64 oracles (integral-image box; exact to f64 roundoff)
# ---------------------------------------------------------------------------

def _box64(x2d, radius):
    xp = np.pad(x2d.astype(np.float64), radius, mode="symmetric")
    c = np.pad(np.cumsum(np.cumsum(xp, 0), 1), ((1, 0), (1, 0)))
    w = 2 * radius + 1
    h_, w_ = x2d.shape
    s = (c[w:w + h_, w:w + w_] - c[:h_, w:w + w_] -
         c[w:w + h_, :w_] + c[:h_, :w_])
    return s / (w * w)


def _guided64(I, p, radius, eps):
    """He et al., color guide, float64, BORDER_REFLECT (ops/guided.py
    semantics), integral-image boxes."""
    I = I.astype(np.float64)
    p = p.astype(np.float64)
    mean_I = np.stack([_box64(I[:, :, k], radius) for k in range(3)], -1)
    out = np.zeros_like(p)
    var = np.zeros(I.shape[:2] + (3, 3))
    for i in range(3):
        for j in range(i, 3):
            v = (_box64(I[:, :, i] * I[:, :, j], radius) -
                 mean_I[:, :, i] * mean_I[:, :, j])
            var[:, :, i, j] = var[:, :, j, i] = v
        var[:, :, i, i] += eps
    for c in range(p.shape[2]):
        pc = p[:, :, c]
        mean_p = _box64(pc, radius)
        cov = np.stack([_box64(I[:, :, k] * pc, radius) -
                        mean_I[:, :, k] * mean_p for k in range(3)], -1)
        a = np.linalg.solve(var, cov[..., None])[..., 0]
        b = mean_p - np.sum(a * mean_I, axis=-1)
        mean_a = np.stack([_box64(a[:, :, k], radius) for k in range(3)], -1)
        out[:, :, c] = np.sum(mean_a * I, axis=-1) + _box64(b, radius)
    return out


# ---------------------------------------------------------------------------
# CNN -r.png parity on every image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(IMAGES))
def test_cnn_r_map_parity(gallery, name):
    import cv2
    path, img, rpath, _ = gallery[name]
    got = cv2.imread(rpath, cv2.IMREAD_UNCHANGED)
    if got.ndim == 3:
        got = got[..., 0]
    exp = (_oracle_cnn(img) * 255).astype(np.uint8)  # sigmoid<1: no norm
    diff = np.abs(got.astype(int) - exp.astype(int))
    assert diff.max() <= 1, (name, diff.max())
    assert (diff > 0).mean() < 0.005, (name, (diff > 0).mean())


# ---------------------------------------------------------------------------
# bilateral sweep vs real OpenCV (joint == src)
# ---------------------------------------------------------------------------

BF_CASES = [
    ("smooth-96x128", 20.0, 22.0),     # the README's published combo
    ("natural-128x160", 20.0, 22.0),
    ("odd-97x131", 20.0, 22.0),
    ("tiny-odd-45x67", 20.0, 22.0),
    ("natural-128x160", 10.0, 8.0),    # radius 12
    ("odd-97x131", 35.0, 4.0),         # radius 6
]


@pytest.mark.parametrize("name,sc,ss", BF_CASES)
def test_bilateral_cli_sweep_vs_opencv(gallery, name, sc, ss, rng):
    import cv2
    _, _, rpath, outdir = gallery[name]
    ours = read_filter_write("bilateral", rpath, rpath, sc, ss, outdir)
    ref = cv2.bilateralFilter(cv2.imread(rpath), -1, sc, ss)

    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (name, sc, ss, diff.max())
    assert (diff > 0).mean() < 0.02, (name, sc, ss, (diff > 0).mean())

    judg = _synthetic_judgments(rng)
    d = abs(compute_whdr(ours[:, :, ::-1] / 255.0, judg) -
            compute_whdr(ref[:, :, ::-1] / 255.0, judg))
    assert d < 0.001, (name, sc, ss, d)  # 0.1% absolute


# ---------------------------------------------------------------------------
# guided sweep vs float64 oracle (incl. large image + published combos)
# ---------------------------------------------------------------------------

GF_CASES = [
    ("smooth-96x128", 3.0, 45.0),      # README.md:58 combo (r=45, eps=3)
    ("natural-128x160", 3.0, 45.0),
    ("odd-97x131", 7.0, 52.0),         # README.md:66 combo (r=52, eps=7)
    ("tiny-odd-45x67", 3.0, 8.0),
    ("large-512x768", 3.0, 45.0),
    ("large-512x768", 7.0, 52.0),
]


@pytest.mark.parametrize("name,sc,ss", GF_CASES)
def test_guided_cli_sweep_vs_float64(gallery, name, sc, ss, rng):
    import cv2
    path, _, rpath, outdir = gallery[name]
    ours = read_filter_write("guided", rpath, path, sc, ss, outdir)

    guide = cv2.imread(path)
    src = cv2.imread(rpath)
    exp = _guided64(guide, src, int(ss), sc)
    exp_u8 = np.clip(np.rint(exp), 0, 255).astype(np.uint8)

    diff = np.abs(ours.astype(int) - exp_u8.astype(int))
    assert diff.max() <= 1, (name, sc, ss, diff.max())
    assert (diff > 0).mean() < 0.02, (name, sc, ss, (diff > 0).mean())

    judg = _synthetic_judgments(rng)
    d = abs(compute_whdr(ours[:, :, ::-1] / 255.0, judg) -
            compute_whdr(exp_u8[:, :, ::-1] / 255.0, judg))
    assert d < 0.001, (name, sc, ss, d)


BF_COLOR_SELF_CASES = [
    ("tiny-odd-45x67", 20.0, 22.0),
    ("natural-128x160", 30.0, 8.0),
]


@pytest.mark.parametrize("name,sc,ss", BF_COLOR_SELF_CASES)
def test_bilateral_color_self_cli_vs_opencv(gallery, name, sc, ss, rng):
    """The CLI filtering a COLOR image by itself == cv2.bilateralFilter
    (the exact OpenCV oracle for joint==src)."""
    import cv2
    path, img, _, outdir = gallery[name]
    ours = read_filter_write("bilateral", path, path, sc, ss, outdir)
    ref = cv2.bilateralFilter(img, -1, sc, ss)

    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (name, sc, ss, diff.max())
    assert (diff > 0).mean() < 0.02, (name, sc, ss, (diff > 0).mean())

    judg = _synthetic_judgments(rng)
    d = abs(compute_whdr(ours[:, :, ::-1] / 255.0, judg) -
            compute_whdr(ref[:, :, ::-1] / 255.0, judg))
    assert d < 0.001, (name, sc, ss, d)
