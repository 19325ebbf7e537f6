"""End-to-end parity gate: the framework's pipelines vs host oracles.

The BASELINE gate is 'bitwise-close reflectance maps, WHDR within 0.1%
absolute of the reference Caffe+OpenCV path'.  Without caffe/ximgproc in
this image, the oracle chain is:

  CNN       : numpy float64 forward straight off the caffemodel blobs
  bilateral : cv2.bilateralFilter (OpenCV itself; exact for joint==src)
  WHDR      : the loop-based Bell math (tests/test_whdr.py oracles)

These tests run the *shipped CLI paths* (uint8 files on disk in, uint8
files out) and assert the uint8 maps and WHDR deltas stay inside the gate.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from reflectance_filtering.cli.decompose import (
    ReflectanceCNN, decompose_image)
from reflectance_filtering.cli.filter import read_filter_write
from reflectance_filtering.losses.bell import compute_whdr
from reflectance_filtering.losses.whdr import whdr
from reflectance_filtering.models import caffe_io
from reflectance_filtering.utils import image as iu


def _oracle_cnn(img_bgr_u8):
    raw = caffe_io.parse_caffemodel(caffe_io.DEFAULT_CAFFEMODEL)
    x = img_bgr_u8[:, :, ::-1].astype(np.float64) / 255.0
    x = np.where(x <= 0.04045, x / 12.92,
                 np.power((x + 0.055) / 1.055, 2.4))
    skips = []
    for i in range(5):
        w = raw["conv%d" % i][0][:, :, 0, 0]
        b = raw["conv%d" % i][1].reshape(-1)
        x = np.maximum(x @ w.T + b, 0.0)
        skips.append(x)
    cat = np.concatenate(skips, axis=-1)
    wf = raw["fuse_skip_layers"][0][:, :, 0, 0]
    bf = raw["fuse_skip_layers"][1].reshape(-1)
    return (1.0 / (1.0 + np.exp(-(cat @ wf.T + bf))))[..., 0]


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    import cv2
    rng = np.random.RandomState(7)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 80 * np.sin(xx / 20.0),
                    100 + 60 * np.cos(yy / 15.0),
                    90 + 50 * np.sin((xx + yy) / 25.0)], axis=-1)
    img = np.clip(img + 15 * rng.rand(h, w, 3), 0, 255).astype(np.uint8)
    cv2.circle(img, (40, 40), 18, (200, 40, 40), -1)
    path = str(tmp_path_factory.mktemp("golden") / "photo.png")
    cv2.imwrite(path, img)
    return path, img


def _synthetic_judgments(rng, n=60):
    points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
               "opaque": True} for i in range(16)]
    comps = []
    for _ in range(n):
        a, b = rng.choice(16, 2, replace=False)
        comps.append({"point1": int(a), "point2": int(b),
                      "darker": str(rng.choice(["1", "2", "E"])),
                      "darker_score": float(rng.rand() + 0.1)})
    return {"intrinsic_points": points, "intrinsic_comparisons": comps}


def test_cnn_r_map_bitwise_close(photo, tmp_path):
    """Written -r.png vs the float64 oracle through identical imwrite
    quirks: <=1 uint8 level everywhere, mismatches on <0.5% of pixels."""
    import cv2
    path, img = photo
    decompose_image(path, str(tmp_path))
    got = cv2.imread(str(tmp_path / "photo-r.png"), cv2.IMREAD_UNCHANGED)
    if got.ndim == 3:
        got = got[..., 0]
    refl = _oracle_cnn(img)
    exp = (iu.normalize(refl) * 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - exp.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.005


def test_bf_cnn_cnn_pipeline_matches_cv2(photo, tmp_path, rng):
    """Full BF(CNN,CNN): our filter CLI output vs cv2.bilateralFilter on
    the same -r.png.  Gate: <=1 level, <2% mismatch, WHDR delta < 0.1%."""
    import cv2
    path, img = photo
    decompose_image(path, str(tmp_path))
    rpath = str(tmp_path / "photo-r.png")

    ours = read_filter_write("bilateral", rpath, rpath, 20.0, 22.0,
                             str(tmp_path))
    r_img = cv2.imread(rpath)
    ref = cv2.bilateralFilter(r_img, -1, 20.0, 22.0)

    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02

    judg = _synthetic_judgments(rng)
    whdr_ours = compute_whdr(ours[:, :, ::-1] / 255.0, judg)
    whdr_ref = compute_whdr(ref[:, :, ::-1] / 255.0, judg)
    assert abs(whdr_ours - whdr_ref) < 0.001  # 0.1% absolute


def test_bell_scoring_matches_packed_blob_path(photo, rng):
    """losses/bell.compute_whdr and the packed-blob whdr op agree."""
    path, img = photo
    net = ReflectanceCNN()
    refl = net.reflectance_intensity(img)[..., None]

    judg = _synthetic_judgments(rng)
    bell = compute_whdr(refl, judg)

    k = len(judg["intrinsic_comparisons"])
    blob = np.full((k + 1, 6), np.nan, np.float32)
    pts = {p["id"]: p for p in judg["intrinsic_points"]}
    for i, c in enumerate(judg["intrinsic_comparisons"]):
        p1, p2 = pts[c["point1"]], pts[c["point2"]]
        blob[i] = [p1["x"], p1["y"], p2["x"], p2["y"],
                   {"1": 1, "2": 2, "E": 0}[c["darker"]],
                   c["darker_score"]]
    blob[k, 0] = k
    blob[k, 1] = 1.0
    blob[k, 2] = 0
    packed = float(whdr(jnp.asarray(refl), jnp.asarray(blob)))
    assert abs(bell - packed) < 1e-6


def test_guided_pipeline_runs_and_is_stable(photo, tmp_path):
    """GF(CNN, photo) smoke + idempotence sanity (guided filter of an
    already-smooth map changes little)."""
    import cv2
    path, img = photo
    decompose_image(path, str(tmp_path))
    rpath = str(tmp_path / "photo-r.png")
    once = read_filter_write("guided", rpath, path, 3.0, 8.0,
                             str(tmp_path))
    assert once.dtype == np.uint8 and once.shape == img.shape
    # filtering the filtered map again moves it less than the first pass
    r0 = cv2.imread(rpath).astype(int)
    d1 = np.abs(once.astype(int) - r0).mean()
    from reflectance_filtering.ops.guided import guided_filter_u8
    guide = cv2.imread(path)
    twice = guided_filter_u8(guide, once, 8, 3.0)
    d2 = np.abs(twice.astype(int) - once.astype(int)).mean()
    assert d2 <= d1 + 1e-9
