"""Decompose-family tests: full-size image, npz dual interpretation, movie
pipeline, per-file error containment — the helper:711-1060 surface."""
import os

import numpy as np
import pytest

import jax

from reflectance_filtering.models.networks import (
    NetworkConfig, init_network)
from reflectance_filtering.train import predict as P
from reflectance_filtering.utils.image import (
    srgb_to_rgb, rgb_to_srgb, normalize)


@pytest.fixture(scope="module")
def net():
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_file_type_dispatch():
    assert P.is_image("a.PNG") and P.is_image("b.jpg")
    assert P.is_movie("c.mp4") and P.is_movie("d.AVI")
    assert P.is_numpy("e.npz")
    assert not P.is_image("e.npz") and not P.is_movie("a.png")


def test_decompose_image_six_outputs(net, tmp_path, rng):
    import cv2
    cfg, params = net
    img = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "photo.png")
    cv2.imwrite(path, img)
    P.decompose_single_image_in_full_size(path, params, cfg, str(tmp_path))
    for sub in ("decompositions_linear", "decompositions_sRGB"):
        for suffix in ("-r", "-s", "-RS_est"):
            assert os.path.isfile(str(tmp_path / sub /
                                      ("photo" + suffix + ".png"))), \
                (sub, suffix)


def test_decompose_image_write_semantics(net, tmp_path, rng):
    """Written bytes = cv2.imwrite(img*255) of the raw decomposition
    (helper:665-686: no normalization, no clipping — cv2 saturates)."""
    import cv2
    cfg, params = net
    img = (rng.rand(24, 24, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    P.decompose_single_image_in_full_size(path, params, cfg, str(tmp_path))

    # recompute the expected reflectance through the same predict path
    lin = srgb_to_rgb(img[:, :, ::-1].astype(np.float64) / 255.0
                      ).astype(np.float32)
    fn = P.make_predict_fn(cfg)
    refl = np.asarray(fn(params, lin[None])["reflectance"][0])
    expected = np.clip(np.round(refl[:, :, ::-1] * 255), 0, 255
                       ).astype(np.uint8)
    got = cv2.imread(str(tmp_path / "decompositions_linear" / "x-r.png"))
    if got.shape[-1] == 3 and expected.shape[-1] == 1:
        expected = np.repeat(expected, 3, axis=-1)
    np.testing.assert_array_equal(got, expected)


def test_decompose_numpy_roundtrip(net, tmp_path, rng):
    cfg, params = net
    images = (rng.rand(3, 16, 16, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "stack.npz")
    np.savez(path, images=images)
    out = P.decompose_numpy(path, params, cfg, batch_size=2)
    with np.load(out) as npz:
        assert set(npz.files) == {"images", "R_back_to_sRGB",
                                  "S_back_to_sRGB", "r_back_to_sRGB",
                                  "R_from_input", "S_from_input",
                                  "r_from_input"}
        np.testing.assert_array_equal(npz["images"], images)
        assert npz["R_from_input"].shape[0] == 3
        # sRGB-interpreted branch must differ from the as-is branch
        assert not np.allclose(npz["R_from_input"], npz["R_back_to_sRGB"])


def test_movie_roundtrip(net, tmp_path, rng):
    import cv2
    cfg, params = net
    # write a small test movie
    path = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                         (32, 24), True)
    assert wr.isOpened()
    for _ in range(5):
        wr.write((rng.rand(24, 32, 3) * 255).astype(np.uint8))
    wr.release()

    out = P.decompose_movie(path, params, cfg, str(tmp_path), batch_size=2)
    d = tmp_path / "decompositions_sRGB"
    assert os.path.isfile(str(d / "clip-combined.mp4"))
    assert os.path.isfile(str(d / "clip-r.mp4"))
    assert os.path.isfile(str(d / "clip-s.mp4"))
    assert os.path.isfile(str(d / "clip-baseline_rgbMean-combined.mp4"))
    assert os.path.isfile(str(d / "clip-baseline_rgbNorm-combined.mp4"))

    # combined triptych has 3x width
    cap = cv2.VideoCapture(str(d / "clip-combined.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 96
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 24
    cap.release()


def test_load_movie_linearizes(net, tmp_path, rng):
    import cv2
    path = str(tmp_path / "m.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                         (16, 16), True)
    frames = [(rng.rand(16, 16, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    for f in frames:
        wr.write(f)
    wr.release()
    loaded, stats = P.load_movie(path)
    assert loaded.shape == (3, 16, 16, 3)
    assert stats[0] == 16 and stats[1] == 16
    assert loaded.max() <= 1.0  # linearized 0-1


def test_decompose_images_batched_matches_single(net, tmp_path, rng):
    """Shape-grouped batching == the per-image path, byte for byte,
    including mixed sizes and a bad file (containment)."""
    import cv2
    cfg, params = net
    paths = []
    for i, (h, w) in enumerate([(24, 32), (24, 32), (16, 40)]):
        p = str(tmp_path / "img{}.png".format(i))
        cv2.imwrite(p, (rng.rand(h, w, 3) * 255).astype(np.uint8))
        paths.append(p)
    paths.append(str(tmp_path / "missing.png"))

    bdir = str(tmp_path / "batched")
    done = P.decompose_images_batched(paths, params, cfg, bdir,
                                      batch_size=2)
    assert sorted(done) == sorted(paths[:3])

    sdir = str(tmp_path / "single")
    for p in paths[:3]:
        P.decompose_single_image_in_full_size(p, params, cfg, sdir)
    for sub in ("decompositions_linear", "decompositions_sRGB"):
        for i in range(3):
            for suffix in ("-r", "-s", "-RS_est"):
                fn = "img{}{}.png".format(i, suffix)
                a = cv2.imread(os.path.join(bdir, sub, fn))
                b = cv2.imread(os.path.join(sdir, sub, fn))
                np.testing.assert_array_equal(a, b, err_msg=(sub, fn))


def test_decompose_files_error_containment(net, tmp_path, capsys):
    cfg, params = net
    P.decompose_files([str(tmp_path / "missing.png"),
                       str(tmp_path / "junk.xyz")],
                      params, cfg, str(tmp_path))
    out = capsys.readouterr().out
    assert "was not possible" in out
    assert "neither recognized" in out


def test_decompose_files_contains_failing_image_chunk(net, tmp_path, rng):
    """A predict failure on one image group must not abort the other
    groups or the npz file in the same call (helper:410-435)."""
    import cv2
    cfg, params = net
    img_ok = str(tmp_path / "ok.png")
    cv2.imwrite(img_ok, (rng.rand(16, 20, 3) * 255).astype(np.uint8))
    img_boom = str(tmp_path / "boom.png")
    cv2.imwrite(img_boom, (rng.rand(24, 28, 3) * 255).astype(np.uint8))
    npz = str(tmp_path / "blob.npz")
    np.savez(npz, images=(rng.rand(2, 12, 16, 3) * 255).astype(np.float32))

    real = P.make_predict_fn(cfg)

    def exploding(params_, batch):
        if batch.shape[1] == 24:      # the boom.png group
            raise RuntimeError("synthetic predict failure")
        return real(params_, batch)

    resdir = tmp_path / "res"
    for d in ("decompositions_linear", "decompositions_sRGB"):
        (resdir / d).mkdir(parents=True)
    import unittest.mock as mock
    with mock.patch.object(P, "make_predict_fn",
                           lambda cfg_: exploding):
        P.decompose_files([img_boom, img_ok, npz], params, cfg,
                          str(resdir))
    lin = os.listdir(resdir / "decompositions_linear")
    assert any(f.startswith("ok-") for f in lin)
    assert not any(f.startswith("boom-") for f in lin)
    assert os.path.exists(str(tmp_path / "blob_decomposed.npz"))
