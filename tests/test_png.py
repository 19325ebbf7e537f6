"""The zlib PNG codec (utils/png.py) and utils.image's use of it where
OpenCV is absent.  cv2 is the oracle: files it writes decode to its own
pixels, and files the codec writes read back through cv2 unchanged."""
import struct
import zlib

import numpy as np
import pytest

from reflectance_filtering.utils import image as iu
from reflectance_filtering.utils import png


def _bgr(rgb):
    return rgb if rgb.ndim == 2 else np.concatenate(
        [rgb[..., 2::-1], rgb[..., 3:]], axis=-1)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (37, 53, 3),
                                   (20, 31, 4), (64, 64, 3)])
def test_codec_roundtrip_and_cv2_reads_it(tmp_path, rng, shape):
    import cv2
    a = np.floor(rng.rand(*shape) * 256).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write(path, a)
    np.testing.assert_array_equal(png.read(path), a)
    np.testing.assert_array_equal(
        cv2.imread(path, cv2.IMREAD_UNCHANGED), _bgr(a))


@pytest.mark.parametrize("kind", ["noise", "gradient", "flat"])
def test_codec_decodes_cv2_files(tmp_path, rng, kind):
    """cv2 picks its own row filters per image content."""
    import cv2
    yy, xx = np.mgrid[0:48, 0:70]
    a = {"noise": np.floor(rng.rand(48, 70, 3) * 256),
         "gradient": np.stack([xx * 3, yy * 5, (xx + yy) * 2], -1) % 256,
         "flat": np.full((48, 70, 3), 77)}[kind].astype(np.uint8)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, a)
    np.testing.assert_array_equal(png.read(path)[..., ::-1], a)


def _forward_filter(ftype, line, prior, bpp):
    """PNG encoder-side filter of one row (spec section 9), in ints."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return out


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_codec_unfilters_every_filter_type(rng, ftype):
    h, w, bpp = 6, 9, 3
    img = np.floor(rng.rand(h, w, bpp) * 256).astype(np.uint8)
    rows, prior = [], [0] * (w * bpp)
    for y in range(h):
        line = [int(v) for v in img[y].reshape(-1)]
        filt = line if ftype == 0 else _forward_filter(ftype, line, prior,
                                                       bpp)
        rows.append(bytes([ftype] + filt))
        prior = line
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("depth,ctype,interlace", [(16, 2, 0), (8, 3, 0),
                                                   (8, 2, 1), (8, 4, 0)])
def test_codec_rejects_unsupported_formats(depth, ctype, interlace):
    ihdr = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
    data = png._SIGNATURE + png._chunk(b"IHDR", ihdr)
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode(data)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")


def test_image_io_without_cv2_matches_cv2(tmp_path, rng, monkeypatch):
    """imread/imwrite keep OpenCV's uint8 semantics on the codec path:
    BGR order, gray read as 3 equal channels, the float write quirks."""
    import cv2
    bgr = np.floor(rng.rand(21, 34, 3) * 256).astype(np.uint8)
    gray = np.floor(rng.rand(21, 34) * 256).astype(np.uint8)
    refl = rng.rand(21, 34).astype(np.float32)
    for name, img in (("bgr", bgr), ("gray", gray), ("float", refl)):
        iu.imwrite(str(tmp_path / ("cv_" + name + ".png")), img)
    monkeypatch.setattr(iu, "_cv2", lambda: None)
    for name, img in (("bgr", bgr), ("gray", gray), ("float", refl)):
        iu.imwrite(str(tmp_path / ("np_" + name + ".png")), img)
        ours = iu.imread(str(tmp_path / ("np_" + name + ".png")))
        theirs = cv2.imread(str(tmp_path / ("cv_" + name + ".png")))
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
        np.testing.assert_array_equal(
            iu.imread(str(tmp_path / ("cv_" + name + ".png"))), theirs)
    with pytest.raises(IOError, match="not readable"):
        iu.imread(str(tmp_path / "missing.png"))
    with pytest.raises(IOError, match="only PNG"):
        iu.imwrite(str(tmp_path / "x.jpg"), bgr)
