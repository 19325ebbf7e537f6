"""ctypes binding for the native IO runtime (native/reflectance_io.cc).

Builds the shared library on first use if missing (it needs g++ and the
libpng/libjpeg headers); falls back to per-file utils.image.imread
transparently if the build or load fails, so the framework never
hard-depends on the native path.

The batch loader decodes + resizes PNG/JPEG files with a C++ thread pool
into one preallocated [N, H, W, 3] uint8 RGB array — the feeding side of
the batched decompose pipeline (the role OpenCV's native core played for
the reference, SURVEY.md N5).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..utils import image as iu

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libreflectance_io.so")

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
        return True
    except (subprocess.CalledProcessError, OSError) as err:
        print("native IO build failed ({}); falling back to "
              "utils.image.imread".format(err))
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lib_lock:
        # one attempt per process: a failed build or load is reported once
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if not os.path.isfile(_SO_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as err:
            print("native IO load failed ({}); falling back to "
                  "utils.image.imread".format(err))
            return None
        lib.rio_version.restype = ctypes.c_char_p
        lib.rio_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int]
        lib.rio_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.rio_load_batch_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def image_size(path: str):
    """(h, w) of an image; raises IOError on failure."""
    lib = _load()
    if lib is None:
        return iu.imread(path).shape[:2]
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.rio_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise IOError("cannot read {} (rc={})".format(path, rc))
    return h.value, w.value


def read_images_rgb(paths: Sequence[str]):
    """Decode many images at native size to uint8 RGB via the thread pool.

    Groups same-(H, W) files and decodes each group with ONE
    load_batch_rgb call (same-size resize is a memcpy — PNG decode is
    bit-exact vs cv2, tested in tests/test_native_io.py).  Returns
    (items, failed): items is [(path, rgb_u8 [H,W,3]), ...], failed the
    paths nothing could read.  Files the native probe rejects (formats
    beyond PNG/JPEG) fall back to utils.image.imread; a failed batch
    decodes per-file the same way so one bad file never takes down its
    group."""
    def imread_rgb(path):
        return iu.imread(path)[:, :, ::-1]

    size_groups = {}
    items, failed = [], []
    for p in paths:
        try:
            h, w = image_size(p)
            size_groups.setdefault((h, w), []).append(p)
        except Exception:
            try:
                items.append((p, imread_rgb(p)))
            except Exception:
                failed.append(p)
    for (h, w), group in size_groups.items():
        try:
            rgb = load_batch_rgb(group, h, w)
            items.extend(zip(group, rgb))
        except Exception:
            for p in group:
                try:
                    items.append((p, imread_rgb(p)))
                except Exception:
                    failed.append(p)
    return items, failed


def load_batch_rgb(paths: Sequence[str], height: int, width: int,
                   nthreads: int = 0) -> np.ndarray:
    """Decode+resize a list of image files to [N, H, W, 3] uint8 RGB.

    Uses the C++ thread pool when available; utils.image.imread
    sequentially otherwise (resizing, if needed, through cv2).
    Raises IOError naming the first failing file.
    """
    n = len(paths)
    if height <= 0 or width <= 0:
        raise ValueError(
            "height/width must be positive, got {}x{}".format(height, width))
    out = np.empty((n, height, width, 3), np.uint8)
    if n == 0:
        return out
    lib = _load()
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = lib.rio_load_batch_rgb(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            height, width, nthreads)
        if rc:
            if rc <= -1000:     # per-file decode failure: -1000 - index
                raise IOError(
                    "failed to decode {}".format(paths[-rc - 1000]))
            raise IOError(
                "native loader rejected the call (rc={})".format(rc))
        return out
    for i, p in enumerate(paths):
        try:
            img = iu.imread(p)
        except IOError as err:
            raise IOError("failed to decode {}".format(p)) from err
        if img.shape[:2] != (height, width):
            import cv2
            img = cv2.resize(img, (width, height),
                             interpolation=cv2.INTER_LINEAR)
        out[i] = img[:, :, ::-1]
    return out
