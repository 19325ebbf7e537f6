"""Intrinsic image decomposition with the trained reflectance CNN.

Flag- and output-compatible rebuild of the reference CLI
(the reference's decompose_with_trained_CNN.py): same flags
(--filename_in, --path_out), same output names ({base}-r.png linear,
{base}-r_colorized.png / {base}-s_colorized.png in sRGB) and the same
pipeline quirks (colorize on the RAW uint8 BGR image,
decompose_with_trained_CNN.py:122; percentile-normalized write,
image_utils.py:60-73).

Differences: the forward pass is one device program (uint8->float, BGR
flip, sRGB linearization, per-pixel MLP; on the GPU one fused Triton
kernel, see models.networks.reflectance_from_bgr_u8), and
``decompose_images`` batches same-size images so compilation is paid once
per shape, not per file.  ``--weights`` names the caffemodel (default:
``learned_weights.caffemodel`` in the checkout's root).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from ..models.caffe_io import load_reference_weights
from ..models.networks import (reference_params_from_caffe,
                               reflectance_from_bgr_u8)
from ..utils import image as iu


class ReflectanceCNN:
    """Loaded trained model; callable on images of any size.

    The reference rebuilds a caffe.Net and reshapes its input blob per image
    (decompose_with_trained_CNN.py:86-87); here one compiled forward is
    reused, recompiling only on new (B, H, W) shapes.
    """

    def __init__(self, weights_path: Optional[str] = None):
        self.params = reference_params_from_caffe(
            load_reference_weights(weights_path))

    def reflectance_batch(self, imgs_bgr_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR [B, H, W, 3] -> linear reflectance intensity
        [B, H, W] in (0, 1)."""
        planar = np.ascontiguousarray(np.moveaxis(imgs_bgr_u8, -1, 1))
        return np.asarray(reflectance_from_bgr_u8(self.params,
                                                  jnp.asarray(planar)))

    def reflectance_intensity(self, img_bgr_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR HWC -> linear reflectance intensity HW in (0,1)."""
        return self.reflectance_batch(np.asarray(img_bgr_u8)[None])[0]


def _write_outputs(path_out: str, basename: str, gray: np.ndarray,
                   image_bgr_u8: np.ndarray) -> None:
    """The three-output contract (decompose_with_trained_CNN.py:117-128):
    -r.png linear, -r_colorized/-s_colorized sRGB — colorize works on the
    RAW uint8 input image (reference quirk)."""
    iu.imwrite(os.path.join(path_out, basename + "-r.png"), gray)
    reflectance, shading = iu.colorize(gray, image_bgr_u8)
    iu.imwrite(os.path.join(path_out, basename + "-r_colorized.png"),
               reflectance, sRGB=True)
    iu.imwrite(os.path.join(path_out, basename + "-s_colorized.png"),
               shading, sRGB=True)


def decompose_image(filename_in: str, path_out: str,
                    net: Optional[ReflectanceCNN] = None) -> np.ndarray:
    """Reference-compatible single-image decompose
    (decompose_with_trained_CNN.py:98-130)."""
    if net is None:
        net = ReflectanceCNN()

    image = iu.imread(filename_in)
    basename = os.path.splitext(os.path.basename(filename_in))[0]

    reflectance_gray = net.reflectance_intensity(image)
    _write_outputs(path_out, basename, reflectance_gray, image)
    return reflectance_gray


def _read_images_grouped(filenames: Sequence[str]) -> Dict:
    """Read many images grouped by shape, through the native IO runtime
    (data/native_loader.read_images_rgb: header-only size probe, one C++
    thread-pool batch decode per same-size group — PNG decode is
    bit-exact vs cv2; without the native library, per-file
    utils.image.imread).  Per-file containment as in the reference's
    per-file try/except (helper:410-435)."""
    from ..data.native_loader import read_images_rgb

    items, failed = read_images_rgb(filenames)
    for fn in failed:
        print("Decomposing file", fn, "was not possible")
    groups: Dict = {}
    for fn, rgb in items:
        # native returns RGB; the pipeline contract is cv2's BGR
        img = rgb[:, :, ::-1]
        groups.setdefault(img.shape, []).append((fn, img))
    return groups


def decompose_images(filenames: Sequence[str], path_out: str,
                     net: Optional[ReflectanceCNN] = None,
                     batch_size: int = 16) -> Dict[str, np.ndarray]:
    """Batched multi-image mode replacing the reference's per-file loop:
    images are read through the native thread-pool decoder, grouped by
    (H, W), and each group runs through the product forward in device
    batches (one compile per shape, not per file)."""
    if net is None:
        net = ReflectanceCNN()
    groups = _read_images_grouped(filenames)
    out = {}
    for items in groups.values():
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            grays = net.reflectance_batch(
                np.stack([im for _, im in chunk]))
            for (fn, img), gray in zip(chunk, grays):
                basename = os.path.splitext(os.path.basename(fn))[0]
                _write_outputs(path_out, basename, gray, img)
                out[fn] = gray
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="""Decompose an image with the direct reflectance
                       prediction CNN.""")
    parser.add_argument("--filename_in",
                        help="""Filename of the image which should be
                                decomposed.""")
    parser.add_argument("--path_out",
                        help="""Where the resulting decompositions should be
                                saved.""")
    parser.add_argument("--weights", default=None,
                        help="""The trained caffemodel (default:
                                learned_weights.caffemodel in the
                                checkout's root).""")
    parser.add_argument("--profile_dir", default=None,
                        help="""Write an XLA-level device trace of the
                                decomposition here (open with xprof /
                                tensorboard --logdir).""")
    args = parser.parse_args(argv)
    if args.filename_in and args.path_out:
        from ..utils.compile_cache import enable_persistent_compilation_cache
        enable_persistent_compilation_cache()
        net = ReflectanceCNN(args.weights)
        if args.profile_dir:
            from ..utils.profiling import device_trace
            with device_trace(args.profile_dir):
                decompose_image(args.filename_in, args.path_out, net)
        else:
            decompose_image(args.filename_in, args.path_out, net)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
