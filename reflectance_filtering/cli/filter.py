"""Reflectance filtering CLI — flag- and output-compatible rebuild of
the reference's filter_reflectance.py.

Same flags (--filename_in --guidance_in --path_out --sigma_color
--sigma_spatial --filter_type), same parameter semantics (bilateral:
d=-1/sigmaColor/sigmaSpace; guided: radius=int(sigma_spatial),
eps=sigma_color — filter_reflectance.py:49-73), same output naming
``{base}_{type}_c{sc}s{ss}.png`` (:92-93) and the same no-args help +
suggested parameter combos (:133-139).

Filtering happens in uint8 0-255 space exactly as the reference (it never
linearizes here, §3.2 of SURVEY.md); the filters run on the device.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..ops.bilateral import joint_bilateral_filter_u8
from ..ops.guided import fast_guided_filter_u8, guided_filter_u8
from ..utils import image as iu

_GRID_CAVEAT = (
    "bilateral_grid is an APPROXIMATE speed mode (bilateral-grid splat/"
    "blur/slice): ~0.4 uint8 levels mean / ~2 levels p99 vs the exact "
    "filter at the default cells; use --filter_type=bilateral for the "
    "reference-parity output.")
_SUBSAMPLE_CAVEAT = (
    "--subsample>1 runs the Fast Guided Filter (He & Sun 2015) — an "
    "APPROXIMATE speed mode, typically <1 uint8 level mean error at "
    "subsample=4; drop --subsample for the reference-parity output.")


def apply_filter(filter_type, image, joint, sigma_color, sigma_spatial,
                 subsample: int = 1, grid_ss=None, grid_sr=None):
    """Apply the joint-bilateral or guided filter
    (filter_reflectance.py:49-73).

    Beyond the reference surface (opt-in speed modes):
    filter_type='bilateral_grid' runs the approximate grid bilateral
    (ops/bilateral_grid.py; grid_ss/grid_sr tune the cells), and
    subsample>1 with filter_type='guided' runs the Fast Guided Filter
    (He & Sun 2015) at 1/subsample coefficient resolution."""
    # None-safe: the sigma flags are optional (argparse default None) and
    # 'None <= 0' would TypeError on exactly the input this guard reports
    if (sigma_color is None or sigma_spatial is None
            or sigma_color <= 0 or sigma_spatial <= 0):
        raise ValueError("Parameters are expected to be positive.")
    if filter_type == "bilateral":
        return joint_bilateral_filter_u8(joint, image, d=-1,
                                         sigma_color=sigma_color,
                                         sigma_space=sigma_spatial)
    elif filter_type == "bilateral_grid":
        from ..ops.bilateral_grid import bilateral_grid_u8
        print(_GRID_CAVEAT, file=sys.stderr)
        return bilateral_grid_u8(joint, image, sigma_color=sigma_color,
                                 sigma_space=sigma_spatial,
                                 ss=grid_ss, sr=grid_sr)
    elif filter_type == "guided":
        if subsample and subsample > 1:
            print(_SUBSAMPLE_CAVEAT, file=sys.stderr)
            return fast_guided_filter_u8(joint, image,
                                         radius=int(sigma_spatial),
                                         eps=sigma_color,
                                         subsample=subsample)
        return guided_filter_u8(joint, image, radius=int(sigma_spatial),
                                eps=sigma_color)
    raise ValueError("filter_type must be 'bilateral', 'guided' or "
                     "'bilateral_grid'.")


def read_filter_write(filter_type, filename_in, guidance_in,
                      sigma_color, sigma_spatial, path_out,
                      subsample: int = 1, grid_ss=None, grid_sr=None):
    """Read input + guidance, filter, write (filter_reflectance.py:76-96).

    Reference-surface modes keep the reference's exact output naming;
    the opt-in speed modes get distinct names (``_bilateral_grid_...``,
    ``_guided_sub{n}_...``) so they can never be mistaken for (or
    overwrite) a parity output."""
    basename = os.path.splitext(os.path.basename(filename_in))[0]
    image = iu.imread(filename_in)
    joint = iu.imread(guidance_in)

    filtered = apply_filter(filter_type, image, joint,
                            sigma_color, sigma_spatial,
                            subsample=subsample, grid_ss=grid_ss,
                            grid_sr=grid_sr)

    name_type = filter_type
    if filter_type == "guided" and subsample and subsample > 1:
        name_type = "guided_sub{}".format(subsample)
    params = "_{}_c{}s{}".format(name_type, sigma_color, sigma_spatial)
    filename = os.path.join(path_out, basename + params + ".png")
    iu.imwrite(filename, filtered)
    return filtered


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="""Filter reflectance prediction with a bilateral/guided
                       filter, to enhance piecewise constant reflectance
                       prior.""")
    parser.add_argument("--filename_in",
                        help="""Filename of the image which should be
                                filtered.""")
    parser.add_argument("--guidance_in",
                        help="""Filename of the guidance image which should be
                                used for filtering.""")
    parser.add_argument("--path_out",
                        help="""Where the resulting decompositions should be
                                saved.""")
    parser.add_argument("--sigma_color", type=float,
                        help="color parameter")
    parser.add_argument("--sigma_spatial", type=float,
                        help="spatial parameter")
    parser.add_argument("--filter_type",
                        help="""Which filter to choose,
                                the guided filter (guided) or
                                the joint bilateral filter (bilateral).
                                bilateral_grid selects the approximate
                                grid-accelerated bilateral (opt-in fast
                                mode, ~10x faster, a few uint8 levels
                                of error).""")
    parser.add_argument("--subsample", type=int, default=1,
                        help="""guided only: >1 runs the Fast Guided
                                Filter (He & Sun 2015) with coefficients
                                computed at 1/subsample resolution —
                                opt-in approximate fast mode.""")
    parser.add_argument("--grid_ss", type=int, default=None,
                        help="""bilateral_grid only: spatial cell size in
                                pixels (default ~sigma_spatial/3).""")
    parser.add_argument("--grid_sr", type=int, default=None,
                        help="""bilateral_grid only: range cell size in
                                intensity levels (default
                                ~1.2*sigma_color).""")
    args = parser.parse_args(argv)
    effective_argv = argv if argv is not None else sys.argv[1:]
    if len(effective_argv) > 0:
        from ..utils.compile_cache import enable_persistent_compilation_cache
        enable_persistent_compilation_cache()
        read_filter_write(args.filter_type,
                          args.filename_in, args.guidance_in,
                          args.sigma_color, args.sigma_spatial,
                          args.path_out, subsample=args.subsample,
                          grid_ss=args.grid_ss, grid_sr=args.grid_sr)
    else:
        parser.print_help()
        print("If you do not have any idea what parameters to choose, " +
              "try one of the following combinations:")
        print("--filter_type=bilateral --sigma_color=20 --sigma_spatial=22")
        print("--filter_type=guided --sigma_color=7 --sigma_spatial=52")
        print("--filter_type=guided --sigma_color=3 --sigma_spatial=45")


if __name__ == "__main__":
    main()
