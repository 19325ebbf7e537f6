"""Guided-filter golden-fixture gate (VERDICT r2 item 1).

tests/fixtures/guided_golden.npz holds uint8 outputs derived from the
independent C++-transcription oracle (tests/guided_cpp_oracle.py — see
its docstring for the failed binary-acquisition record).  Two gates:

  1. the committed oracle regenerates the fixtures BIT-EXACTLY (catches
     accidental edits to either side);
  2. the product path (ops/guided.py: guided_filter_u8 / guided_filter)
     stays within 1 uint8 level of the fixtures everywhere, for
     r in {3, 45, 52} x eps in {3, 7} x {gray, color, colorsrc} —
     a wrong border mode, normalization, precision or rounding choice
     in the product filters fails this against an arithmetic path it
     shares nothing with (f32 intermediates + explicit inverse here vs
     the f32 cofactor path there).

The same fixtures are re-checked on the GPU by ``python bench.py --gate``.
"""
import os

import numpy as np
import pytest

from guided_cpp_oracle import (guided_filter_cpp_color,
                               guided_filter_cpp_gray)
from make_guided_fixtures import FIXTURE, make_images

COMBOS = [(r, e) for r in (3, 45, 52) for e in (3.0, 7.0)]


@pytest.fixture(scope="module")
def golden():
    assert os.path.isfile(FIXTURE), (
        "run python tests/make_guided_fixtures.py")
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("radius,eps", COMBOS)
def test_oracle_regenerates_fixtures(golden, radius, eps):
    key = "small" if radius == 3 else "big"
    gc, gg, src = make_images()[key]
    np.testing.assert_array_equal(
        gc, golden["img_{}_guide_color".format(key)])
    tag = "r{}_e{}".format(radius, int(eps))
    np.testing.assert_array_equal(
        guided_filter_cpp_color(gc, src, radius, eps),
        golden["out_{}_color".format(tag)])
    np.testing.assert_array_equal(
        guided_filter_cpp_gray(gg, src, radius, eps),
        golden["out_{}_gray".format(tag)])


def _assert_within_one_level(got, exp, tag):
    got = got.astype(np.int32)
    exp = exp.astype(np.int32)
    d = np.abs(got - exp)
    assert d.max() <= 1, (
        "{}: {} pixels differ by >1 level (max {})".format(
            tag, int((d > 1).sum()), int(d.max())))


@pytest.mark.parametrize("radius,eps", COMBOS)
def test_product_color_guide_matches_fixtures(golden, radius, eps):
    from reflectance_filtering.ops.guided import guided_filter_u8
    key = "small" if radius == 3 else "big"
    tag = "r{}_e{}".format(radius, int(eps))
    gc = golden["img_{}_guide_color".format(key)]
    src = golden["img_{}_src".format(key)]
    got = guided_filter_u8(gc, src, radius, eps)
    _assert_within_one_level(got, golden["out_{}_color".format(tag)],
                             tag + "_color")
    got_cs = guided_filter_u8(gc, gc, radius, eps)
    _assert_within_one_level(got_cs, golden["out_{}_colorsrc".format(tag)],
                             tag + "_colorsrc")


@pytest.mark.parametrize("radius,eps", COMBOS)
def test_product_gray_guide_matches_fixtures(golden, radius, eps):
    from reflectance_filtering.ops.guided import guided_filter_u8
    key = "small" if radius == 3 else "big"
    tag = "r{}_e{}".format(radius, int(eps))
    gg = golden["img_{}_guide_gray".format(key)]
    src = golden["img_{}_src".format(key)]
    got = guided_filter_u8(gg, src, radius, eps)
    _assert_within_one_level(got, golden["out_{}_gray".format(tag)],
                             tag + "_gray")


def test_regen_script_import_guard():
    """scripts/regen_guided_fixtures.py must run on any machine: with
    opencv-contrib absent (this env) it exits 2 with a clear message;
    with it present it diffs the committed fixtures against the real
    binary (provenance contract, VERDICT r3 item 6)."""
    import subprocess
    import sys as _sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [_sys.executable, os.path.join(repo, "scripts",
                                       "regen_guided_fixtures.py")],
        capture_output=True, text=True, timeout=300)
    import cv2
    if hasattr(cv2, "ximgproc"):
        assert p.returncode == 0, p.stdout + p.stderr
        assert "worst max_diff" in p.stdout
    else:
        assert p.returncode == 2, p.stdout + p.stderr
        assert "ximgproc" in p.stderr


@pytest.mark.parametrize("shape", [(40, 512), (20, 512), (12, 40)])
def test_degenerate_radius_matches_oracle(shape):
    """radius >= a dimension (tiny strips/thumbnails at the product
    r=45): the planar filter must reproduce the oracle via multi-fold
    reflect pads, and so must the HWC product path."""
    from reflectance_filtering.ops.guided import (
        guided_filter, guided_filter_planar)
    import jax.numpy as jnp

    H, W = shape
    rng = np.random.RandomState(3)
    g8 = np.floor(rng.rand(H, W, 3) * 256).astype(np.uint8)
    s8 = np.floor(rng.rand(H, W) * 256).astype(np.uint8)
    want = guided_filter_cpp_color(g8, s8, 45, 3.0)
    g = jnp.asarray(np.moveaxis(g8.astype(np.float32), -1, 0)[None])
    s = jnp.asarray(s8.astype(np.float32)[None, None])
    for name, q in (
            ("planar", np.asarray(guided_filter_planar(g, s, 45, 3.0))[0, 0]),
            ("hwc", np.asarray(guided_filter(
                jnp.asarray(g8.astype(np.float32)),
                jnp.asarray(s8.astype(np.float32)), 45, 3.0)))):
        got = np.clip(np.rint(q), 0, 255).astype(np.uint8)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (name, shape, int(d.max()))
