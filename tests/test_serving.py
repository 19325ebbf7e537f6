"""Serving export (utils/serving.py): serialize -> deserialize -> run.

The cuda-platform artifact cannot execute on the CPU suite, so the
round-trip EXECUTION tests export for 'cpu' with the XLA forward; the
cuda artifact is covered by an export+deserialize structural test here
(exporting needs no device) that also checks the Triton kernels are in
it.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from reflectance_filtering.utils.serving import (
    export_flagship, load_flagship)


def _triton_calls(path):
    with open(path, "rb") as f:
        exp = jax.export.deserialize(f.read())
    return exp.mlir_module().count("__gpu$xla.gpu.triton")


def test_export_cuda_artifact_roundtrips_structurally(tmp_path):
    path = str(tmp_path / "flagship_cuda.rfx")
    n = export_flagship(path, batch=2, height=32, width=32)
    assert n > 10_000 and os.path.getsize(path) == n
    fn = load_flagship(path)   # deserialize + calling convention checks
    assert callable(fn)
    assert _triton_calls(path) == 1        # the fused CNN kernel


def test_export_filter_pipelines_cuda_structural(tmp_path):
    """BF(CNN,CNN) and GF(CNN, image) artifacts export for cuda and
    deserialize; BF carries both Triton kernels, GF the CNN kernel and
    XLA's guided filter."""
    for kind, calls in (("bf", 2), ("gf", 1)):
        path = str(tmp_path / ("flagship_%s.rfx" % kind))
        n = export_flagship(path, batch=2, height=128, width=128,
                            platforms=("cuda",), pipeline=kind)
        assert n > 10_000
        assert callable(load_flagship(path))
        assert _triton_calls(path) == calls


@pytest.mark.parametrize("platforms,symbolic", [(("cpu",), False),
                                                (("cuda",), True)])
def test_export_without_kernels_holds_no_triton_call(tmp_path, platforms,
                                                     symbolic):
    """A cpu artifact, and a symbolic one for any platform, trace the
    product dispatch with the plain references."""
    path = str(tmp_path / "flagship_xla.rfx")
    export_flagship(path, batch=2, height=32, width=32, platforms=platforms,
                    symbolic=symbolic)
    assert _triton_calls(path) == 0


def test_export_cuda_rejects_mixed_platforms(tmp_path):
    import pytest
    with pytest.raises(ValueError, match="separately"):
        export_flagship(str(tmp_path / "x.rfx"), 1, 8, 8,
                        platforms=("cuda", "cpu"))


def test_export_cpu_filter_pipelines_execute(tmp_path, rng):
    """cpu-platform bf/gf artifacts execute and match the direct call
    of the same pipeline function (serialization fidelity)."""
    import jax
    from reflectance_filtering.utils.serving import _pipeline_fn
    imgs = (rng.rand(2, 72, 80, 3) * 255).astype(np.uint8)
    planar = jnp.asarray(np.ascontiguousarray(np.moveaxis(imgs, -1, 1)))
    for kind in ("bf", "gf"):
        path = str(tmp_path / ("flagship_cpu_%s.rfx" % kind))
        export_flagship(path, batch=2, height=72, width=80,
                        platforms=("cpu",), pipeline=kind)
        got = np.asarray(load_flagship(path)(planar))
        exp = np.asarray(jax.jit(_pipeline_fn(kind))(planar))
        np.testing.assert_array_equal(got, exp)
        assert np.isfinite(got).all() and got.shape == (2, 72, 80)


def test_symbolic_artifact_serves_any_shape(tmp_path, rng):
    """One symbolic-shape artifact serves arbitrary sizes — the compiled
    form of the reference's fully-conv reshape trick."""
    path = str(tmp_path / "flagship_any.rfx")
    export_flagship(path, batch=0, height=0, width=0,
                    platforms=("cpu",), pipeline="cnn", symbolic=True)
    fn = load_flagship(path)
    for shape in ((1, 3, 24, 32), (2, 3, 40, 56)):
        x = jnp.asarray((rng.rand(*shape) * 255).astype(np.uint8))
        out = np.asarray(fn(x))
        assert out.shape == (shape[0],) + shape[2:]
        assert np.isfinite(out).all()

    import pytest
    with pytest.raises(ValueError, match="cnn"):
        export_flagship(str(tmp_path / "nope.rfx"), 0, 0, 0,
                        platforms=("cpu",), pipeline="bf", symbolic=True)


def test_export_cpu_artifact_executes(tmp_path, rng):
    """A cpu-platform artifact must execute and match the XLA forward
    (the cpu lowering takes the same dispatch the CPU backend runs)."""
    from reflectance_filtering.cli.decompose import ReflectanceCNN
    path = str(tmp_path / "flagship_cpu.rfx")
    export_flagship(path, batch=2, height=24, width=32,
                    platforms=("cpu",))
    fn = load_flagship(path)
    imgs = (rng.rand(2, 24, 32, 3) * 255).astype(np.uint8)
    got = np.asarray(fn(jnp.asarray(
        np.ascontiguousarray(np.moveaxis(imgs, -1, 1)))))
    exp = ReflectanceCNN().reflectance_batch(imgs)
    d = np.abs(np.floor(got * 255.0) - np.floor(exp * 255.0))
    assert d.max() <= 1 and (d > 0).mean() < 0.001, (
        d.max(), (d > 0).mean())
