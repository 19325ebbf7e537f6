"""The two Triton kernels (ops/bilateral_triton.py, ops/cnn_triton.py) and
the dispatch around them.

On the CPU the kernels run in the Pallas interpreter, against the plain
float32 references they replace; the product dispatch is checked for its
choice per backend and, lowered for cuda, for the Triton custom call.
Tests marked ``gpu`` compile the kernels for the card and skip here; the
same checks are phases of chip_smoke.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from reflectance_filtering.models import networks
from reflectance_filtering.models.caffe_io import load_reference_weights
from reflectance_filtering.models.networks import (
    reference_params_from_caffe, reflectance_from_bgr_u8)
from reflectance_filtering.ops import backend, bilateral
from reflectance_filtering.ops.bilateral import (
    bilateral_planar, joint_bilateral_filter, joint_bilateral_filter_u8)
from reflectance_filtering.ops.bilateral_triton import bilateral_triton
from reflectance_filtering.ops.cnn_triton import (REFERENCE_ATOL,
                                                  kernel_weights,
                                                  reflectance_cnn_triton)

TRITON_CALL = "__gpu$xla.gpu.triton"


def _u8_planes(rng, n, c, h, w):
    return np.floor(rng.rand(n, c, h, w) * 256).astype(np.float32)


def _reference(joint, src, sigma_color, sigma_space, reps):
    """Per-image HWC oracle: a mono joint replicated ``reps`` times."""
    out = []
    for i in range(joint.shape[0]):
        j = np.repeat(np.moveaxis(joint[i], 0, -1), reps, axis=-1)
        s = j if src is None else np.moveaxis(src[i], 0, -1)
        q = np.asarray(joint_bilateral_filter(j, s, -1, sigma_color,
                                              sigma_space))
        if src is None:
            q = q[..., ::reps]
        out.append(np.moveaxis(q, -1, 0))
    return np.stack(out)


@pytest.fixture(scope="module")
def params():
    return reference_params_from_caffe(load_reference_weights())


# --- bilateral --------------------------------------------------------------

@pytest.mark.parametrize("cj,cs,reps,self_guided", [
    (1, 1, 3, True),     # BF(CNN,CNN): the -r.png gray plane, 3 channels
    (1, 1, 1, True),     # a true 1-channel image by itself
    (3, 3, 1, True),     # cv2.bilateralFilter on a colour photo
    (3, 1, 1, False),    # BF(reflectance, photo): colour joint, gray src
    (1, 3, 3, False),    # gray joint (3 equal channels), colour src
    (3, 3, 1, False),
    (1, 1, 1, False),
])
def test_bilateral_kernel_channel_combinations(rng, cj, cs, reps,
                                               self_guided):
    joint = _u8_planes(rng, 2, cj, 21, 70)
    src = None if self_guided else _u8_planes(rng, 2, cs, 21, 70)
    got = np.asarray(bilateral_triton(
        jnp.asarray(joint), None if src is None else jnp.asarray(src),
        -1, 20.0, 2.5, joint_reps=reps, interpret=True))
    exp = _reference(joint, src, 20.0, 2.5, reps)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("h,w", [(1, 1), (5, 9), (16, 64), (17, 65),
                                 (33, 130)])
def test_bilateral_kernel_odd_sizes(rng, h, w):
    """Sizes off the 16x64 tile grid: zero tail padding must never reach
    a valid output (it sits beyond the reflect border)."""
    joint = _u8_planes(rng, 1, 1, h, w)
    got = np.asarray(bilateral_triton(jnp.asarray(joint), None, -1, 15.0,
                                      1.5, joint_reps=3, interpret=True))
    exp = _reference(joint, None, 15.0, 1.5, 3)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("sigma_color,sigma_space", [
    (20.0, 1.0), (5.0, 2.0), (40.0, 3.4), (0.0, 0.0)])
def test_bilateral_kernel_sigmas(rng, sigma_color, sigma_space):
    """Radius and weights follow OpenCV's parameter rules (sigmas <= 0
    clamp to 1) in the kernel as in the reference."""
    joint = _u8_planes(rng, 1, 3, 24, 40)
    src = _u8_planes(rng, 1, 1, 24, 40)
    got = np.asarray(bilateral_triton(jnp.asarray(joint), jnp.asarray(src),
                                      -1, sigma_color, sigma_space,
                                      interpret=True))
    exp = _reference(joint, src, sigma_color, sigma_space, 1)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=2e-3)


def test_bilateral_kernel_rejects_bad_channels():
    with pytest.raises(ValueError, match="1 or 3 channels"):
        bilateral_triton(jnp.zeros((1, 2, 8, 8)), None, interpret=True)
    with pytest.raises(ValueError, match="disagree"):
        bilateral_triton(jnp.zeros((1, 1, 8, 8)), jnp.zeros((1, 1, 8, 9)),
                         interpret=True)


@pytest.mark.parametrize("case", ["gray_self", "color_self", "joint_photo",
                                  "gray2d"])
def test_bilateral_u8_wrapper_kernel_matches_reference(rng, case,
                                                       monkeypatch):
    """The filter CLI's u8 wrapper gives the same bytes through the
    kernel (interpreted) as through the plain reference."""
    gray = np.floor(rng.rand(19, 37) * 256).astype(np.uint8)
    photo = np.floor(rng.rand(19, 37, 3) * 256).astype(np.uint8)
    rep3 = np.repeat(gray[..., None], 3, axis=-1)
    joint, src = {"gray_self": (rep3, rep3), "color_self": (photo, photo),
                  "joint_photo": (photo, rep3),
                  "gray2d": (gray, gray)}[case]
    want = joint_bilateral_filter_u8(joint, src, -1, 20.0, 3.0)
    import functools
    from reflectance_filtering.ops import bilateral_triton as bt
    monkeypatch.setattr(bilateral, "use_kernels", lambda: True)
    monkeypatch.setattr(bt, "bilateral_triton", functools.partial(
        bt.bilateral_triton, interpret=True))
    got = joint_bilateral_filter_u8(joint, src, -1, 20.0, 3.0)
    assert got.shape == want.shape == src.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


# --- CNN -----------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (2, 24, 32), (3, 7, 13),
                                   (1, 1, 1)])
def test_cnn_kernel_matches_reference(params, rng, b, h, w):
    x = (rng.rand(b, 3, h, w) * 256).astype(np.uint8)
    got = np.asarray(reflectance_cnn_triton(params, jnp.asarray(x),
                                            interpret=True))
    exp = np.asarray(networks._reflectance_from_bgr_u8_reference(
        params, jnp.asarray(x)))
    assert got.shape == exp.shape == (b, h, w)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    d = np.abs(np.floor(got * 255) - np.floor(exp * 255))
    assert d.max() <= 1


def test_cnn_kernel_weight_layout(params):
    wts = kernel_weights(params)
    assert wts["w0"].shape == (3, 32) and wts["wm"].shape == (4, 32, 32)
    assert wts["wf"].shape == (5, 32) and wts["bf"].shape == (1,)
    # the fuse column of skip layer i is rows 32i..32i+31 of the 160-col
    np.testing.assert_array_equal(
        np.asarray(wts["wf"][2]),
        np.asarray(params["fuse_skip_layers"]["kernel"])[0, 0, 64:96, 0])


# --- dispatch ------------------------------------------------------------------

def test_dispatch_cpu_runs_reference():
    assert jax.default_backend() == "cpu"
    assert backend.use_kernels() is False


@pytest.mark.parametrize("name,expect", [("gpu", True), ("cpu", False),
                                         ("metal", None), ("rocm", None)])
def test_dispatch_choice_per_backend(monkeypatch, name, expect):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    if expect is None:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            backend.use_kernels()
    else:
        assert backend.use_kernels() is expect


@pytest.mark.parametrize("platforms,expect", [
    (("cuda",), True), (("cpu",), False), (("cuda", "cpu"), False),
    (("rocm",), False)])
def test_dispatch_fixed_for_lowering_platforms(monkeypatch, platforms,
                                               expect):
    """kernels_for decides by the lowering platforms, whatever backend
    runs the trace (even one the switch rejects), and restores it."""
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "metal")
    with backend.kernels_for(platforms):
        assert backend.use_kernels() is expect
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.use_kernels()


def test_dispatch_contexts_nest_and_restore(monkeypatch):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "gpu")
    assert backend.use_kernels() is True
    with backend.references_only():
        assert backend.use_kernels() is False
        with backend.kernels_for(("cuda",)):
            assert backend.use_kernels() is True
        assert backend.use_kernels() is False
    assert backend.use_kernels() is True


def _cuda_hlo(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


def test_product_cnn_lowers_to_triton_call_for_cuda(params, monkeypatch):
    """With the GPU branch taken, the product forward's HLO holds the
    Triton kernel (so it cannot silently drop out of the product path);
    the CPU branch holds none."""
    x = jnp.zeros((2, 3, 32, 32), jnp.uint8)
    # fresh wrappers: a traced function is cached with its branch taken
    assert TRITON_CALL not in jax.jit(
        lambda p, v: reflectance_from_bgr_u8(p, v)).lower(
            params, x).as_text()
    monkeypatch.setattr(networks, "use_kernels", lambda: True)
    assert _cuda_hlo(lambda p, v: reflectance_from_bgr_u8(p, v),
                     params, x).count(TRITON_CALL) == 1


def test_product_bilateral_lowers_to_triton_call_for_cuda(monkeypatch):
    x = jnp.zeros((1, 1, 32, 64), jnp.float32)

    def fn(j):
        return bilateral_planar(j, None, -1, 20.0, 22.0, joint_reps=3)

    monkeypatch.setattr(bilateral, "use_kernels", lambda: True)
    assert _cuda_hlo(fn, x).count(TRITON_CALL) == 1


# --- on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_cnn_kernel_on_gpu(gpu, params, rng):
    x = jnp.asarray((rng.rand(4, 3, 256, 256) * 256).astype(np.uint8))
    got = np.asarray(reflectance_from_bgr_u8(params, x))
    exp = np.asarray(networks._reflectance_from_bgr_u8_reference(params, x))
    assert np.abs(np.floor(got * 255) - np.floor(exp * 255)).max() <= 1
    # a TF32 dot passes the byte gate above; this bound does not let it
    assert np.abs(got - exp).max() <= REFERENCE_ATOL


@pytest.mark.gpu
def test_bilateral_kernel_on_gpu(gpu, rng):
    joint = _u8_planes(rng, 2, 1, 128, 160)
    got = np.asarray(bilateral_planar(jnp.asarray(joint), None, -1, 20.0,
                                      22.0, joint_reps=3))
    exp = _reference(joint, None, 20.0, 22.0, 3)
    assert np.abs(np.rint(got) - np.rint(exp)).max() <= 1
