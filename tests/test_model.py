"""Tests for the caffemodel converter and network forwards.

The oracle for the flagship forward is an independent numpy implementation
of the frozen graph in network_definition.prototxt:17-165 (five 1x1 convs +
ReLU, skip concat, 1x1 fuse, sigmoid) applied directly to the converter's
raw OIHW blobs — so converter layout bugs and forward bugs cannot cancel.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reflectance_filtering.models import caffe_io, networks
from reflectance_filtering.models.networks import (
    NetworkConfig, REFERENCE_CONFIG, apply_network, init_network,
    reflectance_net_apply, reference_params_from_caffe, head_channels,
)
from reflectance_filtering.models.recover import (
    recover_reflectance_shading, RS_EST_MODES, EPS,
)


@pytest.fixture(scope="module")
def ref_weights(seeded_caffemodel):
    return caffe_io.load_reference_weights(seeded_caffemodel)


@pytest.fixture(scope="module")
def raw_blobs(seeded_caffemodel):
    return caffe_io.parse_caffemodel(seeded_caffemodel)


def test_converter_shapes(ref_weights):
    assert ref_weights["conv0"]["kernel"].shape == (1, 1, 3, 32)
    for i in range(1, 5):
        assert ref_weights["conv%d" % i]["kernel"].shape == (1, 1, 32, 32)
        assert ref_weights["conv%d" % i]["bias"].shape == (32,)
    assert ref_weights["fuse_skip_layers"]["kernel"].shape == (1, 1, 160, 1)
    assert ref_weights["fuse_skip_layers"]["bias"].shape == (1,)


def test_converter_total_params(ref_weights):
    total = sum(w["kernel"].size + w["bias"].size
                for w in ref_weights.values())
    assert total == 4513  # SURVEY.md C7


def test_converter_against_raw_blobs(ref_weights, raw_blobs):
    # HWIO kernel [0,0,i,o] must equal OIHW blob [o,i,0,0]
    k = ref_weights["conv0"]["kernel"]
    raw = raw_blobs["conv0"][0]
    assert raw.shape == (32, 3, 1, 1)
    np.testing.assert_array_equal(k[0, 0], raw[:, :, 0, 0].T)
    np.testing.assert_array_equal(ref_weights["conv0"]["bias"],
                                  raw_blobs["conv0"][1].reshape(-1))


def _pb_key(fnum, wtype):
    return bytes([(fnum << 3) | wtype]) if fnum < 16 else _pb_varint(
        (fnum << 3) | wtype)


def _pb_varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb_len(fnum, payload):
    return _pb_key(fnum, 2) + _pb_varint(len(payload)) + payload


def test_parse_caffemodel_old_format(tmp_path):
    """V1LayerParameter (NetParameter.layers=2): name is field 4, blobs 6.

    Field 1 of V1LayerParameter is the embedded V0LayerParameter message —
    a parser reading field 1 as the name would extract garbage (regression
    for exactly that bug).
    """
    data = np.arange(8, dtype="<f4")
    blob = (_pb_len(7, _pb_key(1, 0) + _pb_varint(2)      # BlobShape.dim: 2,4
                    + _pb_key(1, 0) + _pb_varint(4))
            + _pb_len(5, data.tobytes()))                 # packed float data
    v0 = _pb_len(1, b"legacy-v0-name")                    # V0LayerParameter
    layer = (v0
             + _pb_len(4, b"convX")                       # V1.name = 4
             + _pb_len(6, blob))                          # V1.blobs = 6
    net = _pb_len(2, layer)                               # NetParameter.layers
    path = tmp_path / "old_format.caffemodel"
    path.write_bytes(net)
    parsed = caffe_io.parse_caffemodel(str(path))
    assert list(parsed.keys()) == ["convX"]
    np.testing.assert_array_equal(parsed["convX"][0],
                                  data.reshape(2, 4))


def _numpy_reference_forward(raw_blobs, img_hwc):
    """Frozen-graph oracle in numpy, straight off the OIHW blobs."""
    x = img_hwc  # [H,W,3]
    skips = []
    for i in range(5):
        w = raw_blobs["conv%d" % i][0][:, :, 0, 0]  # [out,in]
        b = raw_blobs["conv%d" % i][1].reshape(-1)
        x = np.maximum(x @ w.T + b, 0.0)
        skips.append(x)
    cat = np.concatenate(skips, axis=-1)
    wf = raw_blobs["fuse_skip_layers"][0][:, :, 0, 0]
    bf = raw_blobs["fuse_skip_layers"][1].reshape(-1)
    pre = cat @ wf.T + bf
    return 1.0 / (1.0 + np.exp(-pre))


def test_flagship_forward_matches_numpy_oracle(ref_weights, raw_blobs, rng):
    img = rng.rand(17, 23, 3).astype(np.float32)
    expected = _numpy_reference_forward(raw_blobs, img.astype(np.float64))
    params = reference_params_from_caffe(ref_weights)
    got = np.asarray(reflectance_net_apply(params, jnp.asarray(img)))
    np.testing.assert_allclose(got[..., 0], expected[..., 0],
                               rtol=1e-5, atol=1e-6)


def test_flagship_forward_via_generic_conv_path(ref_weights, rng):
    """apply_network(REFERENCE_CONFIG) must equal the fused MLP path."""
    img = rng.rand(1, 16, 16, 3).astype(np.float32)
    params = reference_params_from_caffe(ref_weights)
    blobs = apply_network(params, jnp.asarray(img), REFERENCE_CONFIG)
    fast = reflectance_net_apply(params, jnp.asarray(img))
    np.testing.assert_allclose(np.asarray(blobs["RS_est"]), np.asarray(fast),
                               rtol=1e-5, atol=1e-6)


def test_output_range_is_sigmoid(ref_weights, rng):
    img = rng.rand(8, 8, 3).astype(np.float32)
    params = reference_params_from_caffe(ref_weights)
    out = np.asarray(reflectance_net_apply(params, jnp.asarray(img)))
    assert np.all(out > 0) and np.all(out < 1)


@pytest.mark.parametrize("net_type", networks.NETWORK_TYPES)
def test_all_architectures_forward(net_type, rng):
    cfg = NetworkConfig(network_type=net_type, num_layers=2,
                        num_filters_log=3, kernel_pad=1,
                        rs_est_mode="rRelMax" if net_type ==
                        "cascadeSkipLayers" else "rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    img = jnp.asarray(rng.rand(2, 32, 32, 3).astype(np.float32))
    blobs = apply_network(params, img, cfg)
    est = blobs["RS_est"]
    assert est.shape == (2, 32, 32, cfg.num_output_final)
    assert np.all(np.isfinite(np.asarray(est)))


@pytest.mark.parametrize("mode,channels", [
    ("RS", 6), ("R", 3), ("S", 3), ("rAbs", 1), ("sAbs", 1),
    ("rRelNorm", 1), ("rRelMean", 1), ("rRelY", 1), ("rRelMax", 1),
    ("sRelNorm", 1), ("sRelMean", 1), ("sRelY", 1), ("sRelMax", 1),
    ("rDirectly", 1),
])
def test_head_channels(mode, channels):
    assert head_channels(mode) == channels


@pytest.mark.parametrize("mode", [m for m in RS_EST_MODES])
def test_recover_shapes_and_finiteness(mode, rng):
    c = head_channels(mode)
    est = jnp.asarray(rng.rand(2, 8, 8, c).astype(np.float32)) + 0.1
    img = jnp.asarray(rng.rand(2, 8, 8, 3).astype(np.float32)) + 0.1
    r, s = recover_reflectance_shading(est, img, mode)
    if mode == "rDirectly":
        assert r.shape == (2, 8, 8, 1)
    else:
        assert r.shape == (2, 8, 8, 3)
        assert s.shape == (2, 8, 8, 3)
    assert np.all(np.isfinite(np.asarray(r)))
    assert np.all(np.isfinite(np.asarray(s)))


def test_recover_rrelmean_matches_reference_math(rng):
    """Oracle: recover_reflectance_shading_layer.py:246-283 with Mean norm."""
    est = rng.rand(1, 6, 6, 1).astype(np.float32)
    img = rng.rand(1, 6, 6, 3).astype(np.float32)
    r, s = recover_reflectance_shading(jnp.asarray(est), jnp.asarray(img),
                                       "rRelMean")
    r_i = np.maximum(est, EPS)
    intensity = np.maximum(np.sum(img, axis=-1, keepdims=True) / 3, EPS)
    exp_r = r_i * (img / intensity)
    exp_s = (intensity / r_i) * np.ones_like(img)
    np.testing.assert_allclose(np.asarray(r), exp_r, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s), exp_s, rtol=1e-5)


def test_recover_is_differentiable(rng):
    est = jnp.asarray(rng.rand(1, 4, 4, 1).astype(np.float32)) + 0.2
    img = jnp.asarray(rng.rand(1, 4, 4, 3).astype(np.float32)) + 0.2

    def loss(e):
        r, s = recover_reflectance_shading(e, img, "rRelMax")
        return jnp.sum(r ** 2) + jnp.sum(s ** 2)

    g = jax.grad(loss)(est)
    assert np.all(np.isfinite(np.asarray(g)))


def test_recover_lambertian_consistency(rng):
    """For the relative modes, R*S must reconstruct the input image."""
    est = jnp.asarray(rng.rand(1, 5, 5, 1).astype(np.float32)) + 0.3
    img = jnp.asarray(rng.rand(1, 5, 5, 3).astype(np.float32)) + 0.3
    for mode in ("rRelMean", "rRelMax", "rRelY", "rRelNorm", "rAbs", "sAbs"):
        r, s = recover_reflectance_shading(est, img, mode)
        np.testing.assert_allclose(np.asarray(r * s), np.asarray(img),
                                   rtol=1e-4, err_msg=mode)


def test_xavier_filler_stats():
    k = networks.xavier_uniform(jax.random.PRNGKey(1), (3, 3, 16, 32))
    a = np.sqrt(3.0 / (3 * 3 * 16))
    vals = np.asarray(k)
    assert vals.min() >= -a and vals.max() <= a
    assert abs(vals.mean()) < a / 10


# --- seeded stand-in weights ----------------------------------------------------

def test_seeded_caffemodel_roundtrips_through_parser(tmp_path):
    """The writer emits the wire format parse_caffemodel reads: every
    blob comes back bit-exact at its caffe shape, 4,513 floats."""
    path = caffe_io.write_seeded_caffemodel(str(tmp_path / "s.caffemodel"),
                                            seed=5)
    raw = caffe_io.parse_caffemodel(path)
    want = caffe_io.seeded_reference_blobs(5)
    assert list(raw) == list(caffe_io.REFERENCE_BLOB_SHAPES)
    for name, blobs in want.items():
        for got, exp in zip(raw[name], blobs):
            np.testing.assert_array_equal(got, exp)
    w = caffe_io.load_reference_weights(path)
    assert w["conv0"]["kernel"].shape == (1, 1, 3, 32)
    assert sum(v["kernel"].size + v["bias"].size for v in w.values()) == 4513


def test_seeded_weights_depend_only_on_seed():
    a, b = caffe_io.seeded_reference_blobs(1), caffe_io.seeded_reference_blobs(1)
    c = caffe_io.seeded_reference_blobs(2)
    for name in a:
        np.testing.assert_array_equal(a[name][0], b[name][0])
        assert not np.array_equal(a[name][0], c[name][0])
        # caffe's xavier filler bound
        bound = np.sqrt(3.0 / np.prod(a[name][0].shape[1:]))
        assert np.abs(a[name][0]).max() <= bound


def test_missing_weights_error_names_path_and_remedy(tmp_path):
    path = str(tmp_path / "nowhere" / "learned_weights.caffemodel")
    with pytest.raises(FileNotFoundError) as err:
        caffe_io.load_reference_weights(path)
    assert path in str(err.value)
    assert "write_seeded_caffemodel" in str(err.value)


def test_default_weights_path_is_in_checkout():
    """learned_weights.caffemodel in the checkout's root, beside the
    scripts (read in a fresh interpreter: this session patches it)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "from reflectance_filtering.models import "
         "caffe_io; print(caffe_io.DEFAULT_CAFFEMODEL)"],
        cwd=root, capture_output=True, text=True, check=True).stdout
    assert out.strip() == os.path.join(root, "learned_weights.caffemodel")
