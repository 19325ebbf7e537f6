"""Network factories — all seven reference architectures as pure JAX functions.

Reference: the reference's training/networks.py (create_uNet:304,
create_simpleConvolutionsRelu:510, create_convStatic:556,
create_convStaticWithSigmoid:637, create_convStaticSkipLayers:722,
create_cascadeSkipLayers:853, create_convIncreasing:1149) and the head-width
mapping create_network:95-111 (RS->6 channels, R/S->3, scalar modes->1).

Design notes (not a Caffe translation):
  * Feature maps are NHWC; kernels HWIO; convolutions lower through
    ``lax.conv_general_dilated``. The flagship network is all 1x1 convs,
    which run as per-pixel matmuls with zero halo.
  * Everything is a pure function of (params, images); JAX autodiff replaces
    the reference's hand-derived PythonLayer gradients.
  * Fully convolutional: one traced program per (H, W) shape; arbitrary
    resolutions supported by retracing, like the reference's blob reshape
    (decompose_with_trained_CNN.py:86-87) but compiled.
  * Caffe's xavier filler (uniform with a = sqrt(3/fan_in)) is reproduced for
    training-parity of initialization statistics.

``cascadeSkipLayers`` needs the level-0 reflectance recovery in the middle of
the graph (networks.py:982-994); that recovery is imported from
``.recover`` and fused into the same XLA program.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.backend import use_kernels
from ..utils.image import srgb_to_rgb_jnp
from .recover import recover_reflectance_shading

Params = Dict[str, Any]

# Head width per RS estimation mode (networks.py:95-111).
_SCALAR_MODES = (
    "sAbs", "rAbs",
    "rRelNorm", "rRelMean", "rRelY", "rRelMax",
    "sRelNorm", "sRelMean", "sRelY", "sRelMax",
    "rDirectly",
)

NETWORK_TYPES = (
    "uNet",
    "simpleConvolutionsRelu",
    "convStatic",
    "convIncreasing",
    "convStaticWithSigmoid",
    "convStaticSkipLayers",
    "cascadeSkipLayers",
)


def head_channels(rs_est_mode: str) -> int:
    mode = rs_est_mode.split("-")[0]
    if mode == "RS":
        return 6
    if mode in ("S", "R"):
        return 3
    if mode in _SCALAR_MODES:
        return 1
    raise ValueError("RS-estimation '{}' not known".format(mode))


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Architecture hyperparameters (the network-shaping subset of the
    reference's argparse namespace, train_with_barrista.py:160-258)."""

    network_type: str = "convStaticSkipLayers"
    num_layers: int = 5
    num_filters_log: int = 5           # 2**k filters
    kernel_pad: int = 0                # kernel = 2p+1
    dilation: int = 1
    use_batch_normalization: bool = False
    rs_est_mode: str = "rDirectly"

    @property
    def kernel(self) -> int:
        return 2 * self.kernel_pad + 1

    @property
    def pad(self) -> int:
        return self.kernel_pad + (self.dilation - 1)

    @property
    def num_filters(self) -> int:
        return 2 ** self.num_filters_log

    @property
    def num_output_final(self) -> int:
        return head_channels(self.rs_est_mode)


# Configuration of the shipped trained model (network_definition.prototxt:
# five 1x1x32 convs + 160->1 fuse + sigmoid, rDirectly head).
REFERENCE_CONFIG = NetworkConfig(
    network_type="convStaticSkipLayers",
    num_layers=5,
    num_filters_log=5,
    kernel_pad=0,
    dilation=1,
    use_batch_normalization=False,
    rs_est_mode="rDirectly",
)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def xavier_uniform(key, shape_hwio):
    """Caffe's 'xavier' filler: U(-a, a), a = sqrt(3 / fan_in), fan_in = KhKwCi."""
    kh, kw, ci, _ = shape_hwio
    a = np.sqrt(3.0 / (kh * kw * ci))
    return jax.random.uniform(
        key, shape_hwio, minval=-a, maxval=a, dtype=jnp.float32)


def conv_init(key, kh, kw, ci, co) -> Params:
    return {
        "kernel": xavier_uniform(key, (kh, kw, ci, co)),
        "bias": jnp.zeros((co,), jnp.float32),
    }


# Module-wide matmul/conv precision.  Default HIGHEST (full f32): a
# reduced-precision default (TF32 or bf16 passes) costs ~1e-2 absolute
# error through this stack, far outside the parity gate.  Training from scratch has no
# bitwise-parity contract, so the train CLI can relax it
# (--matmul_precision) for a large step-time win; inference/parity paths
# never touch this.
_PRECISION = {"default": jax.lax.Precision.DEFAULT,
              "high": jax.lax.Precision.HIGH,
              "highest": jax.lax.Precision.HIGHEST}
_matmul_precision = jax.lax.Precision.HIGHEST


@contextlib.contextmanager
def matmul_precision(name: str):
    """Context manager scoping conv2d/deconv2d precision ('default',
    'high', 'highest').  Applies at trace time — wrap the call that
    first executes the jitted function."""
    global _matmul_precision
    prev = _matmul_precision
    _matmul_precision = _PRECISION[name.lower()]
    try:
        yield
    finally:
        _matmul_precision = prev


def conv2d(params: Params, x, *, pad: int = 0, stride: int = 1,
           dilation: int = 1):
    """NHWC conv with HWIO kernel, zero padding — caffe Convolution semantics.

    1x1 convolutions (the flagship family) lower to a per-pixel matmul
    (a plain dot instead of a 1x1 convolution with 3/32 channels)."""
    k = params["kernel"]
    if (k.shape[0] == 1 and k.shape[1] == 1 and stride == 1 and pad == 0):
        sh = x.shape
        y = jnp.dot(x.reshape(-1, sh[-1]), k[0, 0],
                    preferred_element_type=jnp.float32,
                    precision=_matmul_precision)
        return y.reshape(sh[:-1] + (k.shape[3],)) + params["bias"]
    y = jax.lax.conv_general_dilated(
        x, k,
        window_strides=(stride, stride),
        padding=[(pad, pad), (pad, pad)],
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
        precision=_matmul_precision,
    )
    return y + params["bias"]


def deconv2d(params: Params, x, *, stride: int = 2):
    """Caffe Deconvolution (kernel=stride, pad 0) — used by uNet's up path."""
    return jax.lax.conv_transpose(
        x, params["kernel"],
        strides=(stride, stride),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=_matmul_precision,
    ) + params["bias"]


def bn_init(channels: int) -> Params:
    return {
        "mean": jnp.zeros((channels,), jnp.float32),
        "var": jnp.ones((channels,), jnp.float32),
    }


BN_MOMENTUM = 0.999  # caffe moving_average_fraction default


def batch_norm(params: Params, x, *, train: bool, eps: float = 1e-5):
    """Caffe BatchNorm (no learned scale/shift, matching the reference which
    never pairs it with a Scale layer).

    Returns (y, batch_stats); training normalizes with batch statistics and
    the caller folds batch_stats into the running mean/var
    (update_bn_stats) — eval uses the stored running statistics, as caffe's
    TEST phase does."""
    if train:
        mean = jnp.mean(x, axis=(0, 1, 2))
        var = jnp.var(x, axis=(0, 1, 2))
    else:
        mean, var = params["mean"], params["var"]
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    return y, {"mean": mean, "var": var}


def update_bn_stats(params: Params, bn_stats: Dict[str, Any],
                    momentum: float = BN_MOMENTUM) -> Params:
    """EMA-fold a step's batch statistics into the bn* params."""
    out = dict(params)
    for name, stats in bn_stats.items():
        old = out[name]
        out[name] = {
            "mean": momentum * old["mean"] + (1 - momentum) * stats["mean"],
            "var": momentum * old["var"] + (1 - momentum) * stats["var"],
        }
    return out


# ---------------------------------------------------------------------------
# Architecture bodies.  Each init returns a params dict; each apply maps
# (params, images NHWC) -> dict of named blobs ending in 'RS_est'.
# ---------------------------------------------------------------------------

def _init_conv_static_like(key, cfg: NetworkConfig) -> Params:
    """Shared init for convStatic / convStaticWithSigmoid
    (networks.py:556-719).  The head is always a 1x1 conv — both
    reference factories append a kernel-1 head regardless of the trunk
    kernel, and _apply_conv_static applies it with pad 0."""
    params: Params = {}
    k = cfg.kernel
    keys = jax.random.split(key, max(cfg.num_layers, 1) + 1)
    if cfg.num_layers >= 1:
        ci = 3
        for i in range(cfg.num_layers):
            params["conv{}".format(i)] = conv_init(
                keys[i], k, k, ci, cfg.num_filters)
            if cfg.use_batch_normalization:
                params["bn{}".format(i)] = bn_init(cfg.num_filters)
            ci = cfg.num_filters
        head_name = "conv{}".format(cfg.num_layers)
        params[head_name] = conv_init(
            keys[-1], 1, 1, ci, cfg.num_output_final)
    else:
        params["conv0"] = conv_init(keys[-1], k, k, 3, cfg.num_output_final)
    return params


def _apply_conv_static(params, images, cfg: NetworkConfig, *,
                       sigmoid: bool, train: bool):
    blobs: Dict[str, Any] = {"__bn_stats__": {}}
    x = images
    if cfg.num_layers >= 1:
        for i in range(cfg.num_layers):
            x = conv2d(params["conv{}".format(i)], x,
                       pad=cfg.pad, dilation=cfg.dilation)
            if cfg.use_batch_normalization:
                name = "bn{}".format(i)
                x, stats = batch_norm(params[name], x, train=train)
                blobs["__bn_stats__"][name] = stats
            x = jax.nn.relu(x)
        x = conv2d(params["conv{}".format(cfg.num_layers)], x, pad=0)
    else:
        x = conv2d(params["conv0"], x, pad=cfg.pad, dilation=cfg.dilation)
    if sigmoid:
        blobs["RS_est_before_sigmoid"] = x
        x = jax.nn.sigmoid(x)
    blobs["RS_est"] = x
    return blobs


def _init_skip_layers(key, cfg: NetworkConfig, suffix: str = "",
                      in_channels: int = 3) -> Params:
    """convStaticSkipLayers body (networks.py:722-850): numLayers convs, all
    outputs concatenated, fused by a 1x1 conv, sigmoid."""
    params: Params = {}
    k = cfg.kernel
    keys = jax.random.split(key, max(cfg.num_layers, 1) + 1)
    if cfg.num_layers >= 1:
        ci = in_channels
        for i in range(cfg.num_layers):
            params["conv{}{}".format(i, suffix)] = conv_init(
                keys[i], k, k, ci, cfg.num_filters)
            if cfg.use_batch_normalization:
                params["bn{}{}".format(i, suffix)] = bn_init(cfg.num_filters)
            ci = cfg.num_filters
        params["fuse_skip_layers" + suffix] = conv_init(
            keys[-1], 1, 1, cfg.num_filters * cfg.num_layers,
            cfg.num_output_final)
    else:
        params["conv0" + suffix] = conv_init(
            keys[-1], k, k, in_channels, cfg.num_output_final)
    return params


def _apply_skip_layers(params, images, cfg: NetworkConfig, *,
                       suffix: str = "", train: bool):
    blobs: Dict[str, Any] = {"__bn_stats__": {}}
    if cfg.num_layers >= 1:
        x = images
        skips = []
        for i in range(cfg.num_layers):
            x = conv2d(params["conv{}{}".format(i, suffix)], x,
                       pad=cfg.pad, dilation=cfg.dilation)
            if cfg.use_batch_normalization:
                name = "bn{}{}".format(i, suffix)
                x, stats = batch_norm(params[name], x, train=train)
                blobs["__bn_stats__"][name] = stats
            x = jax.nn.relu(x)
            skips.append(x)
        cat = jnp.concatenate(skips, axis=-1)
        blobs["concat_skip_layers" + suffix] = cat
        pre = conv2d(params["fuse_skip_layers" + suffix], cat, pad=0)
    else:
        pre = conv2d(params["conv0" + suffix], images,
                     pad=cfg.pad, dilation=cfg.dilation)
    blobs["RS_est_before_sigmoid" + suffix] = pre
    blobs["RS_est" + suffix] = jax.nn.sigmoid(pre)
    return blobs


def _init_simple_conv_relu(key, cfg: NetworkConfig) -> Params:
    """simpleConvolutionsRelu (networks.py:510-553): 16, [32]*n, 16, head."""
    params: Params = {}
    k = cfg.kernel
    keys = jax.random.split(key, cfg.num_layers + 3)
    params["conv_in"] = conv_init(keys[0], k, k, 3, 16)
    ci = 16
    for i in range(cfg.num_layers):
        params["conv_mid{}".format(i)] = conv_init(keys[1 + i], k, k, ci, 32)
        ci = 32
    params["conv_narrow"] = conv_init(keys[-2], k, k, ci, 16)
    params["conv_head"] = conv_init(keys[-1], k, k, 16, cfg.num_output_final)
    return params


def _apply_simple_conv_relu(params, images, cfg: NetworkConfig):
    p = cfg.kernel_pad
    x = jax.nn.relu(conv2d(params["conv_in"], images, pad=p))
    for i in range(cfg.num_layers):
        x = jax.nn.relu(conv2d(params["conv_mid{}".format(i)], x, pad=p))
    x = jax.nn.relu(conv2d(params["conv_narrow"], x, pad=p))
    x = conv2d(params["conv_head"], x, pad=p)
    return {"RS_est": x}


def _init_conv_increasing(key, cfg: NetworkConfig) -> Params:
    """convIncreasing (networks.py:1149-1223): 2^f, 2^(f+1), ... then 1x1 head."""
    params: Params = {}
    k = cfg.kernel
    keys = jax.random.split(key, max(cfg.num_layers, 1) + 1)
    if cfg.num_layers >= 1:
        ci = 3
        co = cfg.num_filters
        for i in range(cfg.num_layers):
            params["conv{}".format(i)] = conv_init(keys[i], k, k, ci, co)
            ci = co
            co = co * 2
        params["conv_head"] = conv_init(
            keys[-1], 1, 1, ci, cfg.num_output_final)
    else:
        params["conv_head"] = conv_init(
            keys[-1], k, k, 3, cfg.num_output_final)
    return params


def _apply_conv_increasing(params, images, cfg: NetworkConfig):
    p = cfg.kernel_pad
    if cfg.num_layers >= 1:
        x = images
        for i in range(cfg.num_layers):
            x = jax.nn.relu(conv2d(params["conv{}".format(i)], x, pad=p))
        x = conv2d(params["conv_head"], x, pad=0)
    else:
        x = conv2d(params["conv_head"], images, pad=p)
    return {"RS_est": x}


# --- uNet (networks.py:304-507) -------------------------------------------
#
# The reference uNet depends on two PythonLayers ('resize_layer',
# 'broadcast_layer') whose sources are NOT in the reference repo; the
# documented intent (a Narihira-style local/global two-stream U-Net) is
# implemented here: the global path runs on a fixed 256x256 resize of the
# input and its 1x1 spatial output is broadcast over the local feature map.

_UNET_GLOBAL_SIZE = 256


def _init_unet(key, cfg: NetworkConfig) -> Params:
    params: Params = {}
    k = cfg.kernel
    n = cfg.num_layers
    keys = iter(jax.random.split(key, 64))

    def block(name, ci, co, kk, count):
        for i in range(count):
            params["{}_{}".format(name, i)] = conv_init(
                next(keys), kk, kk, ci if i == 0 else co, co)

    # down path
    params["Conv1"] = conv_init(next(keys), 3, 3, 3, 16)
    block("d1", 16, 16, k, n)
    params["Conv2"] = conv_init(next(keys), 3, 3, 16, 32)
    block("d2", 32, 32, k, n)
    params["Conv3"] = conv_init(next(keys), 3, 3, 32, 64)
    block("d3", 64, 64, k, n)
    params["Conv4"] = conv_init(next(keys), 7, 7, 64, 64)
    block("d4", 64, 64, k, n)
    # global path
    params["Conv5"] = conv_init(next(keys), 5, 5, 3, 32)
    params["Conv6"] = conv_init(next(keys), 5, 5, 32, 32)
    params["Conv7"] = conv_init(next(keys), 5, 5, 32, 32)
    params["Conv8"] = conv_init(next(keys), 3, 3, 32, 64)
    # combine local+global
    block("comb", 128, 64, k, n)
    params["comb_final"] = conv_init(next(keys), 3, 3,
                                     128 if n == 0 else 64, 64)
    # up path
    params["up3"] = conv_init(next(keys), 2, 2, 64, 64)
    block("r2", 32 + 64, 32, k, n)
    params["r2_final"] = conv_init(next(keys), 3, 3,
                                   32 + 64 if n == 0 else 32, 32)
    params["up2"] = conv_init(next(keys), 2, 2, 32, 16)
    block("r1", 16 + 16, 16, k, n)
    params["r1_final"] = conv_init(next(keys), 3, 3,
                                   16 + 16 if n == 0 else 16, 16)
    params["up1"] = conv_init(next(keys), 2, 2, 16, 3)
    block("out", 3 + 3, 3, k, n)
    params["head"] = conv_init(next(keys), 3, 3,
                               3 + 3 if n == 0 else 3, cfg.num_output_final)
    return params


def _apply_unet(params, images, cfg: NetworkConfig):
    p = cfg.kernel_pad
    n = cfg.num_layers

    def block(name, x, count):
        for i in range(count):
            x = conv2d(params["{}_{}".format(name, i)],
                       jax.nn.relu(x), pad=p)
        return x

    # down path (stride-2 convs)
    x = conv2d(params["Conv1"], images, pad=1, stride=2)
    x = block("d1", x, n)
    l1 = jax.nn.relu(x)
    x = conv2d(params["Conv2"], l1, pad=1, stride=2)
    x = block("d2", x, n)
    l2 = jax.nn.relu(x)
    x = conv2d(params["Conv3"], l2, pad=1, stride=2)
    x = block("d3", x, n)
    l3 = jax.nn.relu(x)
    x = conv2d(params["Conv4"], l3, pad=3)
    x = block("d4", x, n)
    local = jax.nn.relu(x)

    # global path on a fixed-size resize of the input
    g = jax.image.resize(
        images,
        (images.shape[0], _UNET_GLOBAL_SIZE, _UNET_GLOBAL_SIZE, 3),
        method="linear")
    g = jax.nn.relu(conv2d(params["Conv5"], g, pad=2, stride=4))
    g = jax.nn.relu(conv2d(params["Conv6"], g, pad=2, stride=4))
    g = jax.nn.relu(conv2d(params["Conv7"], g, pad=2, stride=4))
    g = jax.nn.relu(conv2d(params["Conv8"], g, pad=0))
    g = jnp.mean(g, axis=(1, 2), keepdims=True)  # [B,1,1,64]
    g = jnp.broadcast_to(g, local.shape[:3] + (g.shape[-1],))

    x = jnp.concatenate([local, g], axis=-1)
    for i in range(n):
        x = jax.nn.relu(conv2d(params["comb_{}".format(i)], x, pad=p))
    r3 = jax.nn.relu(conv2d(params["comb_final"], x, pad=1))

    x = deconv2d(params["up3"], r3)
    x = jnp.concatenate([l2, x], axis=-1)
    for i in range(n):
        x = jax.nn.relu(conv2d(params["r2_{}".format(i)], x, pad=p))
    r2 = jax.nn.relu(conv2d(params["r2_final"], x, pad=1))

    x = deconv2d(params["up2"], r2)
    x = jnp.concatenate([l1, x], axis=-1)
    for i in range(n):
        x = jax.nn.relu(conv2d(params["r1_{}".format(i)], x, pad=p))
    r1 = jax.nn.relu(conv2d(params["r1_final"], x, pad=1))

    x = deconv2d(params["up1"], r1)
    x = jnp.concatenate([images, x], axis=-1)
    for i in range(n):
        x = jax.nn.relu(conv2d(params["out_{}".format(i)], x, pad=p))
    x = conv2d(params["head"], x, pad=1)
    return {"RS_est": x}


# ---------------------------------------------------------------------------
# Public factory
# ---------------------------------------------------------------------------

def _force_bn_off(cfg: NetworkConfig) -> NetworkConfig:
    """convStatic / convStaticWithSigmoid hardcode batch normalization
    OFF in the reference regardless of --use_batch_normalization
    (networks.py:560, :641); mirror that so these types cannot produce
    an architecture the reference could not.  (The description string
    still encodes the flag, as the reference's does.)"""
    if not cfg.use_batch_normalization:
        return cfg
    import dataclasses
    return dataclasses.replace(cfg, use_batch_normalization=False)


def init_network(key, cfg: NetworkConfig) -> Params:
    t = cfg.network_type
    if t == "convStatic":
        return _init_conv_static_like(key, _force_bn_off(cfg))
    if t == "convStaticWithSigmoid":
        return _init_conv_static_like(key, _force_bn_off(cfg))
    if t == "convStaticSkipLayers":
        return _init_skip_layers(key, cfg)
    if t == "cascadeSkipLayers":
        k0, k1 = jax.random.split(key)
        params = _init_skip_layers(k0, cfg, suffix="_level0")
        params.update(_init_skip_layers(k1, cfg, suffix="_level1",
                                        in_channels=3))
        return params
    if t == "simpleConvolutionsRelu":
        return _init_simple_conv_relu(key, cfg)
    if t == "convIncreasing":
        return _init_conv_increasing(key, cfg)
    if t == "uNet":
        return _init_unet(key, cfg)
    raise ValueError("networkType '{}' not known".format(t))


def apply_network(params: Params, images, cfg: NetworkConfig, *,
                  train: bool = False) -> Dict[str, Any]:
    """Run the trunk: images NHWC float32 -> blob dict with 'RS_est'.

    For cascadeSkipLayers the dict also carries 'RS_est_level0',
    'reflectance_level0' and 'shading_level0' (networks.py:853-1146)."""
    t = cfg.network_type
    if t == "convStatic":
        return _apply_conv_static(params, images, _force_bn_off(cfg),
                                  sigmoid=False, train=train)
    if t == "convStaticWithSigmoid":
        return _apply_conv_static(params, images, _force_bn_off(cfg),
                                  sigmoid=True, train=train)
    if t == "convStaticSkipLayers":
        return _apply_skip_layers(params, images, cfg, train=train)
    if t == "cascadeSkipLayers":
        blobs = _apply_skip_layers(params, images, cfg, suffix="_level0",
                                   train=train)
        # the reference's recover PythonLayer has no 'rDirectly' mode and
        # falls back to rRelMax with a warning
        # (recover_reflectance_shading_layer.py:104-109); reproduce that
        # so the level-1 trunk always receives a 3-channel reflectance
        recover_mode = cfg.rs_est_mode
        if recover_mode.split("-")[0] == "rDirectly":
            recover_mode = "rRelMax"
        refl0, shad0 = recover_reflectance_shading(
            blobs["RS_est_level0"], images, recover_mode)
        blobs["reflectance_level0"] = refl0
        blobs["shading_level0"] = shad0
        bn0 = blobs["__bn_stats__"]
        blobs.update(_apply_skip_layers(params, refl0, cfg, suffix="_level1",
                                        train=train))
        blobs["__bn_stats__"].update(bn0)
        blobs["RS_est"] = blobs.pop("RS_est_level1")
        blobs["RS_est_before_sigmoid"] = blobs.pop(
            "RS_est_before_sigmoid_level1")
        return blobs
    if t == "simpleConvolutionsRelu":
        return _apply_simple_conv_relu(params, images, cfg)
    if t == "convIncreasing":
        return _apply_conv_increasing(params, images, cfg)
    if t == "uNet":
        return _apply_unet(params, images, cfg)
    raise ValueError("networkType '{}' not known".format(t))


def create_network(cfg: NetworkConfig, key: Optional[jax.Array] = None
                   ) -> Tuple[Params, Any]:
    """Build (params, apply_fn) for a config — the analogue of the
    reference's create_network (networks.py:62-154)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    params = init_network(key, cfg)

    def apply_fn(p, images, train=False):
        return apply_network(p, images, cfg, train=train)

    return params, apply_fn


# ---------------------------------------------------------------------------
# The shipped model as a per-pixel MLP: plain reference and product forward
# ---------------------------------------------------------------------------

def reference_params_from_caffe(weights: Dict[str, Dict[str, np.ndarray]]
                                ) -> Params:
    """Arrange converter output (models/caffe_io.py) as apply_network params."""
    params: Params = {}
    for i in range(5):
        params["conv{}".format(i)] = {
            "kernel": jnp.asarray(weights["conv{}".format(i)]["kernel"]),
            "bias": jnp.asarray(weights["conv{}".format(i)]["bias"]),
        }
    params["fuse_skip_layers"] = {
        "kernel": jnp.asarray(weights["fuse_skip_layers"]["kernel"]),
        "bias": jnp.asarray(weights["fuse_skip_layers"]["bias"]),
    }
    return params


def reflectance_net_apply(params: Params, images):
    """The shipped model's forward pass as explicit per-pixel matmuls.

    images: [..., 3] linear RGB float32 (any leading shape — the net is 1x1
    convs, i.e. pointwise).  Returns reflectance intensity [..., 1] in (0,1),
    the 'reflectance_intensity' blob of network_definition.prototxt:158-165.

    Five 3->32->...->32 matmul+ReLU stages, skip-concat to 160 channels,
    160->1 fuse, sigmoid, all at HIGHEST precision.  This is the plain
    reference of the fused kernel (ops/cnn_triton.py) and the CPU path.
    """
    x = images
    skips = []
    hi = jax.lax.Precision.HIGHEST  # full f32, never TF32; parity-critical
    for i in range(5):
        w = params["conv{}".format(i)]["kernel"][0, 0]  # [ci, co]
        b = params["conv{}".format(i)]["bias"]
        x = jax.nn.relu(
            jnp.dot(x, w, preferred_element_type=jnp.float32,
                    precision=hi) + b)
        skips.append(x)
    cat = jnp.concatenate(skips, axis=-1)
    wf = params["fuse_skip_layers"]["kernel"][0, 0]
    bf = params["fuse_skip_layers"]["bias"]
    pre = jnp.dot(cat, wf, preferred_element_type=jnp.float32,
                  precision=hi) + bf
    return jax.nn.sigmoid(pre)


@jax.jit
def _reflectance_from_bgr_u8_reference(params: Params, bgr_u8):
    x = bgr_u8[:, ::-1].astype(jnp.float32) / 255.0          # BGR -> RGB
    lin = srgb_to_rgb_jnp(jnp.moveaxis(x, 1, -1))
    return reflectance_net_apply(params, lin)[..., 0]


def reflectance_from_bgr_u8(params: Params, bgr_u8):
    """The product forward: uint8 BGR planar [B, 3, H, W] (decoded images)
    -> reflectance intensity [B, H, W] float32 in (0, 1).

    The one dispatch point of the flagship CNN: on the GPU the fused
    Triton kernel (ops/cnn_triton.py), on the CPU the plain reference
    (uint8 -> [0, 1] -> sRGB-to-linear -> :func:`reflectance_net_apply`)."""
    if use_kernels():
        from ..ops.cnn_triton import reflectance_cnn_triton
        return reflectance_cnn_triton(params, bgr_u8)
    return _reflectance_from_bgr_u8_reference(params, bgr_u8)
