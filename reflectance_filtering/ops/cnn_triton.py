"""The flagship reflectance CNN as one fused Pallas kernel (Triton route).

The shipped model (network_definition.prototxt:17-165) is a per-pixel MLP:
3 -> 32 -> 32 -> 32 -> 32 -> 32 (ReLU), skip-concat to 160, 160 -> 1 fuse,
sigmoid.  XLA's form (:func:`models.networks.reflectance_net_apply`)
writes five [B, H, W, 32] float32 skips and reads them back for the
concat: about 1.3 KB of device-memory traffic per pixel for about
9 kflop.  This kernel keeps a block of pixels' activations in registers
from the uint8 BGR input to the sigmoid, so a pixel costs 3 bytes in and
4 bytes out.

Inside a program (BLOCK pixels):
  * uint8 BGR -> [0, 1] RGB -> sRGB-to-linear gamma (the CLI's input
    transform, decompose_with_trained_CNN.py:57-69);
  * conv0 (3 -> 32) as three broadcast multiply-adds (a K=3 dot is below
    the Triton dot's minimum width);
  * conv1..conv4 as [BLOCK, 32] x [32, 32] dots in full float32
    (``precision=HIGHEST`` lowers to IEEE fp32, not TF32);
  * the 160 -> 1 fuse folded into the layer loop as a float32
    multiply-accumulate over each skip (a one-column dot would waste the
    dot unit), then the sigmoid.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.image import srgb_to_rgb_jnp

BLOCK = 256
NUM_WARPS = 4
_HI = jax.lax.Precision.HIGHEST
# Largest |kernel - reference| allowed on the float32 output, against the
# plain forward at Precision.HIGHEST.  IEEE fp32 dots stay far inside it;
# TF32 dots (10-bit mantissa) miss it, while still passing a 1-u8-level
# gate on floor(r * 255), so this is the check that holds the precision.
REFERENCE_ATOL = 1e-5


def _kernel(x_ref, w0_ref, b0_ref, wm_ref, bm_ref, wf_ref, bf_ref, out_ref):
    b = pl.program_id(0)
    px = pl.ds(pl.program_id(1) * BLOCK, BLOCK)

    def linear(c):  # planar BGR uint8 channel c -> linear RGB value
        return srgb_to_rgb_jnp(x_ref[b, c, px].astype(jnp.float32) / 255.0)

    rgb = (linear(2), linear(1), linear(0))
    h = b0_ref[...][None, :]
    for c in range(3):
        h = h + rgb[c][:, None] * w0_ref[c][None, :]
    h = jnp.maximum(h, 0.0)                                # [BLOCK, 32]
    acc = h * wf_ref[0][None, :]
    for i in range(4):
        h = pl.dot(h, wm_ref[i], precision=_HI) + bm_ref[i][None, :]
        h = jnp.maximum(h, 0.0)
        acc = acc + h * wf_ref[i + 1][None, :]
    pre = jnp.sum(acc, axis=1) + bf_ref[0]
    out_ref[b, px] = 1.0 / (1.0 + jnp.exp(-pre))


def kernel_weights(params: Dict) -> Dict[str, jax.Array]:
    """The apply_network params of the flagship model in kernel layout."""
    def kernel(name):
        return jnp.asarray(params[name]["kernel"], jnp.float32)[0, 0]

    def bias(name):
        return jnp.asarray(params[name]["bias"], jnp.float32)

    mids = ["conv{}".format(i) for i in range(1, 5)]
    return {
        "w0": kernel("conv0"),                                   # [3, 32]
        "b0": bias("conv0"),                                     # [32]
        "wm": jnp.stack([kernel(m) for m in mids]),              # [4, 32, 32]
        "bm": jnp.stack([bias(m) for m in mids]),                # [4, 32]
        "wf": kernel("fuse_skip_layers")[:, 0].reshape(5, 32),   # [5, 32]
        "bf": bias("fuse_skip_layers"),                          # [1]
    }


@functools.partial(jax.jit, static_argnames=("interpret",))
def reflectance_cnn_triton(params: Dict, bgr_u8, interpret: bool = False):
    """uint8 BGR planar [B, 3, H, W] -> reflectance intensity [B, H, W]
    float32 in (0, 1).  ``params`` as for ``reflectance_net_apply``."""
    b, c, h, w = bgr_u8.shape
    if c != 3:
        raise ValueError("expected [B, 3, H, W] BGR, got {}".format(
            bgr_u8.shape))
    hw = h * w
    hwp = -(-hw // BLOCK) * BLOCK
    x = bgr_u8.reshape(b, 3, hw)
    if hwp != hw:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, hwp - hw)))
    wts = kernel_weights(params)
    out = pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((b, hwp), jnp.float32),
        grid=(b, hwp // BLOCK),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="reflectance_cnn_triton",
    )(x, wts["w0"], wts["b0"], wts["wm"], wts["bm"], wts["wf"], wts["bf"])
    return out[:, :hw].reshape(b, h, w)
