"""Exact joint bilateral filter as one Pallas kernel on the Triton route.

Same OpenCV semantics as :func:`ops.bilateral.joint_bilateral_filter`
(disk of taps, ``exp`` spatial and range weights, BORDER_REFLECT_101,
float32 accumulation).  The plain form is a ``lax.scan`` over the taps
that streams full-image float32 accumulators through device memory on
every tap (about 60 B per pixel per tap, 3,421 taps at sigma_space=22).
Here each program owns a BLOCK_H x BLOCK_W output tile and walks the tap
list with its accumulators in registers; the shifted joint/src tiles it
reads on every tap overlap almost entirely and are served by L1/L2, so
device memory sees each input byte about once.

One kernel covers every channel combination: joint with 1 or 3 channels
(``joint_reps`` multiplies a single joint plane's |delta|, which is what a
gray image replicated to ``joint_reps`` identical channels contributes to
OpenCV's summed-abs range distance) and src with 1 or 3 channels, or no
src at all (self-guided: the joint planes are filtered, read once per
tap).  Borders come from an XLA reflect-101 pad around the kernel.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .bilateral import opencv_bilateral_params

BLOCK_H = 16
BLOCK_W = 64
NUM_WARPS = 4
_LOG2E = 1.0 / math.log(2.0)


def _kernel(*refs, n_joint: int, n_src: int, joint_reps: int,
            n_taps: int, radius: int, coeff: float, self_guided: bool):
    if self_guided:
        dy_ref, dx_ref, sw_ref, joint_ref, out_ref = refs
        src_ref = joint_ref
    else:
        dy_ref, dx_ref, sw_ref, joint_ref, src_ref, out_ref = refs
    n = pl.program_id(0)
    y0 = pl.program_id(1) * BLOCK_H
    x0 = pl.program_id(2) * BLOCK_W

    def tile(ref, c, dy, dx):
        return ref[n, c, pl.ds(y0 + dy, BLOCK_H), pl.ds(x0 + dx, BLOCK_W)]

    centre = [tile(joint_ref, c, radius, radius) for c in range(n_joint)]

    def body(t, carry):
        accs, wsum = carry
        dy = dy_ref[t]
        dx = dx_ref[t]
        joint = [tile(joint_ref, c, dy, dx) for c in range(n_joint)]
        diff = jnp.abs(joint[0] - centre[0])
        for c in range(1, n_joint):
            diff = diff + jnp.abs(joint[c] - centre[c])
        if joint_reps != 1:
            diff = diff * float(joint_reps)
        # exp(x) as exp2(x * log2 e): one special-function op per tap
        wgt = sw_ref[t] * jnp.exp2(diff * diff * coeff)
        src = joint if self_guided else [tile(src_ref, c, dy, dx)
                                         for c in range(n_src)]
        accs = tuple(a + wgt * s for a, s in zip(accs, src))
        return accs, wsum + wgt

    zeros = jnp.zeros((BLOCK_H, BLOCK_W), jnp.float32)
    accs, wsum = jax.lax.fori_loop(
        0, n_taps, body, (tuple(zeros for _ in range(n_src)), zeros))
    inv = 1.0 / wsum
    for c in range(n_src):
        out_ref[n, c, pl.ds(y0, BLOCK_H), pl.ds(x0, BLOCK_W)] = accs[c] * inv


def _pad(x, radius: int, hp: int, wp: int):
    """Reflect-101 border of ``radius``, then zeros up to the tile grid."""
    h, w = x.shape[2:]
    x = jnp.pad(x, ((0, 0), (0, 0), (radius, radius), (radius, radius)),
                mode="reflect")
    return jnp.pad(x, ((0, 0), (0, 0), (0, hp - h), (0, wp - w)))


@functools.partial(jax.jit, static_argnames=(
    "d", "sigma_color", "sigma_space", "joint_reps", "interpret"))
def bilateral_triton(joint, src=None, d: int = -1, sigma_color: float = 20.0,
                     sigma_space: float = 22.0, joint_reps: int = 1,
                     interpret: bool = False):
    """Joint bilateral filter on planar stacks.

    joint: [N, Cj, H, W] (Cj in {1, 3}); src: [N, Cs, H, W] (Cs in {1, 3})
    or None to filter ``joint`` by itself.  Values in the units
    sigma_color refers to (0-255 for the product path).  Returns float32
    [N, Cs, H, W].  ``interpret`` runs the kernel in the Pallas
    interpreter (tests on the CPU)."""
    self_guided = src is None
    joint = jnp.asarray(joint, jnp.float32)
    src = joint if self_guided else jnp.asarray(src, jnp.float32)
    n, n_joint, h, w = joint.shape
    n_src = src.shape[1]
    if n_joint not in (1, 3) or n_src not in (1, 3):
        raise ValueError("joint/src must have 1 or 3 channels, got {}/{}"
                         .format(n_joint, n_src))
    if src.shape[0] != n or src.shape[2:] != (h, w):
        raise ValueError("joint {} and src {} disagree".format(
            joint.shape, src.shape))
    radius, gcc, _, taps = opencv_bilateral_params(d, sigma_color,
                                                   sigma_space)
    hp = -(-h // BLOCK_H) * BLOCK_H
    wp = -(-w // BLOCK_W) * BLOCK_W
    dy = jnp.asarray(taps[:, 0].astype(np.int32) + radius)
    dx = jnp.asarray(taps[:, 1].astype(np.int32) + radius)
    sw = jnp.asarray(taps[:, 2].astype(np.float32))
    operands = [dy, dx, sw, _pad(joint, radius, hp, wp)]
    if not self_guided:
        operands.append(_pad(src, radius, hp, wp))
    kernel = functools.partial(
        _kernel, n_joint=n_joint, n_src=n_src, joint_reps=joint_reps,
        n_taps=len(taps), radius=radius, coeff=gcc * _LOG2E,
        self_guided=self_guided)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, n_src, hp, wp), jnp.float32),
        grid=(n, hp // BLOCK_H, wp // BLOCK_W),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bilateral_triton",
    )(*operands)
    return out[:, :, :h, :w]
