"""Normalized box filter — the workhorse of the guided filter.

Matches OpenCV ``boxFilter(..., normalize=true)`` semantics: mean over a
(2r+1)x(2r+1) window with border extrapolation (replaces native component
N4's box-filter core, SURVEY.md §2.3).  Called dozens of times per guided
filter, so it must be O(1) per pixel.

Numerics: a *global* cumulative sum in float32 is not acceptable here — for
a 4K image of squared 0-255 guide values the running sum reaches ~1e10,
where float32 ulp is ~1e3; the guided filter then computes variances as
differences of such sums and catastrophically cancels.  Instead each axis
pass uses a *block-local* sliding sum: inclusive/exclusive prefix sums are
computed within blocks of length B >= window, and a window sum crossing at
most one block boundary is assembled as

    sum x[i .. i+w-1] = L[i+w-1] - E[i] + (crosses ? T[block(i)] : 0)

where L/E are inclusive/exclusive local prefixes and T the block totals.
All terms have magnitude <= B * max|x|, so rounding error is bounded by a
few ulps of (B * max|x|) regardless of image size.  Everything lowers to
static slices + elementwise ops — no gathers, which XLA fuses.

Border modes:
  * 'reflect'    = OpenCV BORDER_REFLECT     (edge pixel duplicated:  cba|abc)
  * 'reflect101' = OpenCV BORDER_REFLECT_101 (edge pixel not repeated: dcb|abc)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_PAD_MODE = {"reflect": "symmetric", "reflect101": "reflect"}

_BLOCK = 512  # must be >= any window length used; power of two for layout


def _sliding_sum_axis(xp, w: int, axis: int, n_out: int):
    """Window sums of length-w windows along ``axis`` of padded array xp.

    xp has length n_out + w - 1 along ``axis``; returns length n_out.
    """
    if w == 1:
        return xp
    npad = xp.shape[axis]
    B = _BLOCK
    while B < w:  # block must contain a full window start-to-boundary span
        B *= 2
    nblocks = -(-npad // B)
    total = nblocks * B

    # move target axis last for simple reshapes
    x = jnp.moveaxis(xp, axis, -1)
    tail = [(0, 0)] * (x.ndim - 1) + [(0, total - npad)]
    x = jnp.pad(x, tail)
    xb = x.reshape(x.shape[:-1] + (nblocks, B))

    incl = jnp.cumsum(xb, axis=-1)            # L within block
    excl = incl - xb                          # E within block
    tot = incl[..., -1:]                      # T, shape [..., nblocks, 1]

    L = incl.reshape(x.shape[:-1] + (total,))
    E = excl.reshape(x.shape[:-1] + (total,))
    Tb = jnp.broadcast_to(tot, tot.shape[:-1] + (B,)).reshape(
        x.shape[:-1] + (total,))

    i = np.arange(n_out)
    crosses = ((i % B) + w) > B               # window leaves block(i)?
    crosses = jnp.asarray(crosses, dtype=xp.dtype)

    out = (L[..., w - 1:w - 1 + n_out]
           - E[..., :n_out] + crosses * Tb[..., :n_out])
    return jnp.moveaxis(out, -1, axis)


def box_filter(x, radius: int, border: str = "reflect",
               normalize: bool = True):
    """Box filter over a (2r+1)^2 window on the spatial axes.

    Accepts [H, W], [H, W, C] or [N, H, W, C]; spatial axes are the first
    two for <=3-D input and axes (1, 2) for 4-D input.
    """
    if radius == 0:
        return x
    spatial = (1, 2) if x.ndim == 4 else (0, 1)
    w = 2 * radius + 1
    pad_width = [(0, 0)] * x.ndim
    for ax in spatial:
        pad_width[ax] = (radius, radius)
    xp = jnp.pad(x, pad_width, mode=_PAD_MODE[border])
    s = _sliding_sum_axis(xp, w, spatial[0], x.shape[spatial[0]])
    s = _sliding_sum_axis(s, w, spatial[1], x.shape[spatial[1]])
    if normalize:
        s = s * (1.0 / (w * w))
    return s
